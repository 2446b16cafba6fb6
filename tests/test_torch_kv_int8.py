"""The port's int8 KV path against the JAX package: quantization, the int8
decode plain versions, and the model's int8 prefill, dense decode and
paged decode (mirrors ``test_kv_int8`` and the int8 cases of
``test_kernels``).

Inputs are made with numpy from a seed and handed to both packages.
Tolerances, each with its reason:
* ``kv_quantize``: codes and scales bit-equal (the same f32 arithmetic,
  round half to even, on the same inputs);
* int8 decode plain versions: 2e-2, as ``test_kernels`` holds bf16 decode
  (outputs round to bf16 after sums taken in another order);
* model logits: prefill 2e-5 (f32 end to end; attention runs on the
  unquantized K/V); decode 1e-3, as the bf16-pool decode of
  ``test_torch_model`` — each side quantizes its own f32 K/V, so a value
  that the two packages' f32 sums put on either side of a rounding edge
  could take codes one step apart (1/127 of the row's largest value); at
  these seeds every code agrees and the logits differ by about 2e-6.
  Greedy tokens must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import tiny_config
from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import (
    decode_attention_quant_pallas, paged_decode_attention_quant_pallas)
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.models import attention as tattn
from repro_torch.models import build_model
from repro_torch.models import transformer as ttr
from repro_torch.models.config import ModelConfig
from test_kernels import DECODE_SHAPES, PAGED_SHAPES
from test_torch_kernels import _paged_tables

torch.set_num_threads(2)

BF16 = dict(rtol=2e-2, atol=2e-2)
CONFIGS = {"tiny": lambda: tiny_config(name="tiny-int8"),
           "qwen2-7b-reduced": lambda: jax_config("qwen2-7b", reduced=True)}
MAX_LEN, BS, N_PROMPT, STEPS = 48, 8, 11, 16


@pytest.fixture
def int8_gate(monkeypatch):
    monkeypatch.setenv("REPRO_KV_INT8", "1")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16_pair(rng, shape, scale=1.0):
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _quantized(j, t):
    """Both packages' quantization of the same values, checked bit-equal;
    returns the JAX (codes, scales) and the port's."""
    jq, js = jattn.kv_quantize(j)
    tq, ts = tattn.kv_quantize(t)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), _np(js))
    return (jq, js), (tq, ts)


# -- quantization ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_kv_quantize_bit_equal_to_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 9, 4, 32)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0           # all-zero row: the 1e-8 scale floor
    x[0, 1, 0, :2] = [127.0, 0.5]   # x / scale lands on .5: half to even
    x[0, 1, 0, 2:4] = [1.5, -2.5]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    (jq, js), (tq, ts) = _quantized(jx, tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(ts.shape) == (3, 9, 4, 1)
    assert int(tq[0, 1, 0, 1]) == 0 and int(tq[0, 1, 0, 0]) == 127
    np.testing.assert_array_equal(
        _np(tattn.kv_dequantize(tq, ts)),
        _np(jattn.kv_dequantize(jq, js)))


def test_int8_gate_matches_jax(monkeypatch):
    cfgs = [tiny_config(), jax_config("qwen2-7b", reduced=True),
            jax_config("rwkv6-1.6b", reduced=True),
            tiny_config(sliding_window=8)]
    for env in ("", "1", "0"):
        monkeypatch.setenv("REPRO_KV_INT8", env)
        for c in cfgs:
            tc = ModelConfig(**dataclasses.asdict(c))
            assert tattn.kv_int8_enabled(tc) == jattn.kv_int8_enabled(c)


# -- int8 decode plain versions against the JAX package ----------------------


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_quant_plain_vs_jax(shape):
    b, s, h, k, d, _ = shape
    rng = np.random.default_rng(sum(shape))
    jq, tq = _bf16_pair(rng, (b, 1, h, d))
    (jk8, jks), (tk8, tks) = _quantized(*_bf16_pair(rng, (b, s, k, d)))
    (jv8, jvs), (tv8, tvs) = _quantized(*_bf16_pair(rng, (b, s, k, d)))
    lens = rng.integers(1, s + 1, (b,)).astype(np.int32)
    got = da.decode_attention_quant(tq, tk8, tv8, tks, tvs,
                                    torch.from_numpy(lens))
    xla = jops.decode_attention_quant(jq, jk8, jv8, jks, jvs,
                                      jnp.asarray(lens), backend="xla")
    np.testing.assert_allclose(_np(got), _np(xla), **BF16)
    deq = jref.decode_reference(jq, jattn.kv_dequantize(jk8, jks),
                                jattn.kv_dequantize(jv8, jvs),
                                jnp.asarray(lens))
    np.testing.assert_allclose(_np(got), _np(deq), **BF16)


@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_decode_quant_plain_vs_jax(shape):
    b, h, k, d, bs, m, n = shape
    rng = np.random.default_rng(sum(shape))
    jq, tq = _bf16_pair(rng, (b, 1, h, d))
    (jk8, jks), (tk8, tks) = _quantized(*_bf16_pair(rng, (n, bs, k, d)))
    (jv8, jvs), (tv8, tvs) = _quantized(*_bf16_pair(rng, (n, bs, k, d)))
    tables, lens = _paged_tables(rng, b, m, n, bs)
    got = da.paged_decode_attention_quant(tq, tk8, tv8, tks, tvs,
                                          torch.from_numpy(tables),
                                          torch.from_numpy(lens))
    xla = jops.paged_decode_attention_quant(
        jq, jk8, jv8, jks, jvs, jnp.asarray(tables), jnp.asarray(lens),
        backend="xla")
    np.testing.assert_allclose(_np(got), _np(xla), **BF16)
    # The paged plain version equals the dense one on the gathered pages.
    dense = da.decode_attention_quant_plain(
        tq, *(da.gather_pages(x, torch.from_numpy(tables))
              for x in (tk8, tv8, tks, tvs)), torch.from_numpy(lens))
    assert torch.equal(got, dense)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_decode_at_twelve_heads_per_kv_head_vs_jax(kind, layout):
    """starcoder2-15b's grouping (48 q / 4 kv heads, G = 12) at a small
    size: the port's bf16 and int8 decode, dense and paged (pages of 16),
    against ``repro.kernels.ops`` (xla path) within 2e-2 (BF16)."""
    b, s, h, n_kv, d, bs = 2, 64, 12, 1, 128, 16
    m = s // bs
    rng = np.random.default_rng(12)
    jq, tq = _bf16_pair(rng, (b, 1, h, d))
    shape = (b, s, n_kv, d) if layout == "dense" else (1 + b * m, bs, n_kv, d)
    jk, tk = _bf16_pair(rng, shape)
    jv, tv = _bf16_pair(rng, shape)
    if layout == "dense":
        lens = np.array([s, 23], np.int32)
    else:
        tables, lens = _paged_tables(rng, b, m, 1 + b * m, bs)
        jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)
    if kind == "int8":
        (jk8, jks), (tk8, tks) = _quantized(jk, tk)
        (jv8, jvs), (tv8, tvs) = _quantized(jv, tv)
        if layout == "dense":
            got = da.decode_attention_quant(tq, tk8, tv8, tks, tvs, tl)
            want = jops.decode_attention_quant(jq, jk8, jv8, jks, jvs, jl,
                                               backend="xla")
        else:
            got = da.paged_decode_attention_quant(tq, tk8, tv8, tks, tvs,
                                                  tt, tl)
            want = jops.paged_decode_attention_quant(
                jq, jk8, jv8, jks, jvs, jt, jl, backend="xla")
    elif layout == "dense":
        got = da.decode_attention(tq, tk, tv, tl)
        want = jops.decode_attention(jq, jk, jv, jl, backend="xla")
    else:
        got = da.paged_decode_attention(tq, tk, tv, tt, tl)
        want = jops.paged_decode_attention(jq, jk, jv, jt, jl,
                                           backend="xla")
    assert tuple(got.shape) == (b, 1, h, d)
    np.testing.assert_allclose(_np(got), _np(want), **BF16)


def test_quant_plain_vs_pallas_interpret():
    """The dense and the paged int8 plain versions against the Pallas
    int8 kernels in interpret mode."""
    rng = np.random.default_rng(21)
    b, s, h, k, d, bs = DECODE_SHAPES[0]
    jq, tq = _bf16_pair(rng, (b, 1, h, d))
    (jk8, jks), (tk8, tks) = _quantized(*_bf16_pair(rng, (b, s, k, d)))
    (jv8, jvs), (tv8, tvs) = _quantized(*_bf16_pair(rng, (b, s, k, d)))
    lens = rng.integers(1, s + 1, (b,)).astype(np.int32)
    pal = decode_attention_quant_pallas(jq, jk8, jv8, jks, jvs,
                                        jnp.asarray(lens), block_s=bs)
    np.testing.assert_allclose(
        _np(da.decode_attention_quant_plain(tq, tk8, tv8, tks, tvs,
                                            torch.from_numpy(lens))),
        _np(pal), **BF16)
    b, h, k, d, bs, m, n = PAGED_SHAPES[0]
    jq, tq = _bf16_pair(rng, (b, 1, h, d))
    (jk8, jks), (tk8, tks) = _quantized(*_bf16_pair(rng, (n, bs, k, d)))
    (jv8, jvs), (tv8, tvs) = _quantized(*_bf16_pair(rng, (n, bs, k, d)))
    tables, lens = _paged_tables(rng, b, m, n, bs)
    pal = paged_decode_attention_quant_pallas(
        jq, jk8, jv8, jks, jvs, jnp.asarray(tables), jnp.asarray(lens))
    np.testing.assert_allclose(
        _np(da.paged_decode_attention_quant_plain(
            tq, tk8, tv8, tks, tvs, torch.from_numpy(tables),
            torch.from_numpy(lens))), _np(pal), **BF16)


# -- the int8 model against the JAX Model -------------------------------------


def _pair(name):
    jcfg = CONFIGS[name]()
    jm = jax_build(jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                jm.init(jax.random.key(3)))
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, tm, bridge.to_torch(jax.device_get(jp))


def _prefill(jm, jp, tm, tp, bucketed):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jm.cfg.vocab_size, N_PROMPT).astype(np.int32)
    length = N_PROMPT if bucketed else None
    tokens = toks[None]
    if bucketed:
        tokens = np.zeros((1, 16), np.int32)
        tokens[0, :N_PROMPT] = toks
    jl, jc = jax.jit(lambda p, t, n: jm.prefill(p, t, max_len=MAX_LEN,
                                                length=n))(
        jp, jnp.asarray(tokens), None if length is None else jnp.int32(length))
    tl, tc = tm.prefill(tp, torch.from_numpy(tokens), max_len=MAX_LEN,
                        length=length)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    assert set(tc) == set(jc) == {"k", "v", "k_scale", "v_scale", "pos"}
    assert tc["k"].dtype == torch.int8 and tc["k_scale"].dtype == \
        torch.bfloat16
    assert not tc["k"][:, :, 16:].any()  # zero past the (bucketed) prompt
    return jl, jc, tl, tc


@pytest.mark.parametrize("bucketed", [False, True], ids=["exact", "length"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_int8_prefill_and_slot_decode_match_jax(int8_gate, name, bucketed):
    jm, jp, tm, tp = _pair(name)
    jl, jc, tl, tc = _prefill(jm, jp, tm, tp, bucketed)
    jpool = jm.merge_slot(jm.init_slot_cache(2, MAX_LEN), jc, jnp.int32(1))
    tpool = tm.merge_slot(tm.init_slot_cache(2, MAX_LEN, "cpu"), tc, 1)
    assert tpool["k"].dtype == torch.int8
    jtok = jnp.zeros((2,), jnp.int32).at[1].set(jm.sample_greedy(jl)[0])
    ttok = torch.zeros(2, dtype=torch.int32)
    ttok[1] = tm.sample_greedy(tl)[0]
    step = jax.jit(jm.decode_step)
    for _ in range(STEPS):
        jl, jpool = step(jp, jtok, jpool)
        tl, tpool = tm.decode_step(tp, ttok, tpool)
        np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl[1]),
                                   rtol=1e-3, atol=1e-3)
        jtok, ttok = jm.sample_greedy(jl), tm.sample_greedy(tl)
        assert int(jtok[1]) == int(ttok[1])
    # Almost every code agrees; the rest sit one step apart.
    diff = np.abs(tpool["k"].numpy().astype(np.int32)
                  - np.asarray(jpool["k"], np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99


@pytest.mark.parametrize("name", list(CONFIGS))
def test_int8_paged_decode_matches_jax(int8_gate, name):
    """Scrambled physical blocks, a write mask over the padding blocks,
    and a free slot whose writes the active mask suppresses — over int8
    code and scale pages."""
    jm, jp, tm, tp = _pair(name)
    jl, jc, tl, tc = _prefill(jm, jp, tm, tp, True)
    n_blocks, m = 9, MAX_LEN // BS
    row = np.array([3, 1, 4, 2, 0, 0], np.int32)
    write = np.arange(m) < 4
    jrow = np.where(write, row, n_blocks).astype(np.int32)
    jpages = jm.append_paged(jm.init_paged_cache(n_blocks, BS), jc,
                             jnp.asarray(jrow))
    tpages = tm.append_paged(tm.init_paged_cache(n_blocks, BS, "cpu"), tc,
                             row, write)
    tables = np.zeros((2, m), np.int32)
    tables[0] = row
    pos = np.array([N_PROMPT, 0], np.int32)
    active = np.array([1, 0], np.int32)
    jtok = jnp.zeros((2,), jnp.int32).at[0].set(jm.sample_greedy(jl)[0])
    ttok = torch.zeros(2, dtype=torch.int32)
    ttok[0] = tm.sample_greedy(tl)[0]
    step = jax.jit(lambda p, t, c, tb, ps, a: jtr.decode_step_paged(
        p, t, c, tb, ps, jm.cfg, active=a))
    for i in range(STEPS):
        p_now = pos + i * active
        jl, jpages = step(jp, jtok, jpages, jnp.asarray(tables),
                          jnp.asarray(p_now), jnp.asarray(active))
        tl, tpages = ttr.decode_step_paged(
            tp, ttok, tpages, torch.from_numpy(tables),
            torch.from_numpy(p_now), tm.cfg, active=torch.from_numpy(active))
        np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl[0]),
                                   rtol=1e-3, atol=1e-3)
        jtok, ttok = jm.sample_greedy(jl), tm.sample_greedy(tl)
        assert int(jtok[0]) == int(ttok[0])
    for key in ("k", "k_scale"):  # the free slot wrote nothing
        assert not tpages[key][:, 0].any()
        assert not bool(jpages[key][:, 0].any())


def test_int8_dense_and_paged_decode_agree(int8_gate):
    """The same int8 entry decoded from a slot pool and from pages gives
    the same logits (the plain versions gather, then run one decode)."""
    jm, jp, tm, tp = _pair("tiny")
    _, _, tl, tc = _prefill(jm, jp, tm, tp, True)
    row = np.array([2, 5, 1, 3, 4, 6], np.int32)
    pages = tm.append_paged(tm.init_paged_cache(7, BS, "cpu"), tc, row,
                            np.ones(6, bool))
    back = tm.gather_pages(pages, row, int(tc["pos"]))
    for key in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(back[key], tc[key])
    pool = tm.merge_slot(tm.init_slot_cache(1, MAX_LEN, "cpu"), tc, 0)
    assert torch.equal(tm.gather_slot(pool, 0)["v_scale"], tc["v_scale"])
    tok = tm.sample_greedy(tl)
    dense, _ = tm.decode_step(tp, tok, pool)
    paged, _ = tm.decode_step_paged(tp, tok, pages,
                                    torch.from_numpy(row[None]),
                                    torch.tensor([N_PROMPT], dtype=torch.int32))
    assert torch.equal(dense, paged)


# -- pools refuse entries of another layout ------------------------------------


def test_merge_slot_refuses_other_dtype_or_leaves(monkeypatch):
    tm = build_model(ModelConfig(**dataclasses.asdict(tiny_config())))
    tp = tm.init(torch.Generator().manual_seed(0))
    tokens = torch.arange(5, dtype=torch.int32)[None]
    _, bf16_entry = tm.prefill(tp, tokens, max_len=16, kv_int8=False)
    _, int8_entry = tm.prefill(tp, tokens, max_len=16, kv_int8=True)
    int8_pool = tm.init_slot_cache(2, 16, "cpu", kv_int8=True)
    with pytest.raises(ValueError, match="leaves"):  # no scale leaves
        tm.merge_slot(int8_pool, bf16_entry, 0)
    bad = dict(int8_entry, k=int8_entry["k"].to(torch.bfloat16))
    with pytest.raises(TypeError, match="'k'"):  # bf16 into int8 codes
        tm.merge_slot(int8_pool, bad, 0)
    assert not int8_pool["k"].any()  # nothing was written
    with pytest.raises(ValueError, match="leaves"):
        tm.merge_slot(tm.init_slot_cache(2, 16, "cpu"), int8_entry, 0)
    tm.merge_slot(int8_pool, int8_entry, 1)
    assert torch.equal(int8_pool["k"][:, 1], int8_entry["k"][:, 0])


def test_append_paged_refuses_other_dtype_or_leaves():
    tm = build_model(ModelConfig(**dataclasses.asdict(tiny_config())))
    tp = tm.init(torch.Generator().manual_seed(0))
    tokens = torch.arange(5, dtype=torch.int32)[None]
    _, bf16_entry = tm.prefill(tp, tokens, max_len=16, kv_int8=False)
    _, int8_entry = tm.prefill(tp, tokens, max_len=16, kv_int8=True)
    row, write = np.array([1, 2], np.int32), np.ones(2, bool)
    int8_pages = tm.init_paged_cache(3, BS, "cpu", kv_int8=True)
    with pytest.raises(ValueError, match="leaves"):
        tm.append_paged(int8_pages, bf16_entry, row, write)
    bad = dict(int8_entry, v_scale=int8_entry["v_scale"].float())
    with pytest.raises(TypeError, match="'v_scale'"):
        tm.append_paged(int8_pages, bad, row, write)
    with pytest.raises(ValueError, match="leaves"):
        tm.append_paged(tm.init_paged_cache(3, BS, "cpu"), int8_entry, row,
                        write)
    tm.append_paged(int8_pages, int8_entry, row, write)
    assert torch.equal(int8_pages["k"][:, 1], int8_entry["k"][:, 0, :BS])


# -- byte accounting ------------------------------------------------------------


def test_int8_byte_accounting_matches_jax(int8_gate):
    for name in ("qwen2-7b",):
        jm = jax_build(jax_config(name))
        tm = build_model(get_config(name))
        assert tm.dense_kv_bytes(8, 1024) == jm.dense_kv_bytes(8, 1024) \
            == 238_551_044
        assert tm.kv_block_bytes(16) == jm.kv_block_bytes(16) == 465_920
        assert tm.dense_kv_bytes(8, 1024, kv_int8=False) == 469_762_052
        assert tm.kv_block_bytes(16, kv_int8=False) == 917_504
    jm, _, tm, _ = _pair("qwen2-7b-reduced")
    assert tm.kv_block_bytes(8) == jm.kv_block_bytes(8)
    assert tm.dense_kv_bytes(3, 40) == jm.dense_kv_bytes(3, 40)

"""The port's ``Model`` against the JAX ``Model`` on the same weights and
tokens: prefill, dense-slot decode and paged decode.

Both sides run f32 params (the JAX tree cast to f32, bridged), so the
algorithm is compared, not bf16 rounding.  Tolerances:
* prefill logits 2e-5 — f32 end to end, sums in a different order;
* decode logits 1e-3 over 16 steps — slot and page pools are bf16
  (model.py:223-227), and a K/V row whose f32 value differs by an ulp can
  round to neighbouring bf16 values;
* bf16 params: prefill logits 2e-2 (bf16 products round differently in
  XLA and PyTorch).
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
from repro.models import build_model as jax_build
from repro.models import transformer as jtr
from repro_torch import bridge
from repro_torch.models import build_model
from repro_torch.models import transformer as ttr
from repro_torch.models.config import ModelConfig

torch.set_num_threads(2)

CONFIGS = {"tiny": lambda: tiny_config(),
           "qwen2-7b-reduced": lambda: jax_config("qwen2-7b", reduced=True)}
MAX_LEN, BS, N_PROMPT, STEPS = 48, 8, 11, 16


def _pair(name, dtype=jnp.float32):
    jcfg = CONFIGS[name]()
    jm = jax_build(jcfg)
    jp = jax.tree_util.tree_map(lambda a: a.astype(dtype),
                                jm.init(jax.random.key(3)))
    tm = build_model(ModelConfig(**dataclasses.asdict(jcfg)))
    return jm, jp, tm, bridge.to_torch(jax.device_get(jp))


def _prompt(vocab, bucketed):
    rng = np.random.default_rng(1)
    toks = rng.integers(0, vocab, N_PROMPT).astype(np.int32)
    if not bucketed:
        return toks[None], None
    padded = np.zeros((1, 16), np.int32)
    padded[0, :N_PROMPT] = toks
    return padded, N_PROMPT


def _prefill(jm, jp, tm, tp, tokens, length):
    if length is None:
        jl, jc = jax.jit(lambda p, t: jm.prefill(p, t, max_len=MAX_LEN))(
            jp, jnp.asarray(tokens))
    else:
        jl, jc = jax.jit(lambda p, t, n: jm.prefill(
            p, t, max_len=MAX_LEN, length=n))(jp, jnp.asarray(tokens),
                                             jnp.int32(length))
    tl, tc = tm.prefill(tp, torch.from_numpy(tokens), max_len=MAX_LEN,
                        length=length)
    return jl, jc, tl, tc


@pytest.mark.parametrize("bucketed", [False, True], ids=["exact", "length"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_slot_decode_match_jax(name, bucketed):
    jm, jp, tm, tp = _pair(name)
    tokens, length = _prompt(jm.cfg.vocab_size, bucketed)
    jl, jc, tl, tc = _prefill(jm, jp, tm, tp, tokens, length)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5,
                               atol=2e-5)
    assert int(tc["pos"]) == int(jc["pos"]) == N_PROMPT
    # Slot 1 of a two-slot bf16 pool; slot 0 stays free.
    jpool = jm.merge_slot(jm.init_slot_cache(2, MAX_LEN), jc, jnp.int32(1))
    tpool = tm.merge_slot(tm.init_slot_cache(2, MAX_LEN, "cpu"), tc, 1)
    jtok = jnp.zeros((2,), jnp.int32).at[1].set(jm.sample_greedy(jl)[0])
    ttok = torch.zeros(2, dtype=torch.int32)
    ttok[1] = tm.sample_greedy(tl)[0]
    step = jax.jit(jm.decode_step)
    for _ in range(STEPS):
        jl, jpool = step(jp, jtok, jpool)
        tl, tpool = tm.decode_step(tp, ttok, tpool)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-3,
                                   atol=1e-3)
        jtok, ttok = jm.sample_greedy(jl), tm.sample_greedy(tl)
        assert np.asarray(jtok).tolist() == ttok.tolist()
    np.testing.assert_array_equal(tpool["pos"].numpy(),
                                  np.asarray(jpool["pos"]))


@pytest.mark.parametrize("bucketed", [False, True], ids=["exact", "length"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_paged_decode_matches_jax(name, bucketed):
    """Scrambled physical blocks, padding blocks kept out of the pool by
    the write mask (JAX: drop sentinel), and a free slot whose writes the
    active mask suppresses."""
    jm, jp, tm, tp = _pair(name)
    tokens, length = _prompt(jm.cfg.vocab_size, bucketed)
    jl, jc, tl, tc = _prefill(jm, jp, tm, tp, tokens, length)
    n_blocks, m = 9, MAX_LEN // BS
    row = np.array([3, 1, 4, 2, 0, 0], np.int32)  # 4 blocks hold 27 rows
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
    # The free slot wrote nothing: the null page stays zero on both sides.
    assert not tpages["k"][:, 0].any() and not bool(jpages["k"][:, 0].any())
    np.testing.assert_allclose(tpages["k"].float().numpy(),
                               np.asarray(jpages["k"], np.float32),
                               rtol=1e-2, atol=1e-2)


def test_fused_paged_round_advances_active_positions():
    jm, jp, tm, tp = _pair("tiny")
    tpages = tm.init_paged_cache(5, BS, "cpu")
    tables = torch.zeros((2, 2), dtype=torch.int32)
    tables[0] = torch.tensor([1, 2])
    tok, _, new_pos = tm.decode_step_paged_tokens(
        tp, torch.tensor([3, 0], dtype=torch.int32), tpages, tables,
        torch.tensor([5, 0], dtype=torch.int32),
        torch.tensor([1, 0], dtype=torch.int32))
    assert new_pos.tolist() == [6, 0] and tok.dtype == torch.int32
    assert 0 <= int(tok.max()) < tm.cfg.vocab_size


def test_append_gather_pages_roundtrip():
    jm, jp, tm, tp = _pair("tiny")
    tokens, _ = _prompt(jm.cfg.vocab_size, False)
    _, tc = tm.prefill(tp, torch.from_numpy(tokens), max_len=MAX_LEN)
    row = np.array([5, 2, 7, 1, 3, 4], np.int32)
    pages = tm.append_paged(tm.init_paged_cache(9, BS, "cpu"), tc, row,
                            np.ones(6, bool))
    back = tm.gather_pages(pages, row, int(tc["pos"]))
    torch.testing.assert_close(back["k"], tc["k"].to(torch.bfloat16),
                               rtol=0, atol=0)
    assert int(back["pos"]) == N_PROMPT
    slot = tm.gather_slot(tm.merge_slot(tm.init_slot_cache(3, MAX_LEN,
                                                           "cpu"), tc, 2), 2)
    torch.testing.assert_close(slot["v"], tc["v"].to(torch.bfloat16),
                               rtol=0, atol=0)


def test_bf16_prefill_matches_jax():
    jm, jp, tm, tp = _pair("qwen2-7b-reduced", jnp.bfloat16)
    tokens, _ = _prompt(jm.cfg.vocab_size, False)
    jl, _, tl, _ = _prefill(jm, jp, tm, tp, tokens, None)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2,
                               atol=2e-2)


def test_kv_byte_accounting_matches_jax():
    jm, _, tm, _ = _pair("qwen2-7b-reduced")
    assert tm.kv_block_bytes(16) == jm.kv_block_bytes(16)
    assert tm.dense_kv_bytes(4, 64) == jm.dense_kv_bytes(4, 64)
    assert tm.n_params() == jm.n_params()

"""The port's attention kernels: plain PyTorch versions against the JAX
package's ``ops`` (xla path), its naive ``ref`` oracles and its Pallas
kernels (interpret mode, as ``test_kernels.py`` runs them).  The CUDA
kernels are held against these plain versions in ``test_torch_gpu.py``.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are those of ``test_kernels.py``: 2e-5 in f32 (the two
packages sum in different orders) and 2e-2 in bf16 (outputs round to
bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import (decode_attention_pallas,
                                            paged_decode_attention_pallas)
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from test_kernels import DECODE_SHAPES, FLASH_SHAPES, PAGED_SHAPES

torch.set_num_threads(2)  # six test workers share the host's cores

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bf16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(rng, shape, name):
    """The same seeded values in both frameworks (bf16 rounds identically
    from the same f32 numbers)."""
    x = rng.normal(size=shape).astype(np.float32)
    jd, td = DTYPES[name]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _paged_tables(rng, b, m, n, bs):
    """Disjoint per-sequence block lists + ragged lengths, null-padded
    (the layout of ``test_kernels._paged_tables``)."""
    perm = rng.permutation(np.arange(1, n))
    tables = np.zeros((b, m), np.int32)
    cache_len = np.zeros((b,), np.int32)
    take = 0
    for i in range(b):
        used = int(rng.integers(1, m + 1))
        tables[i, :used] = perm[take:take + used]
        take += used
        cache_len[i] = rng.integers(max((used - 1) * bs, 1), used * bs + 1)
    return tables, cache_len


# -- plain versions against the JAX package (CPU) ---------------------------


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_vs_jax(shape, dtype):
    b, sq, sk, h, k, d, bq, bk = shape
    rng = np.random.default_rng(sum(shape))
    jq, tq = _pair(rng, (b, sq, h, d), dtype)
    jk, tk = _pair(rng, (b, sk, k, d), dtype)
    jv, tv = _pair(rng, (b, sk, k, d), dtype)
    for causal, window in [(True, None), (True, 9), (False, None)]:
        got = fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                       window=window, block_q=bq,
                                       block_k=bk)
        xla = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                   block_q=bq, block_k=bk, backend="xla")
        np.testing.assert_allclose(_np(got), _np(xla), **_tol(dtype))
        np.testing.assert_allclose(
            _np(got), _np(jref.mha_reference(jq, jk, jv, causal=causal,
                                             window=window)), **_tol(dtype))
        # The wrapper takes the plain version on a CPU tensor.
        np.testing.assert_array_equal(
            _np(fa.flash_attention(tq, tk, tv, causal=causal,
                                   window=window)),
            _np(fa.flash_attention_plain(tq, tk, tv, causal=causal,
                                         window=window)))


def test_flash_plain_ragged_and_offset():
    """Ragged Sq (a bucketed prefill hands the kernel Sq = 1, 2, 4, ...)
    and q_offset against the port's own naive oracle and JAX's."""
    rng = np.random.default_rng(5)
    for sq, sk, off in [(1, 1, 0), (5, 5, 0), (13, 29, 16)]:
        jq, tq = _pair(rng, (2, sq, 4, 16), "f32")
        jk, tk = _pair(rng, (2, sk, 2, 16), "f32")
        jv, tv = _pair(rng, (2, sk, 2, 16), "f32")
        got = fa.flash_attention_plain(tq, tk, tv, q_offset=off, block_q=8,
                                       block_k=8)
        np.testing.assert_allclose(
            _np(got), _np(tref.mha_reference(tq, tk, tv, q_offset=off)),
            **_tol("f32"))
        np.testing.assert_allclose(
            _np(got), _np(jref.mha_reference(jq, jk, jv, q_offset=off)),
            **_tol("f32"))


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_plain_vs_jax(shape, dtype):
    b, s, h, k, d, _ = shape
    rng = np.random.default_rng(sum(shape))
    jq, tq = _pair(rng, (b, 1, h, d), dtype)
    jk, tk = _pair(rng, (b, s, k, d), dtype)
    jv, tv = _pair(rng, (b, s, k, d), dtype)
    lens = rng.integers(1, s + 1, (b,)).astype(np.int32)
    for window in (None, 17):
        got = da.decode_attention(tq, tk, tv, torch.from_numpy(lens),
                                  window=window)
        xla = jops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                    window=window, backend="xla")
        np.testing.assert_allclose(_np(got), _np(xla), **_tol(dtype))
        np.testing.assert_allclose(
            _np(got), _np(tref.decode_reference(tq, tk, tv,
                                                torch.from_numpy(lens),
                                                window=window)),
            **_tol(dtype))


@pytest.mark.parametrize("shape", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_decode_plain_vs_jax(shape, dtype):
    b, h, k, d, bs, m, n = shape
    rng = np.random.default_rng(sum(shape))
    jq, tq = _pair(rng, (b, 1, h, d), dtype)
    jkp, tkp = _pair(rng, (n, bs, k, d), dtype)
    jvp, tvp = _pair(rng, (n, bs, k, d), dtype)
    tables, lens = _paged_tables(rng, b, m, n, bs)
    got = da.paged_decode_attention(tq, tkp, tvp, torch.from_numpy(tables),
                                    torch.from_numpy(lens))
    xla = jops.paged_decode_attention(jq, jkp, jvp, jnp.asarray(tables),
                                      jnp.asarray(lens), backend="xla")
    np.testing.assert_allclose(_np(got), _np(xla), **_tol(dtype))
    gathered = jref.decode_reference(
        jq, jops._gather_pages(jkp, jnp.asarray(tables)),
        jops._gather_pages(jvp, jnp.asarray(tables)), jnp.asarray(lens))
    np.testing.assert_allclose(_np(got), _np(gathered), **_tol(dtype))


# -- plain versions against the Pallas kernels (interpret mode) --------------


def test_flash_plain_vs_pallas_interpret():
    b, sq, sk, h, k, d, bq, bk = FLASH_SHAPES[1]
    rng = np.random.default_rng(7)
    jq, tq = _pair(rng, (b, sq, h, d), "f32")
    jk, tk = _pair(rng, (b, sk, k, d), "f32")
    jv, tv = _pair(rng, (b, sk, k, d), "f32")
    pal = flash_attention_pallas(jq, jk, jv, causal=True, block_q=bq,
                                 block_k=bk)
    np.testing.assert_allclose(
        _np(fa.flash_attention_plain(tq, tk, tv, causal=True)), _np(pal),
        **_tol("f32"))


def test_decode_plain_vs_pallas_interpret():
    b, s, h, k, d, bs = DECODE_SHAPES[0]
    rng = np.random.default_rng(8)
    jq, tq = _pair(rng, (b, 1, h, d), "f32")
    jk, tk = _pair(rng, (b, s, k, d), "f32")
    jv, tv = _pair(rng, (b, s, k, d), "f32")
    lens = rng.integers(1, s + 1, (b,)).astype(np.int32)
    pal = decode_attention_pallas(jq, jk, jv, jnp.asarray(lens), block_s=bs)
    np.testing.assert_allclose(
        _np(da.decode_attention_plain(tq, tk, tv, torch.from_numpy(lens))),
        _np(pal), **_tol("f32"))


def test_paged_decode_plain_vs_pallas_interpret():
    b, h, k, d, bs, m, n = PAGED_SHAPES[0]
    rng = np.random.default_rng(9)
    jq, tq = _pair(rng, (b, 1, h, d), "f32")
    jkp, tkp = _pair(rng, (n, bs, k, d), "f32")
    jvp, tvp = _pair(rng, (n, bs, k, d), "f32")
    tables, lens = _paged_tables(rng, b, m, n, bs)
    pal = paged_decode_attention_pallas(jq, jkp, jvp, jnp.asarray(tables),
                                        jnp.asarray(lens))
    np.testing.assert_allclose(
        _np(da.paged_decode_attention_plain(tq, tkp, tvp,
                                            torch.from_numpy(tables),
                                            torch.from_numpy(lens))),
        _np(pal), **_tol("f32"))


def test_wrappers_count_no_launch_on_cpu():
    """On the CPU the wrappers take the plain versions and launch
    nothing; a tensor on another device type is refused."""
    from repro_torch import kernels
    from repro_torch.kernels import ssm_scan, wkv6
    kernels.reset_launch_counts()
    q = torch.zeros((1, 1, 2, 8))
    kv = torch.zeros((1, 4, 1, 8))
    one = torch.ones(1, dtype=torch.int32)
    da.decode_attention(q, kv, kv, one)
    codes, scales = kv.to(torch.int8), torch.ones((1, 4, 1, 1))
    da.decode_attention_quant(q, codes, codes, scales, scales, one)
    da.paged_decode_attention_quant(q, codes, codes, scales, scales,
                                    torch.zeros((1, 1), dtype=torch.int32),
                                    one)
    for s in (3, wkv6.CHUNKED_MIN_S):  # the step and the chunked shapes
        xs = torch.zeros((1, s, 2, 8))
        wkv6.wkv6_scan(xs, xs, xs, xs, torch.zeros((2, 8)),
                       torch.zeros((1, 2, 8, 8)))
    for s in (3, ssm_scan.CHUNKED_MIN_S):  # the step and the chunked shapes
        xs = torch.zeros((1, s, 2, 8))
        ssm_scan.ssm_scan(xs, xs[..., 0], torch.zeros((2, 4)), xs[..., :4],
                          xs[..., :4], torch.zeros((1, 2, 8, 4)))
    assert kernels.launch_counts() == {
        "flash_attention": 0, "decode_attention": 0,
        "paged_decode_attention": 0, "decode_attention_quant": 0,
        "paged_decode_attention_quant": 0, "wkv6_step": 0,
        "wkv6_chunked": 0, "ssm_step": 0, "ssm_chunked": 0}
    assert wkv6.wkv6_scan.launches == 0 and ssm_scan.ssm_scan.launches == 0
    with pytest.raises(ValueError):
        fa.flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))


def test_every_c_entry_point_has_a_signature():
    """Each ``extern "C"`` entry point in ``csrc`` has its ctypes
    signature in ``build.SIGNATURES``: without one, ctypes passes each
    pointer and the stream as a 32-bit int."""
    import re
    from repro_torch.kernels import build
    names = set()
    for src in build.CSRC.glob("*.cu"):
        names |= set(re.findall(r'extern "C" int (\w+)\(', src.read_text()))
    assert names == set(build.SIGNATURES)

"""The shapes the port's prefill and decode kernels are handed, held on
the CPU: the plain flash version against the JAX package's
``ops.flash_attention`` (xla path) at every prefill bucket length, at
hymba's exact lengths (prompt + 128 meta tokens, window 1024) and at a
``q_offset`` chunk; and the decode wrappers' host-side planning (tiles,
splits and scratch) that the dense and paged kernels share, bf16 and
int8 alike.

Inputs are made with numpy from a seed and handed to both packages, in
f32 at small widths; tolerance 2e-5 (the two packages sum in different
orders).  On the card the kernels are held against these plain versions
within 2e-2 (``test_torch_gpu.py``): they round the softmax weights to
bf16 for P . V and sum in mma order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa

torch.set_num_threads(2)  # six test workers share the host's cores

TOL = dict(rtol=2e-5, atol=2e-5)
BUCKETS = [2 ** i for i in range(10)]  # bucketed prefill: 1, 2, ..., 512


def _pair(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _check(sq, sk, *, causal=True, window=None, q_offset=0, h=4, kv=2,
           d=16, seed=0):
    rng = np.random.default_rng(seed)
    jq, tq = _pair(rng, (1, sq, h, d))
    jk, tk = _pair(rng, (1, sk, kv, d))
    jv, tv = _pair(rng, (1, sk, kv, d))
    got = fa.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                   q_offset=q_offset)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                q_offset=q_offset, backend="xla")
    assert got.shape == (1, sq, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("sq", BUCKETS)
def test_flash_plain_vs_jax_at_bucket_lengths(sq):
    _check(sq, sq, seed=sq)


@pytest.mark.parametrize("sq,window", [
    (129, 1024), (200, 1024), (640, 1024),  # inside the window
    (1152, 1024),                            # the window cuts k blocks
    (200, 64)])                              # a narrow window, many cuts
def test_flash_plain_vs_jax_at_hybrid_lengths(sq, window):
    """hymba-1.5b prefills at exact lengths Sq = prompt + 128 meta
    tokens with a sliding window (25 / 5 heads there; 5 / 1 here)."""
    _check(sq, sq, window=window, h=5, kv=1, seed=sq + window)


@pytest.mark.parametrize("sq,sk,q_offset,causal", [
    (20, 84, 64, True),    # a chunk at the tail of a longer cache
    (40, 70, 0, False)])   # non-causal, Sk not a multiple of 16
def test_flash_plain_vs_jax_offset_and_ragged(sq, sk, q_offset, causal):
    _check(sq, sk, causal=causal, q_offset=q_offset, seed=sq + sk)


# -- host-side planning of the decode kernels (tiles, splits, scratch) -------


@pytest.mark.parametrize("bs", [1, 8, 16, 32, 64])
def test_bf16_dense_and_paged_plan_alike(bs):
    """The bf16 kernels walk tiles of DENSE_TILE logical rows whatever the
    page size, so a paged cache of M * bs = S rows gets the dense
    cache's split (``cluster_plan``): the condition of their bit-identity
    on the card.  The splits cover the tiles, are at most one cluster, and
    no more than about ``CLUSTER_CTAS`` CTAs need."""
    for b, n_kv, s in [(8, 4, 1024), (1, 4, 512), (3, 5, 1024),
                       (16, 4, 64), (2, 1, 4096)]:
        m = s // bs
        dense = torch.empty(b, s, n_kv, 128, dtype=torch.bfloat16,
                            device="meta")
        pages = torch.empty(1 + b * m, bs, n_kv, 128, dtype=torch.bfloat16,
                            device="meta")
        tables = torch.empty(b, m, dtype=torch.int32, device="meta")
        plan = da.decode_plan(dense)
        assert da.decode_plan(pages, tables) == plan
        assert plan == da.cluster_plan(b, n_kv, da.row_tiles(m * bs))
        per, n_split = plan
        n_tiles = da.row_tiles(s)
        assert per * (n_split - 1) < n_tiles <= per * n_split
        assert n_split <= min(n_tiles, da.MAX_CLUSTER)
        assert n_split <= max(1, -(-da.CLUSTER_CTAS // (b * n_kv)))


def test_decode_plan_and_scratch_at_the_main_shape():
    """qwen2-7b's decode round (B=8, S=1024, 4 kv heads of 128): 64
    tiles of 16 rows, 8 a CTA, 8 splits: 256 CTAs, bf16 and int8 alike;
    a single sequence in one full cluster of 16 splits of 4 tiles.  No
    launch takes scratch: every decode entry point's pointers are its
    operands and its output (the splits merge in their cluster)."""
    assert da.DENSE_TILE == 16 and da.MAX_GROUP == 16
    assert da.row_tiles(1024) == 64
    assert da.cluster_plan(8, 4, 64) == (8, 8)
    for dtype in (torch.bfloat16, torch.int8):
        cache = torch.empty(8, 1024, 4, 128, dtype=dtype, device="meta")
        assert da.decode_plan(cache) == (8, 8)
        one = torch.empty(1, 1024, 4, 128, dtype=dtype, device="meta")
        assert da.decode_plan(one) == (4, 16)
    pointers = {name: sum(t.__name__ == "c_void_p" for t in args) - 1
                for name, args in build.SIGNATURES.items()
                if "decode" in name}  # less the stream
    assert pointers == {"repro_decode_attention_bf16": 5,
                        "repro_paged_decode_attention_bf16": 6,
                        "repro_decode_attention_q8": 7,
                        "repro_paged_decode_attention_q8": 8}
    assert not hasattr(da, "scratch_shapes")


@pytest.mark.parametrize("bs", [8, 16, 32, 64])
def test_int8_paged_plan_equals_dense(bs):
    """The int8 wrappers plan as the bf16 ones: tiles of DENSE_TILE
    logical rows, so int8 pages of any size get the dense cache's split
    (the condition of their bit-identity on the card), at the main shape
    and at a single sequence in one full cluster."""
    for b, n_kv, s, d in [(8, 4, 1024, 128), (1, 4, 1024, 128),
                          (2, 1, 64, 128), (3, 5, 512, 64)]:
        m = s // bs
        codes = torch.zeros((b, s, n_kv, d), dtype=torch.int8)
        pages = torch.zeros((1 + b * m, bs, n_kv, d), dtype=torch.int8)
        tables = torch.zeros((b, m), dtype=torch.int32)
        assert da.decode_plan(pages, tables) == da.decode_plan(codes)
        assert da.decode_plan(codes) == da.cluster_plan(b, n_kv,
                                                        da.row_tiles(s))
    assert da.decode_plan(torch.zeros((8 * 16, bs, 4, 128), dtype=torch.int8),
                          torch.zeros((8, 1024 // bs), dtype=torch.int32)
                          ) == (8, 8)


@pytest.mark.parametrize("bs", [8, 16, 32])
def test_paged_wrapper_equals_dense_on_gathered_cache(bs):
    """On the CPU both wrappers take their plain versions: the paged one
    equals the dense one on the same rows gathered in logical order (the
    invariant the kernels keep bit for bit on the card)."""
    rng = np.random.default_rng(bs)
    b, h, kv, d, s = 3, 8, 2, 16, 64
    m = s // bs
    q = torch.from_numpy(rng.normal(size=(b, 1, h, d)).astype(np.float32))
    kc = torch.from_numpy(rng.normal(size=(b, s, kv, d)).astype(np.float32))
    vc = torch.from_numpy(rng.normal(size=(b, s, kv, d)).astype(np.float32))
    lens = torch.tensor([1, 37, 64], dtype=torch.int32)
    perm = rng.permutation(np.arange(1, 1 + b * m))
    tables = torch.from_numpy(perm.reshape(b, m).astype(np.int32))
    kp = torch.zeros((1 + b * m, bs, kv, d))
    vp = torch.zeros_like(kp)
    kp[tables.reshape(-1).long()] = kc.reshape(b * m, bs, kv, d)
    vp[tables.reshape(-1).long()] = vc.reshape(b * m, bs, kv, d)
    paged = da.paged_decode_attention(q, kp, vp, tables, lens)
    dense = da.decode_attention(q, kc, vc, lens)
    assert torch.equal(paged, dense)

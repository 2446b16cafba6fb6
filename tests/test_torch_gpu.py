"""The port's CUDA kernels against their plain PyTorch versions, the
engine's decode round and bucketed admissions as CUDA graphs against
their eager references, copy-on-write, migration and close under
those graphs, the fleet model store's upload and the frontend's
node failure, the sampled and speculative rounds under the graphs
(replay == eager body, sampled graph == ``fused=False``, the sampler's
distribution and the key stream's bits on the card), and the dense
configs' geometries (starcoder2-15b's and gemma3-27b's heads, gemma3's
dual caches), the MoE block (deterministic, captured, routed as on
the CPU), and the encoder-decoder and vision families' attention
(non-causal flash over a context, decode over a full context cache) and
a vision round under a graph, on the card.  Marked ``gpu``: without a card
each test skips at run time (the kernels have no CPU mode).  Imports torch and numpy only, so the file
runs on the card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance 2e-2: bf16 outputs, sums in another order than the plain
versions (as ``test_kernels.py`` holds bf16 kernels).  The flash and the
four decode kernels run both products on the tensor cores: they sum in
mma order and round the softmax weights P to bf16 before P . V (at most
2^-8 relative per weight); the int8 kernels widen their codes to the
same bf16 rows as their plain versions.  All of it is far inside 2e-2.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa


# -- CUDA kernels against their plain versions (card only) -------------------


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time, never at import or
    collection, so every test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _cuda_rand(rng, shape, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device).to(torch.bfloat16)


HEADS = {128: (28, 4), 64: (25, 5)}  # qwen2-7b's and hymba-1.5b's heads
FLASH_CASES = [  # (B, Sq, Sk, causal, window, q_offset, D)
    (1, 512, 512, True, None, 0, 128), (2, 37, 37, True, None, 0, 128),
    (1, 1, 1, True, None, 0, 128), (1, 100, 100, True, 33, 0, 128),
    (1, 20, 84, True, None, 64, 128), (2, 40, 70, False, None, 0, 128),
    # Sk not a multiple of 16 (nor Sq), with and without the mask
    (1, 23, 45, False, None, 0, 128), (1, 37, 77, True, None, 40, 128),
    (2, 50, 50, True, None, 0, 64),
] + [  # every prefill bucket length, at both head dims
    (1, n, n, True, None, 0, d) for d in (128, 64)
    for n in (2, 4, 8, 16, 32, 64, 128, 256)
] + [(1, 1, 1, True, None, 0, 64), (1, 512, 512, True, None, 0, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_vs_plain(cuda_device, case):
    b, sq, sk, causal, window, off, d = case
    h, kv = HEADS[d]
    rng = np.random.default_rng(sq + sk)
    q = _cuda_rand(rng, (b, sq, h, d), cuda_device)
    k = _cuda_rand(rng, (b, sk, kv, d), cuda_device)
    v = _cuda_rand(rng, (b, sk, kv, d), cuda_device)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=off)
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("window,bs,d", [
    (None, 16, 128), (100, 16, 128),  # the engine's page size; a window
    (None, 8, 128), (None, 32, 128),  # pages below and above one tile
    (None, 16, 64)])                  # hymba's heads (G = 5, D = 64)
def test_decode_kernels_vs_plain_and_each_other(cuda_device, window, bs,
                                                d):
    """bf16 dense and paged decode against their plain versions, and
    bit-equal to each other on identical K/V at every page size: both walk
    tiles of 16 logical rows through one tile loop."""
    b, s = 8, 1024
    h, n_kv = HEADS[d]
    rng = np.random.default_rng(11)
    lens_np = np.array([1024, 1, 517, 64, 1000, 333, 768, 129], np.int32)
    q = _cuda_rand(rng, (b, 1, h, d), cuda_device)
    kc = _cuda_rand(rng, (b, s, n_kv, d), cuda_device)
    vc = _cuda_rand(rng, (b, s, n_kv, d), cuda_device)
    lens = torch.as_tensor(lens_np, device=cuda_device)
    dense = da.decode_attention(q, kc, vc, lens, window=window)
    torch.testing.assert_close(
        dense.float(),
        da.decode_attention_plain(q, kc, vc, lens, window=window).float(),
        atol=2e-2, rtol=2e-2)
    if window is not None:
        return  # the paged kernel has no window (as the Pallas one)
    m = s // bs
    perm = rng.permutation(np.arange(1, 1 + b * m))
    tables_np = np.zeros((b, m), np.int32)
    kp = torch.zeros((1 + b * m, bs, n_kv, d), dtype=torch.bfloat16,
                     device=cuda_device)
    vp = torch.zeros_like(kp)
    for i in range(b):
        for t in range(-(-int(lens_np[i]) // bs)):
            tables_np[i, t] = perm[i * m + t]
            kp[tables_np[i, t]] = kc[i, t * bs:(t + 1) * bs]
            vp[tables_np[i, t]] = vc[i, t * bs:(t + 1) * bs]
    tables = torch.as_tensor(tables_np, device=cuda_device)
    paged = da.paged_decode_attention(q, kp, vp, tables, lens)
    torch.testing.assert_close(
        paged.float(),
        da.paged_decode_attention_plain(q, kp, vp, tables, lens).float(),
        atol=2e-2, rtol=2e-2)
    assert torch.equal(paged, dense)  # one shared tile loop


@pytest.mark.gpu
def test_decode_kernel_clamps_past_cache_end(cuda_device):
    """A free continuous slot's cache_len runs past S: the kernel reads
    only the S rows (same values as the plain masked softmax)."""
    rng = np.random.default_rng(12)
    q = _cuda_rand(rng, (2, 1, 28, 128), cuda_device)
    kc = _cuda_rand(rng, (2, 64, 4, 128), cuda_device)
    vc = _cuda_rand(rng, (2, 64, 4, 128), cuda_device)
    lens = torch.tensor([64 + 5, 10_000], dtype=torch.int32,
                        device=cuda_device)
    got = da.decode_attention(q, kc, vc, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(), da.decode_attention_plain(q, kc, vc, lens).float(),
        atol=2e-2, rtol=2e-2)


# -- the bf16 decode kernels: one launch a call, its splits one cluster ------


def _bf16_pair(q, kc, vc, lens, kp, vp, tables):
    """Dense and paged bf16 decode on the same rows, each against the
    plain version; returns both outputs."""
    dense = da.decode_attention(q, kc, vc, lens)
    paged = da.paged_decode_attention(q, kp, vp, tables, lens)
    want = da.decode_attention_plain(q, kc, vc, lens).float()
    for got in (dense, paged):
        torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
    return dense, paged


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 32, 16])
@pytest.mark.parametrize("bs", [1, 3, 8, 16, 32, 64])
def test_bf16_paged_equals_dense_at_page_sizes(cuda_device, bs, d):
    """bf16 pages of 1-64 rows (TMA boxes of gcd(bs, 16) rows, a page's
    piece of a tile, each at a 128-byte aligned pitch) give the dense
    kernel's output bit for bit, at head dims 128, 32 and 16."""
    b, s = 4, bs * -(-320 // bs)
    rng = np.random.default_rng(bs * d)
    q = _cuda_rand(rng, (b, 1, 28, d), cuda_device)
    kc, vc = (_cuda_rand(rng, (b, s, 4, d), cuda_device) for _ in range(2))
    lens = torch.tensor([s, 1, 150, 77], dtype=torch.int32,
                        device=cuda_device)
    (kp, vp), tables = _pooled(rng, (kc, vc), bs, cuda_device)
    dense, paged = _bf16_pair(q, kc, vc, lens, kp, vp, tables)
    assert torch.equal(paged, dense)


def _masked_plain(q, kc, vc, lens, valid):
    """The plain decode over the rows ``valid`` (B, S) marks, below
    cache_len, in f32."""
    b, _, h, d = q.shape
    s, kv = kc.shape[1:3]
    qg = q.reshape(b, kv, h // kv, d).float() * d ** -0.5
    scores = torch.einsum("bkgd,bskd->bkgs", qg, kc.float())
    live = valid & (torch.arange(s, device=q.device)[None, :]
                    < lens[:, None].long())
    scores = scores.masked_fill(~live[:, None, None, :], -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p, vc.float()).reshape(b, 1, h, d)


@pytest.mark.gpu
@pytest.mark.parametrize("outside", ["-1", "N"])
def test_bf16_paged_entries_outside_the_pool_are_masked(cuda_device,
                                                        outside):
    """A table entry of -1 or N within cache_len: its rows read as zeros
    (TMA's out-of-bounds fill) and are masked, as if the cache did not
    hold them."""
    b, s, bs = 4, 256, 16
    rng = np.random.default_rng(21)
    q = _cuda_rand(rng, (b, 1, 28, 128), cuda_device)
    kc, vc = (_cuda_rand(rng, (b, s, 4, 128), cuda_device)
              for _ in range(2))
    lens = torch.tensor([256, 200, 100, 37], dtype=torch.int32,
                        device=cuda_device)
    (kp, vp), tables = _pooled(rng, (kc, vc), bs, cuda_device)
    entry = -1 if outside == "-1" else kp.shape[0]
    tables = tables.clone()
    valid = torch.ones(b, s, dtype=torch.bool, device=cuda_device)
    for i, page in [(0, 3), (0, 15), (1, 0), (2, 5), (3, 2)]:
        tables[i, page] = entry
        valid[i, page * bs:(page + 1) * bs] = False
    got = da.paged_decode_attention(q, kp, vp, tables, lens)
    torch.testing.assert_close(got.float(),
                               _masked_plain(q, kc, vc, lens, valid),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_bf16_paged_never_reads_unnamed_pages(cuda_device):
    """Pages that no table entry names hold NaN: the output is bit-equal
    to the clean pool's.  (Rows past cache_len on a named page are masked
    but may be read: 0 x NaN in P . V would show there.)"""
    b, s, bs = 8, 512, 16
    rng = np.random.default_rng(22)
    q = _cuda_rand(rng, (b, 1, 28, 128), cuda_device)
    kc, vc = (_cuda_rand(rng, (b, s, 4, 128), cuda_device)
              for _ in range(2))
    lens_np = np.array([512, 1, 300, 17, 64, 480, 129, 250], np.int32)
    used = -(-lens_np // bs)
    n_blocks = 1 + int(used.sum()) + 40  # the null block, named, unnamed
    ids = rng.permutation(np.arange(1, n_blocks))
    tables_np = np.zeros((b, s // bs), np.int32)  # past the end: block 0
    clean = [torch.zeros((n_blocks, bs, 4, 128), dtype=torch.bfloat16,
                         device=cuda_device) for _ in range(2)]
    k = 0
    for i in range(b):
        for t in range(used[i]):
            tables_np[i, t] = ids[k]
            k += 1
            for pool, x in zip(clean, (kc, vc)):
                pool[tables_np[i, t]] = x[i, t * bs:(t + 1) * bs]
    unnamed = torch.as_tensor(ids[k:], device=cuda_device).long()
    dirty = [pool.clone() for pool in clean]
    for pool in dirty:
        pool[unnamed] = float("nan")
    tables = torch.as_tensor(tables_np, device=cuda_device)
    lens = torch.as_tensor(lens_np, device=cuda_device)
    want = da.paged_decode_attention(q, *clean, tables, lens)
    torch.testing.assert_close(
        want.float(), da.decode_attention_plain(q, kc, vc, lens).float(),
        atol=2e-2, rtol=2e-2)
    assert torch.equal(da.paged_decode_attention(q, *dirty, tables, lens),
                       want)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ones", "past_end", "b1_full",
                                  "b1_short"])
def test_bf16_decode_edge_lengths(cuda_device, case):
    """cache_len of 1 everywhere (every cluster's CTAs past the first have
    no rows, and still pass both cluster barriers), cache_len past S (a
    free slot), and B = 1 (the largest split: a full cluster)."""
    s, bs = 1024, 16
    lens = {"ones": [1] * 8,
            "past_end": [s + 40, 1, 2000, 517, s, 3, s + 1, 64],
            "b1_full": [s], "b1_short": [17]}[case]
    b = len(lens)
    rng = np.random.default_rng(23 + b)
    q = _cuda_rand(rng, (b, 1, 28, 128), cuda_device)
    kc, vc = (_cuda_rand(rng, (b, s, 4, 128), cuda_device)
              for _ in range(2))
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    (kp, vp), tables = _pooled(rng, (kc, vc), bs, cuda_device)
    dense, paged = _bf16_pair(q, kc, vc, lens, kp, vp, tables)
    assert torch.equal(paged, dense)


@pytest.mark.gpu
@pytest.mark.parametrize("h,kv,s", [
    (32, 16, 2048),  # gemma3-27b's global layers: G = 2
    (16, 16, 1024), (16, 4, 1024), (28, 4, 1024), (48, 4, 1024),
    (64, 4, 1024)])  # G = 1, 4, 7, 12, 16
def test_bf16_decode_geometries(cuda_device, h, kv, s):
    """Dense and paged bf16 decode at gemma3's S = 2048 with G = 2, and at
    G = 1, 4, 7, 12 and 16 query heads per kv head (mixed lengths, a free
    slot past S), against the plain version and bit-equal to each
    other."""
    rng = np.random.default_rng(h + kv + s)
    lens = torch.tensor([s, 1, s // 2 + 5, 64, s + 40, 333, 17, s - 1],
                        dtype=torch.int32, device=cuda_device)
    q = _cuda_rand(rng, (8, 1, h, 128), cuda_device)
    kc, vc = (_cuda_rand(rng, (8, s, kv, 128), cuda_device)
              for _ in range(2))
    (kp, vp), tables = _pooled(rng, (kc, vc), 16, cuda_device)
    dense, paged = _bf16_pair(q, kc, vc, lens, kp, vp, tables)
    assert torch.equal(paged, dense)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_bf16_decode_graph_replay_equals_eager(cuda_device, paged):
    """A bf16 decode call captured in a CUDA graph (a cluster launch, its
    tensor maps baked for the static buffers, as the round's graph bakes
    them) replays equal to the eager call bit for bit, and after new q,
    K/V and lengths are copied into the same buffers, equal to the eager
    call on those."""
    rng = np.random.default_rng(24)
    b, s = 8, 1024
    q = _cuda_rand(rng, (b, 1, 28, 128), cuda_device)
    kc, vc = (_cuda_rand(rng, (b, s, 4, 128), cuda_device)
              for _ in range(2))
    lens = torch.tensor([1024, 1, 517, 64, 1000, 333, 768, 129],
                        dtype=torch.int32, device=cuda_device)
    (kp, vp), tables = _pooled(rng, (kc, vc), 16, cuda_device)
    kv = (kp, vp) if paged else (kc, vc)

    def call():
        if paged:
            return da.paged_decode_attention(q, kp, vp, tables, lens)
        return da.decode_attention(q, kc, vc, lens)

    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):  # warm up off the default stream
        call()
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call())
        for x in (q, *kv):
            x.copy_(_cuda_rand(rng, tuple(x.shape), cuda_device))
        lens.copy_(torch.as_tensor(rng.integers(1, s + 50, size=b),
                                   dtype=torch.int32))


@pytest.mark.gpu
def test_bf16_decode_is_one_kernel_a_call(cuda_device):
    """Each bf16 call, dense and paged, is one kernel on the device: the
    splits merge inside their cluster, with no combine kernel."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(25)
    q = _cuda_rand(rng, (8, 1, 28, 128), cuda_device)
    kc, vc = (_cuda_rand(rng, (8, 1024, 4, 128), cuda_device)
              for _ in range(2))
    lens = torch.tensor([1024, 1, 517, 64, 1000, 333, 768, 129],
                        dtype=torch.int32, device=cuda_device)
    (kp, vp), tables = _pooled(rng, (kc, vc), 16, cuda_device)
    da.decode_attention(q, kc, vc, lens)
    da.paged_decode_attention(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    for _ in range(3):  # a profile that came back empty is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            da.decode_attention(q, kc, vc, lens)
            da.paged_decode_attention(q, kp, vp, tables, lens)
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() != torch.autograd.DeviceType.CPU]
        if names:
            break
    assert len(names) == 2, names
    assert "decode_bf16_kernel" in names[0] and "paged" not in names[0]
    assert "paged_decode_bf16_kernel" in names[1]


def _int8_cache(rng, shape, device):
    """Random bf16 rows quantized on the card: (codes, scales)."""
    from repro_torch.models.attention import kv_quantize
    return kv_quantize(_cuda_rand(rng, shape, device))


@pytest.mark.gpu
@pytest.mark.parametrize("lens_case", ["mixed", "one", "full", "past_end",
                                       "b1_full", "b1_short"])
def test_int8_decode_kernels_vs_plain_and_each_other(cuda_device, lens_case):
    """int8 dense and paged decode against their plain versions, and
    bit-equal to each other on identical codes: mixed lengths, cache_len
    of 1 everywhere (every cluster's CTAs past the first have no rows),
    full, past S (a free slot), and B = 1 (one full cluster of 16)."""
    s, bs = 1024, 16
    rng = np.random.default_rng(13)
    mixed = np.array([1024, 1, 517, 64, 1000, 333, 768, 129])
    lens_np = {"mixed": mixed, "one": np.ones(8), "full": np.full(8, s),
               "past_end": mixed + s, "b1_full": np.array([s]),
               "b1_short": np.array([17])}[lens_case].astype(np.int32)
    b = len(lens_np)
    q = _cuda_rand(rng, (b, 1, 28, 128), cuda_device)
    k8, ks = _int8_cache(rng, (b, s, 4, 128), cuda_device)
    v8, vs = _int8_cache(rng, (b, s, 4, 128), cuda_device)
    lens = torch.as_tensor(lens_np, device=cuda_device)
    before = da.decode_attention_quant.launches
    dense = da.decode_attention_quant(q, k8, v8, ks, vs, lens)
    assert da.decode_attention_quant.launches == before + 1
    torch.testing.assert_close(
        dense.float(),
        da.decode_attention_quant_plain(q, k8, v8, ks, vs, lens).float(),
        atol=2e-2, rtol=2e-2)
    if lens_case == "past_end":
        return  # pages hold no rows past their table
    m = s // bs
    perm = rng.permutation(np.arange(1, 1 + b * m))
    tables_np = np.zeros((b, m), np.int32)
    pages = [torch.zeros((1 + b * m, bs, 4, d), dtype=x.dtype,
                         device=cuda_device)
             for x, d in ((k8, 128), (v8, 128), (ks, 1), (vs, 1))]
    pages[0][0] = 77  # garbage in the null block is never read
    for i in range(b):
        for t in range(-(-int(lens_np[i]) // bs)):
            tables_np[i, t] = perm[i * m + t]
            for page, x in zip(pages, (k8, v8, ks, vs)):
                page[tables_np[i, t]] = x[i, t * bs:(t + 1) * bs]
    tables = torch.as_tensor(tables_np, device=cuda_device)
    paged = da.paged_decode_attention_quant(q, *pages, tables, lens)
    torch.testing.assert_close(
        paged.float(),
        da.paged_decode_attention_quant_plain(q, *pages, tables,
                                              lens).float(),
        atol=2e-2, rtol=2e-2)
    assert torch.equal(paged, dense)  # one shared tile loop


def _pooled(rng, xs, bs, device):
    """The dense (B, S, ...) leaves ``xs`` (K/V, or codes and scales)
    scattered over a pool of bs-row pages in a random order: (pools,
    (B, S / bs) int32 tables)."""
    b, s = xs[0].shape[:2]
    m = s // bs
    order = torch.as_tensor(rng.permutation(b * m).astype(np.int32),
                            device=device)
    pools = []
    for x in xs:
        pool = torch.empty((b * m, bs, *x.shape[2:]), dtype=x.dtype,
                           device=device)
        pool[order.long()] = x.reshape(b * m, bs, *x.shape[2:])
        pools.append(pool)
    return pools, order.reshape(b, m)


@pytest.mark.gpu
@pytest.mark.parametrize("bs", [1, 3, 8, 16, 32, 64])
def test_int8_paged_equals_dense_at_page_sizes(cuda_device, bs):
    """int8 pages of 1-64 rows (TMA boxes of gcd(bs, 16) rows of codes at
    128-byte aligned pitches, the scales by the producer warp): the paged
    kernel walks the same tiles of 16 logical rows as the dense one, so
    it is bit-equal to it."""
    b, s = 8, bs * -(-1024 // bs)
    rng = np.random.default_rng(14)
    lens = torch.tensor([1024, 1, 517, 64, 1000, 333, 768, 129],
                        dtype=torch.int32, device=cuda_device)
    q = _cuda_rand(rng, (b, 1, 28, 128), cuda_device)
    k8, ks = _int8_cache(rng, (b, s, 4, 128), cuda_device)
    v8, vs = _int8_cache(rng, (b, s, 4, 128), cuda_device)
    dense = da.decode_attention_quant(q, k8, v8, ks, vs, lens)
    pools, tables = _pooled(rng, (k8, v8, ks, vs), bs, cuda_device)
    paged = da.paged_decode_attention_quant(q, *pools, tables, lens)
    torch.testing.assert_close(
        paged.float(),
        da.paged_decode_attention_quant_plain(q, *pools, tables,
                                              lens).float(),
        atol=2e-2, rtol=2e-2)
    assert torch.equal(paged, dense)


@pytest.mark.gpu
@pytest.mark.parametrize("g,d", [(12, 128), (16, 128), (12, 64), (16, 64)])
def test_decode_kernels_at_wide_groups(cuda_device, g, d):
    """All four decode kernels with 12 and 16 query heads per kv head
    (starcoder2-15b's G = 12; 16 fills the A fragment) against their
    plain versions, each paged kernel bit-equal to its dense one."""
    b, s, n_kv = 4, 256, 2
    rng = np.random.default_rng(g + d)
    lens = torch.tensor([256, 1, 100, 177], dtype=torch.int32,
                        device=cuda_device)
    q = _cuda_rand(rng, (b, 1, g * n_kv, d), cuda_device)
    kc = _cuda_rand(rng, (b, s, n_kv, d), cuda_device)
    vc = _cuda_rand(rng, (b, s, n_kv, d), cuda_device)
    k8, ks = _int8_cache(rng, (b, s, n_kv, d), cuda_device)
    v8, vs = _int8_cache(rng, (b, s, n_kv, d), cuda_device)
    (kp, vp), tables = _pooled(rng, (kc, vc), 16, cuda_device)
    pools, tables8 = _pooled(rng, (k8, v8, ks, vs), 16, cuda_device)
    pairs = [
        (da.decode_attention(q, kc, vc, lens),
         da.decode_attention_plain(q, kc, vc, lens)),
        (da.paged_decode_attention(q, kp, vp, tables, lens),
         da.paged_decode_attention_plain(q, kp, vp, tables, lens)),
        (da.decode_attention_quant(q, k8, v8, ks, vs, lens),
         da.decode_attention_quant_plain(q, k8, v8, ks, vs, lens)),
        (da.paged_decode_attention_quant(q, *pools, tables8, lens),
         da.paged_decode_attention_quant_plain(q, *pools, tables8, lens))]
    for got, want in pairs:
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    assert torch.equal(pairs[1][0], pairs[0][0])
    assert torch.equal(pairs[3][0], pairs[2][0])


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 8])
def test_int8_code_view_off_16_bytes_raises(cuda_device, offset):
    """The int8 kernels copy codes 16 bytes at a time: a code view that
    does not start on a 16-byte boundary is refused before any launch."""
    b, s, n_kv, d = 2, 64, 4, 128
    rng = np.random.default_rng(15)
    q = _cuda_rand(rng, (b, 1, 28, d), cuda_device)
    k8, ks = _int8_cache(rng, (b, s, n_kv, d), cuda_device)
    v8, vs = _int8_cache(rng, (b, s, n_kv, d), cuda_device)
    flat = torch.zeros(k8.numel() + 16, dtype=torch.int8, device=cuda_device)
    shifted = flat[offset:offset + k8.numel()].view(k8.shape)
    shifted.copy_(k8)
    lens = torch.tensor([64, 9], dtype=torch.int32, device=cuda_device)
    pools, tables = _pooled(rng, (shifted, v8, ks, vs), 16, cuda_device)
    pool_flat = torch.zeros(pools[0].numel() + 16, dtype=torch.int8,
                            device=cuda_device)
    pools[0] = pool_flat[offset:offset + pools[0].numel()].view(
        pools[0].shape)
    before = (da.decode_attention_quant.launches,
              da.paged_decode_attention_quant.launches)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        da.decode_attention_quant(q, shifted, v8, ks, vs, lens)
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        da.paged_decode_attention_quant(q, *pools, tables, lens)
    assert (da.decode_attention_quant.launches,
            da.paged_decode_attention_quant.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("g", [1, 7, 12, 16])
def test_int8_decode_geometries(cuda_device, g, d):
    """The int8 pair at G = 1, 7, 12 and 16 query heads per kv head and at
    head dims 16-128 (int8 rows of 16-128 bytes: TMA boxes swizzled to
    32, 64 and 128 bytes, none at 16), mixed lengths and a free slot past
    S, against the plain version and dense == paged bit for bit."""
    b, s, n_kv = 8, 512, 2
    rng = np.random.default_rng(100 * g + d)
    lens = torch.tensor([s, 1, 300, 17, s + 40, 129, 64, s - 1],
                        dtype=torch.int32, device=cuda_device)
    q = _cuda_rand(rng, (b, 1, g * n_kv, d), cuda_device)
    k8, ks = _int8_cache(rng, (b, s, n_kv, d), cuda_device)
    v8, vs = _int8_cache(rng, (b, s, n_kv, d), cuda_device)
    dense = da.decode_attention_quant(q, k8, v8, ks, vs, lens)
    torch.testing.assert_close(
        dense.float(),
        da.decode_attention_quant_plain(q, k8, v8, ks, vs, lens).float(),
        atol=2e-2, rtol=2e-2)
    pools, tables = _pooled(rng, (k8, v8, ks, vs), 16, cuda_device)
    lens_in = lens.clamp(max=s)  # pages hold no rows past their table
    paged = da.paged_decode_attention_quant(q, *pools, tables, lens_in)
    assert torch.equal(paged,
                       da.decode_attention_quant(q, k8, v8, ks, vs, lens_in))


@pytest.mark.gpu
def test_int8_paged_never_reads_unnamed_pages(cuda_device):
    """Pages that no table entry names hold NaN scales and the largest
    codes: the output is bit-equal to the clean pool's."""
    b, s, bs = 8, 512, 16
    rng = np.random.default_rng(26)
    q = _cuda_rand(rng, (b, 1, 28, 128), cuda_device)
    k8, ks = _int8_cache(rng, (b, s, 4, 128), cuda_device)
    v8, vs = _int8_cache(rng, (b, s, 4, 128), cuda_device)
    lens_np = np.array([512, 1, 300, 17, 64, 480, 129, 250], np.int32)
    used = -(-lens_np // bs)
    n_blocks = 1 + int(used.sum()) + 40  # the null block, named, unnamed
    ids = rng.permutation(np.arange(1, n_blocks))
    tables_np = np.zeros((b, s // bs), np.int32)  # past the end: block 0
    clean = [torch.zeros((n_blocks, bs, 4, x.shape[-1]), dtype=x.dtype,
                         device=cuda_device) for x in (k8, v8, ks, vs)]
    k = 0
    for i in range(b):
        for t in range(used[i]):
            tables_np[i, t] = ids[k]
            k += 1
            for pool, x in zip(clean, (k8, v8, ks, vs)):
                pool[tables_np[i, t]] = x[i, t * bs:(t + 1) * bs]
    unnamed = torch.as_tensor(ids[k:], device=cuda_device).long()
    dirty = [pool.clone() for pool in clean]
    for pool in dirty[:2]:
        pool[unnamed] = 127
    for pool in dirty[2:]:
        pool[unnamed] = float("nan")
    tables = torch.as_tensor(tables_np, device=cuda_device)
    lens = torch.as_tensor(lens_np, device=cuda_device)
    want = da.paged_decode_attention_quant(q, *clean, tables, lens)
    torch.testing.assert_close(
        want.float(),
        da.decode_attention_quant_plain(q, k8, v8, ks, vs, lens).float(),
        atol=2e-2, rtol=2e-2)
    assert torch.equal(
        da.paged_decode_attention_quant(q, *dirty, tables, lens), want)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_int8_decode_graph_replay_equals_eager(cuda_device, paged):
    """An int8 decode call captured in a CUDA graph (a cluster launch, its
    code maps baked for the static buffers) replays equal to the eager
    call bit for bit, and after new q, codes, scales and lengths are
    copied into the same buffers, equal to the eager call on those."""
    rng = np.random.default_rng(27)
    b, s = 8, 1024
    q = _cuda_rand(rng, (b, 1, 28, 128), cuda_device)
    k8, ks = _int8_cache(rng, (b, s, 4, 128), cuda_device)
    v8, vs = _int8_cache(rng, (b, s, 4, 128), cuda_device)
    lens = torch.tensor([1024, 1, 517, 64, 1000, 333, 768, 129],
                        dtype=torch.int32, device=cuda_device)
    pools, tables = _pooled(rng, (k8, v8, ks, vs), 16, cuda_device)
    leaves = pools if paged else [k8, v8, ks, vs]

    def call():
        if paged:
            return da.paged_decode_attention_quant(q, *pools, tables, lens)
        return da.decode_attention_quant(q, k8, v8, ks, vs, lens)

    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):  # warm up off the default stream
        call()
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call())
        q.copy_(_cuda_rand(rng, tuple(q.shape), cuda_device))
        (kn, ksn), (vn, vsn) = (_int8_cache(rng, (b, s, 4, 128),
                                            cuda_device) for _ in range(2))
        for x, y in zip(leaves, (kn, vn, ksn, vsn)):
            x.copy_(y.reshape(x.shape))
        lens.copy_(torch.as_tensor(rng.integers(1, s + 1, size=b),
                                   dtype=torch.int32))


@pytest.mark.gpu
def test_int8_decode_is_one_kernel_a_call(cuda_device):
    """Each int8 call, dense and paged, is one kernel on the device: the
    splits merge inside their cluster, with no combine kernel."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(28)
    q = _cuda_rand(rng, (8, 1, 28, 128), cuda_device)
    k8, ks = _int8_cache(rng, (8, 1024, 4, 128), cuda_device)
    v8, vs = _int8_cache(rng, (8, 1024, 4, 128), cuda_device)
    lens = torch.tensor([1024, 1, 517, 64, 1000, 333, 768, 129],
                        dtype=torch.int32, device=cuda_device)
    pools, tables = _pooled(rng, (k8, v8, ks, vs), 16, cuda_device)
    da.decode_attention_quant(q, k8, v8, ks, vs, lens)
    da.paged_decode_attention_quant(q, *pools, tables, lens)
    torch.cuda.synchronize()
    for _ in range(3):  # a profile that came back empty is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            da.decode_attention_quant(q, k8, v8, ks, vs, lens)
            da.paged_decode_attention_quant(q, *pools, tables, lens)
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() != torch.autograd.DeviceType.CPU]
        if names:
            break
    assert len(names) == 2, names
    assert "decode_q8_kernel" in names[0] and "paged" not in names[0]
    assert "paged_decode_q8_kernel" in names[1]


def _wkv_inputs(rng, b, s, h, device, decay="mild", state_scale=1.0):
    """r, k, v, w, u, state on the card; w a negative log decay: "mild"
    -exp(0.3 N) - 0.01 (as test_kernels.py), "strong" -exp(N + 2) (a
    chunk's decay reaches hundreds), "weak" -1e-3."""
    r, k, v = (_cuda_rand(rng, (b, s, h, 64), device) for _ in range(3))
    n = rng.normal(size=(b, s, h, 64)).astype(np.float32)
    w = {"mild": -np.exp(n * 0.3) - 0.01, "strong": -np.exp(n + 2.0),
         "weak": np.full_like(n, -1e-3)}[decay]
    w = torch.from_numpy(w.astype(np.float32)).to(device).to(torch.bfloat16)
    u = _cuda_rand(rng, (h, 64), device)
    st = (torch.from_numpy(rng.normal(size=(b, h, 64, 64)).astype(
        np.float32)) * state_scale).to(device)
    return r, k, v, w, u, st


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,decay,state_scale", [
    (1, 512, 32, "mild", 0.0),   # batch-1 prefill from a zero state
    (8, 1, 32, "mild", 1.0),     # a decode step of 8 slots
    (2, 77, 4, "mild", 1.0),     # S not a multiple of a chunk
    (1, 33, 2, "mild", 3.0),
    (1, 15, 32, "mild", 1.0),    # CHUNKED_MIN_S - 1, S and S + 1
    (1, 16, 32, "mild", 1.0),
    (1, 17, 32, "mild", 1.0),
    (1, 512, 32, "strong", 1.0),
    (1, 512, 32, "weak", 1.0),
    (1, 2048, 32, "mild", 1.0)])  # a long prompt from a nonzero state
def test_wkv6_kernel_vs_plain(cuda_device, b, s, h, decay, state_scale):
    """The scan on the card takes the step kernel below CHUNKED_MIN_S and
    the chunked kernel from there; each against the plain scan."""
    from repro_torch.kernels import wkv6
    rng = np.random.default_rng(s + h)
    x = _wkv_inputs(rng, b, s, h, cuda_device, decay, state_scale)
    before = (wkv6.wkv6_scan.launches, wkv6.wkv6_step.launches,
              wkv6.wkv6_chunked.launches)
    out, new = wkv6.wkv6_scan(*x)
    torch.cuda.synchronize()
    chunked = s >= wkv6.CHUNKED_MIN_S
    assert (wkv6.wkv6_scan.launches, wkv6.wkv6_step.launches,
            wkv6.wkv6_chunked.launches) == (
        before[0] + 1, before[1] + (not chunked), before[2] + chunked)
    want_out, want_st = wkv6.wkv6_scan_plain(*x)
    assert torch.isfinite(out.float()).all() and torch.isfinite(new).all()
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(new, want_st, atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["step", "chunked"])
def test_wkv6_kernel_short_sequences(cuda_device, kernel):
    """Each kernel alone takes any S >= 1: S = 1, 2, 16, 31 and 33."""
    from repro_torch.kernels import wkv6
    fn = {"step": wkv6.wkv6_step, "chunked": wkv6.wkv6_chunked}[kernel]
    rng = np.random.default_rng(16)
    for s in (1, 2, 16, 31, 33):
        x = _wkv_inputs(rng, 2, s, 4, cuda_device, "strong")
        out, new = fn(*x)
        want_out, want_st = wkv6.wkv6_scan_plain(*x)
        torch.testing.assert_close(out.float(), want_out.float(),
                                   atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(new, want_st, atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
def test_wkv6_split_scan_equals_whole(cuda_device):
    """A 2048-step scan split at step 777 (the state carried across the
    calls) and at step 5 (a step-kernel head) equals the whole scan."""
    from repro_torch.kernels import wkv6
    rng = np.random.default_rng(17)
    r, k, v, w, u, st = _wkv_inputs(rng, 1, 2048, 32, cuda_device)
    whole, st_whole = wkv6.wkv6_scan(r, k, v, w, u, st)
    for cut in (777, 5):
        head, st_mid = wkv6.wkv6_scan(*(x[:, :cut] for x in (r, k, v, w)),
                                      u, st)
        tail, st_end = wkv6.wkv6_scan(
            *(x[:, cut:].contiguous() for x in (r, k, v, w)), u, st_mid)
        torch.testing.assert_close(torch.cat([head, tail], 1).float(),
                                   whole.float(), atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(st_end, st_whole, atol=2e-2, rtol=2e-2)


def _ssm_inputs(rng, b, s, h, device, d=64, n=16, decay="mild",
                state_scale=1.0):
    """x, dt, a_log, b, c, state on the card, as the hybrid layer makes
    them: dt = softplus(.) in bf16, a_log at the ``small`` init scale
    ("mild"); "strong": a_log = log(1..N) + 2 and dt = softplus(N + 2) (a
    16-step chunk's exponent reaches hundreds); "weak": dt = 1e-3."""
    x = _cuda_rand(rng, (b, s, h, d), device)
    z = torch.from_numpy(rng.normal(size=(b, s, h)).astype(np.float32))
    dt = {"mild": torch.nn.functional.softplus(z),
          "strong": torch.nn.functional.softplus(z + 2.0),
          "weak": torch.full_like(z, 1e-3)}[decay]
    a_log = torch.log(torch.arange(1.0, n + 1)).repeat(h, 1) + 2.0 \
        if decay == "strong" else torch.from_numpy(
            rng.normal(size=(h, n)).astype(np.float32)) * 0.02
    bm, cm = (_cuda_rand(rng, (b, s, h, n), device) for _ in range(2))
    st = (torch.from_numpy(rng.normal(size=(b, h, d, n)).astype(
        np.float32)) * state_scale).to(device)
    return (x, dt.to(device).to(torch.bfloat16),
            a_log.to(device).to(torch.bfloat16), bm, cm, st)


def _ssm_close(got, want):
    (y, st), (want_y, want_st) = got, want
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(st, want_st, atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,decay,state_scale", [
    (1, 640, 25, "mild", 0.0),   # hymba prefill: 512-token prompt + 128 meta
    (8, 1, 25, "mild", 1.0),     # a decode step of 8 slots
    (1, 1, 25, "mild", 1.0),     # S = 1 at B = 1
    (1, 77, 25, "mild", 1.0),    # S not a multiple of a chunk
    (1, 300, 25, "mild", 1.0),   # past the Pallas kernel's 256-step block
    (2, 33, 4, "mild", 3.0),     # nonzero initial states, another head count
    (1, 15, 25, "mild", 1.0),    # CHUNKED_MIN_S - 1, S and S + 1
    (1, 16, 25, "mild", 1.0),
    (1, 17, 25, "mild", 1.0),
    (1, 640, 25, "strong", 1.0),
    (1, 640, 25, "weak", 1.0),
    (1, 2048, 25, "mild", 1.0)])  # a long prompt from a nonzero state
def test_ssm_kernel_vs_plain(cuda_device, b, s, h, decay, state_scale):
    """The scan on the card takes the step kernel below CHUNKED_MIN_S and
    the chunked kernel from there; each against the plain scan."""
    from repro_torch.kernels import ssm_scan
    rng = np.random.default_rng(s + h)
    x = _ssm_inputs(rng, b, s, h, cuda_device, decay=decay,
                    state_scale=state_scale)
    before = (ssm_scan.ssm_scan.launches, ssm_scan.ssm_step.launches,
              ssm_scan.ssm_chunked.launches)
    got = ssm_scan.ssm_scan(*x)
    torch.cuda.synchronize()
    chunked = s >= ssm_scan.CHUNKED_MIN_S
    assert (ssm_scan.ssm_scan.launches, ssm_scan.ssm_step.launches,
            ssm_scan.ssm_chunked.launches) == (
        before[0] + 1, before[1] + (not chunked), before[2] + chunked)
    _ssm_close(got, ssm_scan.ssm_scan_plain(*x))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["step", "chunked"])
@pytest.mark.parametrize("d,n", [(16, 8), (64, 16)])
def test_ssm_kernel_short_sequences(cuda_device, kernel, d, n):
    """Each kernel alone takes any S >= 1: S = 1, 2, 16, 31 and 33, at
    strong decay."""
    from repro_torch.kernels import ssm_scan
    fn = {"step": ssm_scan.ssm_step, "chunked": ssm_scan.ssm_chunked}[kernel]
    rng = np.random.default_rng(16 + n)
    for s in (1, 2, 16, 31, 33):
        x = _ssm_inputs(rng, 2, s, 4, cuda_device, d, n, "strong")
        _ssm_close(fn(*x), ssm_scan.ssm_scan_plain(*x))


@pytest.mark.gpu
def test_ssm_split_scan_equals_whole(cuda_device):
    """A 2048-step scan split at step 777 (the state carried across the
    calls) and at step 5 (a step-kernel head) equals the whole scan."""
    from repro_torch.kernels import ssm_scan
    rng = np.random.default_rng(18)
    x, dt, a_log, bm, cm, st = _ssm_inputs(rng, 1, 2048, 25, cuda_device)
    whole, st_whole = ssm_scan.ssm_scan(x, dt, a_log, bm, cm, st)
    for cut in (777, 5):
        head, st_mid = ssm_scan.ssm_scan(
            *(t[:, :cut] for t in (x, dt)), a_log,
            *(t[:, :cut] for t in (bm, cm)), st)
        tail, st_end = ssm_scan.ssm_scan(
            *(t[:, cut:].contiguous() for t in (x, dt)), a_log,
            *(t[:, cut:].contiguous() for t in (bm, cm)), st_mid)
        _ssm_close((torch.cat([head, tail], 1), st_end), (whole, st_whole))


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 640])
def test_ssm_kernel_bad_shapes_raise(cuda_device, s):
    """D not a multiple of 16, or N not 8 or 16, is refused at either
    shape, with no launch counted."""
    from repro_torch.kernels import ssm_scan
    rng = np.random.default_rng(19)
    before = ssm_scan.ssm_scan.launches
    for d, n in ((8, 16), (64, 4)):
        x = _ssm_inputs(rng, 1, s, 2, cuda_device, d, n)
        with pytest.raises(ValueError, match="bad shapes"):
            ssm_scan.ssm_scan(*x)
    assert ssm_scan.ssm_scan.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 2, 15, 77, 640])
@pytest.mark.parametrize("d,n", [(16, 8), (64, 16)])
def test_ssm_step_kernel_vs_plain(cuda_device, s, d, n):
    """The step kernel alone at a round (S = 1), at S = 2 and 15 (the
    largest S the scan gives it) and at S = 77 and 640 (it takes any S),
    from zero and nonzero states, at strong decay (the decay underflows to
    0, as in the plain scan) and weak decay, in place and out of place."""
    from repro_torch.kernels import ssm_scan
    rng = np.random.default_rng(700 + s + n)
    for decay in ("strong", "weak"):
        for scale in (0.0, 1.0):
            x = _ssm_inputs(rng, 3, s, 5, cuda_device, d, n, decay, scale)
            want = ssm_scan.ssm_scan_plain(*x)
            _ssm_close(ssm_scan.ssm_step(*x), want)
            st = x[5].clone()
            got = ssm_scan.ssm_step(*x[:5], st, state_out=st)
            assert got[1] is st
            _ssm_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel,s", [("step", 1), ("step", 15),
                                      ("chunked", 16), ("chunked", 77)])
@pytest.mark.parametrize("d,n", [(16, 8), (64, 16)])
def test_ssm_in_place_equals_out_of_place(cuda_device, kernel, s, d, n):
    """Each kernel writes the same y and state bit for bit whether
    ``state_out`` is the state itself or a buffer apart from it (hymba's
    round: B = 8, H = 25)."""
    from repro_torch.kernels import ssm_scan
    fn = {"step": ssm_scan.ssm_step, "chunked": ssm_scan.ssm_chunked}[kernel]
    rng = np.random.default_rng(800 + s + n)
    x = _ssm_inputs(rng, 8, s, 25, cuda_device, d, n)
    apart = torch.full_like(x[5], float("nan"))
    y_apart, _ = fn(*x, state_out=apart)
    st = x[5].clone()
    y_in, _ = fn(*x[:5], st, state_out=st)
    torch.cuda.synchronize()
    assert torch.equal(y_in, y_apart) and torch.equal(st, apart)
    _ssm_close((y_in, st), ssm_scan.ssm_scan_plain(*x))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,d,n", [(1, 5, 16, 8), (3, 1, 16, 16),
                                     (1, 3, 48, 8)])
def test_ssm_step_kernel_partial_tail_cta(cuda_device, b, h, d, n):
    """B H D N / 4 threads that leave the last 128-thread CTA one to three
    warps short (160, 192 and 288 threads)."""
    from repro_torch.kernels import ssm_scan
    assert (b * h * d * n // 4) % 128
    rng = np.random.default_rng(b * h * d)
    for s in (1, 3):
        x = _ssm_inputs(rng, b, s, h, cuda_device, d, n)
        _ssm_close(ssm_scan.ssm_step(*x), ssm_scan.ssm_scan_plain(*x))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [4, 8])
@pytest.mark.parametrize("which", ["state", "state_out"])
@pytest.mark.parametrize("s", [1, 77])
def test_ssm_state_view_off_16_bytes_raises(cuda_device, offset, which, s):
    """The kernels move the state in 16-byte accesses: a state or
    ``state_out`` view 4 or 8 bytes off a 16-byte boundary is refused
    (``ValueError``, no launch counted), at either kernel's shape."""
    from repro_torch.kernels import ssm_scan
    rng = np.random.default_rng(offset)
    x = _ssm_inputs(rng, 2, s, 4, cuda_device)
    flat = torch.zeros(x[5].numel() + 4, device=cuda_device)
    view = flat[offset // 4:offset // 4 + x[5].numel()].view(x[5].shape)
    view.copy_(x[5])
    state, out = (view, None) if which == "state" else (x[5], view)
    before = ssm_scan.ssm_scan.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        ssm_scan.ssm_scan(*x[:5], state, state_out=out)
    assert ssm_scan.ssm_scan.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("sq", [129, 200, 640, 1152])
def test_flash_kernel_hymba_geometry(cuda_device, sq):
    """hymba-1.5b's prefill at exact lengths (prompt + 128 meta tokens):
    25 query heads over 5 kv heads of 64 and a window of 1024, which cuts
    tiles at 1152 rows."""
    rng = np.random.default_rng(sq)
    q = _cuda_rand(rng, (1, sq, 25, 64), cuda_device)
    k = _cuda_rand(rng, (1, sq, 5, 64), cuda_device)
    v = _cuda_rand(rng, (1, sq, 5, 64), cuda_device)
    got = fa.flash_attention(q, k, v, causal=True, window=1024)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=1024)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("h,kv,window", [(32, 16, 64), (32, 16, None),
                                         (48, 4, 64), (48, 4, None)])
def test_flash_kernel_dense_config_geometry(cuda_device, h, kv, window):
    """gemma3-27b's heads (32 over 16 of 128) and starcoder2-15b's (48 over
    4) at a 300-row prefill, with a window of 64 that cuts tiles and
    without one."""
    rng = np.random.default_rng(h + kv)
    q = _cuda_rand(rng, (1, 300, h, 128), cuda_device)
    k = _cuda_rand(rng, (1, 300, kv, 128), cuda_device)
    v = _cuda_rand(rng, (1, 300, kv, 128), cuda_device)
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def _flash_close(q, k, v, **kw):
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2, msg=lambda m: f"{kw}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("g", [1, 7, 16])
@pytest.mark.parametrize("sq", [1, 15, 63, 65, 127, 640])
def test_flash_wgmma_ragged_edges(cuda_device, d, g, sq):
    """The wgmma kernel's ragged edges, B = 2 over 2 kv heads of G q
    heads each: Sq below, at and past one 64-row tile, against Sk tails
    that are no multiple of it (TMA zero-fills them, the mask hides
    them): causal at Sq = Sk, causal with a q offset of 37 (Sk = Sq +
    37), and not causal over Sk = 2 Sq + 13."""
    rng = np.random.default_rng(1000 * d + 10 * g + sq)
    q = _cuda_rand(rng, (2, sq, 2 * g, d), cuda_device)
    for sk, causal, off in ((sq, True, 0), (sq + 37, True, 37),
                            (2 * sq + 13, False, 0)):
        k = _cuda_rand(rng, (2, sk, 2, d), cuda_device)
        v = _cuda_rand(rng, (2, sk, 2, d), cuda_device)
        _flash_close(q, k, v, causal=causal, q_offset=off)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_wgmma_cross_prefill(cuda_device, d):
    """Not causal, Sq != Sk: a 512-row prompt over 1600 context rows (a
    vision cross layer's), 32 q over 8 kv heads."""
    rng = np.random.default_rng(d)
    q = _cuda_rand(rng, (1, 512, 32, d), cuda_device)
    k = _cuda_rand(rng, (1, 1600, 8, d), cuda_device)
    v = _cuda_rand(rng, (1, 1600, 8, d), cuda_device)
    _flash_close(q, k, v, causal=False)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,h,kv,window", [(512, 28, 4, None),
                                            (1920, 32, 16, 1024)])
def test_flash_member_heads_equal_whole_launch(cuda_device, sq, h, kv,
                                               window):
    """A pod member's heads (14/2 and 7/1 of qwen2-7b's 28/4; 16/8 and 8/4
    of gemma3-27b's 32/16 with its window) equal the whole launch's bit
    for bit: a head's output does not depend on the launch's other
    heads."""
    rng = np.random.default_rng(sq + h)
    q = _cuda_rand(rng, (1, sq, h, 128), cuda_device)
    k = _cuda_rand(rng, (1, sq, kv, 128), cuda_device)
    v = _cuda_rand(rng, (1, sq, kv, 128), cuda_device)
    whole = fa.flash_attention(q, k, v, window=window)
    for shards in (2, 4):
        hm, kvm = h // shards, kv // shards
        for m in range(shards):
            qs, ks = slice(m * hm, (m + 1) * hm), slice(m * kvm, (m + 1) * kvm)
            got = fa.flash_attention(q[:, :, qs].contiguous(),
                                     k[:, :, ks].contiguous(),
                                     v[:, :, ks].contiguous(), window=window)
            assert torch.equal(got, whole[:, :, qs]), (shards, m)


@pytest.mark.gpu
def test_flash_graph_replay_equals_eager(cuda_device):
    """A flash call captured in a CUDA graph (its tensor maps baked for
    the static buffers, as an admission graph bakes them) replays equal
    to the eager call bit for bit, and after new inputs are copied into
    the same buffers, equal to the eager call on those."""
    rng = np.random.default_rng(7)
    shape_q, shape_kv = (1, 300, 28, 128), (1, 300, 4, 128)
    q = _cuda_rand(rng, shape_q, cuda_device)
    k = _cuda_rand(rng, shape_kv, cuda_device)
    v = _cuda_rand(rng, shape_kv, cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):  # warm up off the default stream
        fa.flash_attention(q, k, v, window=100)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = fa.flash_attention.launches
    with torch.cuda.graph(graph):
        out = fa.flash_attention(q, k, v, window=100)
    assert fa.flash_attention.launches == before + 1
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, fa.flash_attention(q, k, v, window=100))
        for x in (q, k, v):
            x.copy_(_cuda_rand(rng, tuple(x.shape), cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("h,kv,s", [(48, 4, 1024), (32, 16, 2048)])
def test_decode_kernel_dense_config_geometry(cuda_device, h, kv, s):
    """The bf16 dense decode kernel at starcoder2-15b's round (G = 12) and
    at gemma3-27b's global layers (G = 2, 2048 rows), mixed cache lengths
    and a free slot past the end."""
    rng = np.random.default_rng(h + s)
    lens = torch.tensor([s, 1, s // 2 + 5, 64, s + 40, 333, 17, s - 1],
                        dtype=torch.int32, device=cuda_device)
    q = _cuda_rand(rng, (8, 1, h, 128), cuda_device)
    kc = _cuda_rand(rng, (8, s, kv, 128), cuda_device)
    vc = _cuda_rand(rng, (8, s, kv, 128), cuda_device)
    torch.testing.assert_close(
        da.decode_attention(q, kc, vc, lens).float(),
        da.decode_attention_plain(q, kc, vc, lens).float(), atol=2e-2,
        rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("case", [  # (B, Sq, Sk, causal, window, q_offset)
    (1, 512, 512, True, None, 0), (2, 37, 37, True, None, 0),
    (1, 1, 1, True, None, 0), (1, 100, 100, True, 8, 0),
    (1, 20, 84, True, None, 64), (2, 40, 70, False, None, 0)])
def test_flash_kernel_small_head_dims(cuda_device, d, case):
    """Flash at head dims 16 (the reduced configs') and 32: causal,
    windowed (the reduced hymba's window of 8), a q offset, non-causal."""
    b, sq, sk, causal, window, off = case
    rng = np.random.default_rng(sq + d)
    q = _cuda_rand(rng, (b, sq, 4, d), cuda_device)
    k = _cuda_rand(rng, (b, sk, 2, d), cuda_device)
    v = _cuda_rand(rng, (b, sk, 2, d), cuda_device)
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=off)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_decode_kernels_small_head_dims(cuda_device, d, bs):
    """All four decode kernels at head dims 16 and 32 (7 and 2 query heads
    per kv head) against their plain versions; each paged kernel bit-equal
    to its dense one at pages of 8, 16 and 32 rows.  At D = 16 an int8 row
    is a single 16-byte piece, so half the warp copies a tile's codes."""
    b, s = 8, 256
    lens = torch.tensor([256, 1, 100, 177, 16, 17, 255, 64],
                        dtype=torch.int32, device=cuda_device)
    for h, n_kv in ((28, 4), (4, 2)):
        rng = np.random.default_rng(d + bs + h)
        q = _cuda_rand(rng, (b, 1, h, d), cuda_device)
        kc = _cuda_rand(rng, (b, s, n_kv, d), cuda_device)
        vc = _cuda_rand(rng, (b, s, n_kv, d), cuda_device)
        k8, ks = _int8_cache(rng, (b, s, n_kv, d), cuda_device)
        v8, vs = _int8_cache(rng, (b, s, n_kv, d), cuda_device)
        (kp, vp), tables = _pooled(rng, (kc, vc), bs, cuda_device)
        pools, tables8 = _pooled(rng, (k8, v8, ks, vs), bs, cuda_device)
        pairs = [
            (da.decode_attention(q, kc, vc, lens),
             da.decode_attention_plain(q, kc, vc, lens)),
            (da.paged_decode_attention(q, kp, vp, tables, lens),
             da.paged_decode_attention_plain(q, kp, vp, tables, lens)),
            (da.decode_attention_quant(q, k8, v8, ks, vs, lens),
             da.decode_attention_quant_plain(q, k8, v8, ks, vs, lens)),
            (da.paged_decode_attention_quant(q, *pools, tables8, lens),
             da.paged_decode_attention_quant_plain(q, *pools, tables8,
                                                   lens))]
        for got, want in pairs:
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                       rtol=2e-2)
        assert torch.equal(pairs[1][0], pairs[0][0])
        assert torch.equal(pairs[3][0], pairs[2][0])
        windowed = da.decode_attention(q, kc, vc, lens, window=8)
        torch.testing.assert_close(
            windowed.float(),
            da.decode_attention_plain(q, kc, vc, lens, window=8).float(),
            atol=2e-2, rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 77, 16, 640])
def test_ssm_kernel_state_size_8(cuda_device, s):
    """The selective scan at the reduced hymba's state size N = 8 (4 heads
    of 16), at a round (the step kernel) and at prefills (the chunked
    kernel: one chunk, ragged, long)."""
    from repro_torch.kernels import ssm_scan
    rng = np.random.default_rng(s)
    b, h, d, n = 2, 4, 16, 8
    x = _cuda_rand(rng, (b, s, h, d), cuda_device)
    dt = torch.nn.functional.softplus(
        _cuda_rand(rng, (b, s, h), cuda_device).float()).to(torch.bfloat16)
    a_log = (_cuda_rand(rng, (h, n), cuda_device).float() * 0.02).to(
        torch.bfloat16)
    bm, cm = (_cuda_rand(rng, (b, s, h, n), cuda_device) for _ in range(2))
    st = torch.from_numpy(rng.normal(size=(b, h, d, n)).astype(
        np.float32)).to(cuda_device)
    y, new = ssm_scan.ssm_scan(x, dt, a_log, bm, cm, st)
    want_y, want_st = ssm_scan.ssm_scan_plain(x, dt, a_log, bm, cm, st)
    torch.testing.assert_close(y.float(), want_y.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(new, want_st, atol=2e-2, rtol=2e-2)


# -- the fused round as a CUDA graph (serving/graphs.py) ----------------------


def _serving_model(arch, device):
    """A model and its weights drawn on the card: ``tiny`` is a 2-layer
    dense config at head dim 16 (the kernels take 16-128), the others a
    reduced config (rwkv6-1.6b, hymba-1.5b, gemma3-27b, qwen2-moe-a2.7b,
    mixtral-8x7b)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig
    cfg = (ModelConfig(name="tiny-dense-d16", family="dense", n_layers=2,
                       d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                       vocab_size=256, vocab_pad_multiple=32,
                       rope_theta=10_000.0)
           if arch == "tiny" else get_config(arch, reduced=True))
    model = build_model(cfg)
    return model, model.init(torch.Generator(device=device).manual_seed(0))


def _graph_engine(model, params, batching, arrivals, max_batch=2, **kw):
    from repro_torch.core.resources import Alloc
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(window=0.1, device="cuda")
    eng.deploy("f", model, params, Alloc(sm=1.0, quota_request=0.9,
                                         quota_limit=0.9),
               batching=batching, max_batch=max_batch, max_len=64,
               block_size=16, **kw)
    reqs = [eng.submit("f", p, max_new_tokens=n) for p, n in arrivals]
    assert eng.pump(budget_s=300.0) == len(reqs)
    assert all(r.done and len(r.tokens_out) == n
               for r, (_, n) in zip(reqs, arrivals))
    return [r.tokens_out for r in reqs], eng


@pytest.mark.gpu
@pytest.mark.parametrize("arch,batching,int8", [
    ("tiny", "continuous", False), ("tiny", "paged", False),
    ("tiny", "continuous", True), ("tiny", "paged", True),
    ("rwkv6-1.6b", "continuous", False), ("hymba-1.5b", "continuous", False),
    ("qwen2-moe-a2.7b", "continuous", False),
    ("qwen2-moe-a2.7b", "paged", True), ("mixtral-8x7b", "continuous", False),
])
def test_round_graph_streams_equal_host_argmax(cuda_device, monkeypatch,
                                               arch, batching, int8):
    """Two instances, mid-flight admission: the graph-backed fused round
    emits the host-argmax reference's streams, each instance runs one
    eager round, captures once and replays every later round."""
    if int8:
        monkeypatch.setenv("REPRO_KV_INT8", "1")
    model, params = _serving_model(arch, cuda_device)
    rng = np.random.default_rng(3)
    vocab = model.cfg.vocab_size
    arrivals = [(rng.integers(0, vocab, l).astype(np.int32), n)
                for l, n in [(5, 6), (20, 9), (17, 3), (9, 12), (30, 5),
                             (12, 7), (3, 10), (24, 4)]]
    graph, eng = _graph_engine(model, params, batching, arrivals,
                               n_instances=2)
    host, ref = _graph_engine(model, params, batching, arrivals,
                              n_instances=2, fused=False)
    assert graph == host
    for inst in eng.instances.values():
        rg = inst.round_graph
        assert inst.kv_int8 == int8 and inst.refills > 0
        assert rg.graph is not None and rg.captures == 1
        assert rg.eager_rounds == 1 and rg.replays == inst.rounds - 1
        assert inst.sync_count == inst.steps
    assert all(i.round_graph is None for i in ref.instances.values())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kernel", [
    ("tiny", "decode_attention"), ("rwkv6-1.6b", "wkv6_step"),
    ("hymba-1.5b", "ssm_step")])
def test_round_graph_captures_once_and_counts_replays(cuda_device, arch,
                                                      kernel):
    """A 20-round decode: one capture, the same graph from the second round
    to the last, and the round's kernel counted once per layer and round
    under replay (prompts of 20 tokens, so no prefill runs a step
    kernel)."""
    from repro_torch import kernels
    from repro_torch.kernels import ssm_scan, wkv6
    model, params = _serving_model(arch, cuda_device)
    rng = np.random.default_rng(4)
    arrivals = [(rng.integers(0, model.cfg.vocab_size, 20).astype(np.int32),
                 21) for _ in range(2)]
    from repro_torch.core.resources import Alloc
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(window=0.1, device="cuda")
    eng.deploy("f", model, params, Alloc(sm=1.0, quota_request=0.9,
                                         quota_limit=0.9),
               max_batch=4, max_len=64)
    for p, n in arrivals:
        eng.submit("f", p, max_new_tokens=n)
    (inst,) = eng.instances.values()
    kernels.reset_launch_counts()
    graphs = []
    while eng.has_work():
        inst.run_step()
        graphs.append(inst.round_graph.graph)
    assert inst.rounds == 20 and inst.prefills == 2
    assert graphs[0] is None and graphs[1] is not None
    assert all(g is graphs[1] for g in graphs[1:])
    assert inst.round_graph.captures == 1 and inst.round_graph.replays == 19
    counts = kernels.launch_counts()
    assert counts[kernel] == model.cfg.n_layers * inst.rounds, counts
    for scan, pair in ((wkv6.wkv6_scan, ("wkv6_chunked", "wkv6_step")),
                       (ssm_scan.ssm_scan, ("ssm_chunked", "ssm_step"))):
        assert scan.launches == sum(counts[k] for k in pair)
    assert eng.telemetry()["f/0"]["replays"] == 19


# -- prefix sharing, migration and close under the graphs ---------------------


def _lifecycle_engine(model, params, batching, **kw):
    from repro_torch.core.resources import Alloc
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(window=0.1, device="cuda")
    eng.deploy("f", model, params, Alloc(sm=1.0, quota_request=0.9,
                                         quota_limit=0.9),
               batching=batching, **{**dict(max_batch=4, max_len=64,
                                            block_size=16), **kw})
    return eng


def _warm_round(eng, vocab):
    """Serve two short requests so that the instance's round graph is
    captured (first round eager, second captured, the rest replayed) and
    bucket 32's prefill graph too; returns the graphs."""
    rng = np.random.default_rng(8)
    _serve_phases(eng, [[(rng.integers(0, vocab, 20).astype(np.int32), 4)
                         for _ in range(2)]])
    (inst,) = eng.instances.values()
    assert inst.round_graph.graph is not None
    assert inst.prefill_graphs.by_bucket[32].graph is not None
    return inst.round_graph.graph, inst.prefill_graphs.by_bucket[32].graph


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_cow_under_replay_keeps_other_blocks(cuda_device, monkeypatch, int8):
    """Three equal 21-token prompts (one full block and a shared tail) on
    an instance whose round graph and bucket-32 prefill graph are
    captured: the first round after admission copies the tail block into
    its spare, eagerly between replays, leaving every other block of
    every leaf bit for bit as it was; later rounds replay the same graph
    and the streams equal the unshared engine's."""
    from repro_torch.models.model import Model
    if int8:
        monkeypatch.setenv("REPRO_KV_INT8", "1")
    model, params = _serving_model("tiny", cuda_device)
    prompt = np.random.default_rng(9).integers(0, 256, 21).astype(np.int32)
    phase = [(prompt.copy(), 6) for _ in range(3)]
    eng = _lifecycle_engine(model, params, "paged")
    graphs = _warm_round(eng, 256)
    (inst,) = eng.instances.values()
    copy_block, copies = Model.copy_block, []

    def checked(self, cache, src, dst):
        torch.cuda.synchronize()
        before = {k: v.clone() for k, v in cache.items()}
        out = copy_block(self, cache, src, dst)
        torch.cuda.synchronize()
        for k, v in cache.items():
            keep = [b for b in range(v.shape[1]) if b != dst]
            assert torch.equal(v[:, keep], before[k][:, keep]), k
            assert torch.equal(v[:, dst], before[k][:, src]), k
        copies.append((src, dst))
        return out

    monkeypatch.setattr(Model, "copy_block", checked)
    rounds = inst.round_graph.replays
    got = _serve_phases(eng, [phase])
    monkeypatch.undo()
    # Each sharer but the last one to write gets its copy.
    assert inst.cow_count == len(copies) == 2 and inst.shared_block_hits == 4
    assert (inst.round_graph.graph, inst.prefill_graphs.by_bucket[32].graph
            ) == graphs
    assert inst.round_graph.captures == 1
    assert inst.round_graph.replays - rounds == 5
    if int8:
        monkeypatch.setenv("REPRO_KV_INT8", "1")
    ref = _lifecycle_engine(model, params, "paged", prefix_sharing=False)
    assert got == _serve_phases(ref, [phase])
    assert inst.allocator.blocks_in_use == 0 and inst.pages.n_spares == 0


@pytest.mark.gpu
@pytest.mark.parametrize("src_batching,dst_batching", [
    ("paged", "paged"), ("continuous", "continuous"),
    ("paged", "continuous"), ("continuous", "paged")])
def test_import_into_a_captured_instance_then_replays(cuda_device,
                                                      src_batching,
                                                      dst_batching):
    """Slots exported mid-decode from one engine and imported into an
    instance whose round graph is captured: the target's later rounds
    are replays of that graph and the streams equal an unmigrated run's.
    A paged export's entry lies wholly on the pools' device (its ``pos``
    too), so a continuous target merges it as it merges a slot's."""
    model, params = _serving_model("tiny", cuda_device)
    rng = np.random.default_rng(10)
    head = rng.integers(0, 256, 32)
    phase = [(np.concatenate([head, rng.integers(0, 256, 5)]).astype(
        np.int32), 9) for _ in range(3)]
    stayed = _serve_phases(_lifecycle_engine(model, params, src_batching,
                                             max_batch=2), [phase])
    src = _lifecycle_engine(model, params, src_batching, max_batch=2)
    dst = _lifecycle_engine(model, params, dst_batching, max_batch=2)
    graphs = _warm_round(dst, 256)
    (inst,), (tgt,) = src.instances.values(), dst.instances.values()
    reqs = [src.submit("f", p, max_new_tokens=n) for p, n in phase]
    inst.run_step()
    inst.run_step()
    replays, rounds = tgt.round_graph.replays, tgt.rounds
    for slot in range(inst.max_batch):
        entry = inst.export_slot(slot)
        assert all(v.device == cuda_device for v in entry[1].values())
        tgt.import_slot(slot, *entry)
        inst.slots[slot] = None
        if src_batching == "paged":
            inst._release_paged(slot)
    tgt.queue.extend(inst.queue)
    inst.queue.clear()
    dst.pump(budget_s=300.0)
    assert all(r.done for r in reqs)
    assert [r.tokens_out for r in reqs] == stayed
    assert (tgt.round_graph.graph, tgt.prefill_graphs.by_bucket[32].graph
            ) == graphs
    assert tgt.round_graph.captures == 1
    assert tgt.round_graph.replays - replays == tgt.rounds - rounds > 0


def _private_pools() -> set:
    """Ids of the graph memory pools that hold a device segment."""
    return {tuple(s["segment_pool_id"]) for s in torch.cuda.memory_snapshot()
            if tuple(s["segment_pool_id"]) != (0, 0)}


@pytest.mark.gpu
@pytest.mark.parametrize("batching", ["continuous", "paged"])
@pytest.mark.parametrize("how", ["retire", "fail"])
def test_close_returns_graph_pools_and_kv_memory(cuda_device, batching, how):
    """After ``retire`` drains an instance (it closes), or after ``fail``,
    ``gc.collect()`` and ``empty_cache()``: none of the memory pools its
    graphs made holds a segment, and the reserved bytes fall by at least
    its KV pool's."""
    import gc
    model, params = _serving_model("tiny", cuda_device)
    _warm_round(_lifecycle_engine(model, params, batching), 256)
    gc.collect()
    torch.cuda.empty_cache()
    pools0 = _private_pools()
    eng = _lifecycle_engine(model, params, batching, max_len=4096,
                            max_batch=16)
    _warm_round(eng, 256)
    (iid, inst), = eng.instances.items()
    kv = sum(v.numel() * v.element_size() for v in inst.cache.values())
    made = inst.pool_ids()  # the KV pools', the round's, the prefills'
    assert len(made) == 3 and made == _private_pools() - pools0
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    if how == "retire":
        eng.retire(iid)
        assert iid not in eng.instances
    else:
        eng.fail()
    del inst
    gc.collect()
    torch.cuda.empty_cache()
    assert not made & _private_pools()
    assert reserved - torch.cuda.memory_reserved() >= kv > 16 << 20


# -- the fleet model store's upload and the frontend's failure -------------


class _Stacked:
    """A stand-in model whose one param leaf is stacked over layers."""

    def param_names(self):
        return {"layers": {"w": ("layers", None, None)}}


def _big_tree(device, layers=32, rows=4096):
    """About 1 GiB of bf16 weights: a copy that takes tens of ms."""
    g = torch.Generator(device=device).manual_seed(0)
    w = torch.randn((layers, rows, 4096), generator=g, device=device)
    return {"layers": {"w": w.to(torch.bfloat16)}}


@pytest.mark.gpu
def test_overlap_upload_equals_blocking_bit_for_bit(cuda_device):
    """Both upload modes give back the staged tree bit for bit: staging
    pins the host buffer, the overlapped copies run on a side stream and
    the current stream waits on their event before it reads them."""
    from repro_torch.serving.modelstore import (_flatten, stage_params,
                                                upload_params)
    model, params = _serving_model("tiny", cuda_device)
    staged = stage_params(model, params)
    assert staged.pinned
    blocking, none = upload_params(staged, mode="blocking")
    overlap, ready = upload_params(staged, mode="overlap")
    assert none is None and ready is not None
    torch.cuda.current_stream().wait_event(ready)
    trees = [_flatten(t) for t in (params, blocking, overlap)]
    assert [p for p, _ in trees[0]] == [p for p, _ in trees[2]]
    for (_, a), (_, b), (_, c) in zip(*trees):
        assert a.dtype == b.dtype == c.dtype and b.device == c.device
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        assert torch.equal(a.view(torch.int16), c.view(torch.int16))


@pytest.mark.gpu
def test_overlap_upload_returns_with_the_copies_in_flight(cuda_device):
    """``upload_params(mode="overlap")`` returns before its event has
    completed: with 50 ms of work queued on the current stream ahead of
    it, the call comes back in a fraction of that, its event still
    pending, and the tree then equals the blocking upload's."""
    import time
    from repro_torch.serving.modelstore import stage_params, upload_params
    params = _big_tree(cuda_device)
    staged = stage_params(_Stacked(), params)
    assert staged.pinned and staged.stacked == [True]
    want, _ = upload_params(staged, mode="blocking")
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # about 50 ms on the current stream
    t0 = time.perf_counter()
    got, ready = upload_params(staged, mode="overlap")
    host_s = time.perf_counter() - t0
    assert not ready.query(), "the upload waited for its copies"
    assert host_s < 0.02, host_s
    torch.cuda.current_stream().wait_event(ready)
    assert torch.equal(got["layers"]["w"].view(torch.int16),
                       want["layers"]["w"].view(torch.int16))


@pytest.mark.gpu
def test_instance_on_in_flight_weights_gives_the_synced_first_tokens(
        cuda_device):
    """A placement sourced through the fleet store (a host hit: an
    overlapped upload still in flight behind queued work) serves the same
    first tokens and streams as an engine deployed on the weights after a
    synchronize: the deploy waits on the upload's event, not the host."""
    from repro_torch.core.resources import Alloc
    from repro_torch.serving import (ClusterFrontend, FleetModelStore,
                                     ServingEngine, stage_params)
    model, params = _serving_model("tiny", cuda_device)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, int(n)).astype(np.int32)
               for n in (5, 20, 33, 9)]
    alloc = Alloc(sm=0.5, quota_request=0.8, quota_limit=0.8)
    torch.cuda.synchronize()
    ref = ServingEngine(window=0.1, device="cuda")
    ref.deploy("f", model, params, alloc, max_batch=4, max_len=64)
    want = [ref.submit("f", p, max_new_tokens=6) for p in prompts]
    ref.pump(budget_s=300.0)
    store = FleetModelStore()
    store.cache(0).put("f", stage_params(model, params))
    fe = ClusterFrontend(n_nodes=1, window=0.1, device="cuda",
                         model_store=store)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # keep the upload in flight
    handle = fe.place_instance("f", model, None, alloc, max_batch=4,
                               max_len=64)
    (event,) = fe.cold_start_events()
    assert handle is not None and event.tier == "host"
    assert event.mode == "overlap" and not event.ready.query()
    got = [fe.submit("f", p, max_new_tokens=6) for p in prompts]
    fe.pump(budget_s=300.0)
    assert [r.tokens_out for r in got] == [r.tokens_out for r in want]
    assert all(len(r.tokens_out) == 6 for r in got)


@pytest.mark.gpu
def test_fail_node_returns_at_least_the_nodes_kv_pools(cuda_device):
    """``ClusterFrontend.fail_node`` on a node with two warm paged
    instances: after ``gc.collect()`` and ``empty_cache()`` the reserved
    bytes fall by at least both instances' KV pools."""
    import gc
    from repro_torch.core.resources import Alloc
    from repro_torch.serving import ClusterFrontend
    model, params = _serving_model("tiny", cuda_device)
    fe = ClusterFrontend(n_nodes=2, window=0.1, device="cuda")
    alloc = Alloc(sm=0.5, quota_request=0.8, quota_limit=0.8)
    for _ in range(2):
        fe.place_instance("f", model, params, alloc, max_batch=16,
                          max_len=4096, batching="paged")
    assert fe.nodes_for("f") == [0]
    rng = np.random.default_rng(8)
    reqs = [fe.submit("f", rng.integers(0, 256, 20).astype(np.int32),
                      max_new_tokens=4) for _ in range(4)]
    fe.pump(budget_s=300.0)
    assert all(r.done for r in reqs)
    kv = sum(v.numel() * v.element_size()
             for inst in fe.engines[0].instances.values()
             for v in inst.cache.values())
    gc.collect()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    assert fe.fail_node(0) == 2 and not fe.placements
    gc.collect()
    torch.cuda.empty_cache()
    assert reserved - torch.cuda.memory_reserved() >= kv > 16 << 20


# -- sampling and speculative decoding under the round graph ------------------


def _spec_engine(model, params, batching, draft_params, k=3, **kw):
    from repro_torch.core.resources import Alloc
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.speculative import SpecConfig
    eng = ServingEngine(window=0.1, device="cuda")
    eng.deploy("f", model, params, Alloc(sm=1.0, quota_request=0.9,
                                         quota_limit=0.9),
               batching=batching, max_batch=4, max_len=64, block_size=16,
               speculate=SpecConfig(draft_cfg=model.cfg, k=k),
               draft_params=draft_params, **kw)
    return eng


@pytest.mark.gpu
@pytest.mark.parametrize("batching", ["continuous", "paged"])
@pytest.mark.parametrize("sampled", [False, True])
def test_spec_round_replay_equals_eager_body(cuda_device, batching,
                                             sampled):
    """A draft-k / verify-1 round captured once and replayed: over one
    state, the replay and the eager round body write the same ``out``,
    ``n_emit``, slot tokens, positions, key, target pools and draft pool,
    bit for bit; every request gets exactly its tokens, one sync a pass,
    every round after the second a replay."""
    from repro_torch.serving.speculative import SamplingConfig
    model, params = _serving_model("tiny", cuda_device)
    draft = model.init(torch.Generator(device=cuda_device).manual_seed(9))
    sampling = (SamplingConfig(temperature=0.8, top_k=50, top_p=0.9, seed=5)
                if sampled else None)
    eng = _spec_engine(model, params, batching, draft, sampling=sampling)
    rng = np.random.default_rng(5)
    reqs = [eng.submit("f", rng.integers(0, 256, 20).astype(np.int32),
                       max_new_tokens=24) for _ in range(4)]
    (inst,) = eng.instances.values()
    for _ in range(3):  # admissions + eager round, capture, replay
        inst.run_step()
    rg = inst.round_graph
    assert rg.captures == 1 and rg.replays == 2 and inst.n_active() == 4

    def state():
        bufs = {"tok": inst._slot_tok_dev, "out": inst._out_dev,
                "n_emit": inst._n_emit_dev, "key": inst._key_dev,
                **{f"pool {k}": v for k, v in inst.cache.items()},
                **{f"draft {k}": v for k, v in inst.dcache.items()}}
        if batching == "paged":
            bufs["pos"] = inst._pos_dev
        return bufs

    start = {k: v.clone() for k, v in state().items()}
    rg.replay()
    replayed = {k: v.clone() for k, v in state().items()}
    for k, v in state().items():
        v.copy_(start[k])
    inst._round_body()
    torch.cuda.synchronize()
    diff = [k for k, v in state().items() if not torch.equal(v, replayed[k])]
    assert not diff, diff
    assert not torch.equal(start["key"], replayed["key"])
    for k, v in state().items():  # back to the state the instance expects
        v.copy_(start[k])
    assert eng.pump(budget_s=120.0) == 4
    assert all(r.done and len(r.tokens_out) == 24 for r in reqs)
    # Every round after the first was a replay, plus the one above.
    assert rg.captures == 1 and rg.replays == inst.rounds
    assert inst.sync_count == inst.steps and inst.spec_proposed > 0
    assert inst.spec_accepted < inst.spec_proposed


@pytest.mark.gpu
@pytest.mark.parametrize("arch,batching", [
    ("tiny", "continuous"), ("tiny", "paged"),
    ("rwkv6-1.6b", "continuous"), ("hymba-1.5b", "continuous")])
def test_sampled_graph_streams_equal_host_reference(cuda_device, arch,
                                                    batching):
    """Temperature 0.8, top-k 50, top-p 0.9, seed 5: the graph-backed
    sampled round gives a ``fused=False`` engine's streams bit for bit
    (the same key stream), with one sync a pass and one capture."""
    from repro_torch.serving.speculative import SamplingConfig
    model, params = _serving_model(arch, cuda_device)
    rng = np.random.default_rng(6)
    vocab = model.cfg.vocab_size
    arrivals = [(rng.integers(0, vocab, l).astype(np.int32), n)
                for l, n in [(5, 6), (20, 9), (17, 3), (9, 12), (30, 5)]]
    sampling = SamplingConfig(temperature=0.8, top_k=50, top_p=0.9, seed=5)
    graph, eng = _graph_engine(model, params, batching, arrivals,
                               sampling=sampling)
    host, _ = _graph_engine(model, params, batching, arrivals,
                            sampling=sampling, fused=False)
    greedy, _ = _graph_engine(model, params, batching, arrivals)
    assert graph == host and graph != greedy
    (inst,) = eng.instances.values()
    assert inst.round_graph.captures == 1
    assert inst.round_graph.replays == inst.rounds - 1
    assert inst.sync_count == inst.steps


@pytest.mark.gpu
def test_sampler_distribution_on_the_card(cuda_device):
    """``tests/test_sampling.py``'s banded frequency check with the
    sampler on the card: 4000 rows, one draw a row."""
    from repro_torch.kernels import keys, ops
    rng = np.random.default_rng(11)
    vocab, n = 8, 4000
    logits = np.zeros((1, vocab), np.float32)
    logits[0, :5] = rng.normal(size=5).astype(np.float32) * 1.5
    logits[0, 5:] = -50.0
    rows = torch.from_numpy(np.repeat(logits, n, 0)).to(cuda_device)
    toks = ops.sample_tokens(rows, keys.new_key(11, cuda_device), vocab,
                             temperature=1.0, top_k=6, top_p=0.95)
    assert toks.device.type == "cuda"
    freq = np.bincount(toks.cpu().numpy(), minlength=vocab) / n
    filt = ops._filtered_logits(torch.from_numpy(logits), vocab, 1.0, 6,
                                0.95)
    p = torch.softmax(filt.double(), -1).numpy()[0]
    tol = np.maximum(5.0 * np.sqrt(p * (1 - p) / n), 0.02)
    assert np.all(np.abs(freq - p) <= tol), (freq, p)


@pytest.mark.gpu
def test_key_stream_bits_equal_the_cpus(cuda_device):
    """The counter hash gives the card the CPU's bits: keys, splits, words
    and uniforms equal; Gumbel noise within float32 rounding of log."""
    from repro_torch.kernels import keys
    for seed in (0, 5, 2**40 + 3):
        cpu, gpu = keys.new_key(seed), keys.new_key(seed, cuda_device)
        assert torch.equal(gpu.cpu(), cpu)
        assert torch.equal(keys.split(gpu, 7).cpu(), keys.split(cpu, 7))
        ctr = torch.arange(1 << 20)
        assert torch.equal(keys.bits(gpu, ctr.to(cuda_device)).cpu(),
                           keys.bits(cpu, ctr))
        shape = (8, 152064)  # a qwen2-7b round's logits
        assert torch.equal(keys.uniform(gpu, shape).cpu(),
                           keys.uniform(cpu, shape))
        torch.testing.assert_close(keys.gumbel(gpu, shape).cpu(),
                                   keys.gumbel(cpu, shape), atol=1e-5,
                                   rtol=1e-6)
        a, b = cpu.clone(), gpu.clone()
        subs = [(keys.advance(a), keys.advance(b).cpu()) for _ in range(8)]
        assert all(torch.equal(x, y) for x, y in subs)


@pytest.mark.gpu
def test_round_graph_capture_failure_raises(cuda_device, monkeypatch):
    """A round that syncs the host cannot be captured: the second round
    raises, the launch counters are left as they were, the instance
    serves no further round, eagerly or otherwise, and it can be
    dropped.  Near the end of the file, as the prefill's counterpart
    after it: each leaves a failed capture behind."""
    from repro_torch import kernels
    from repro_torch.models.model import Model
    model, params = _serving_model("tiny", cuda_device)
    from repro_torch.core.resources import Alloc
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(window=0.1, device="cuda")
    eng.deploy("f", model, params, Alloc(sm=1.0, quota_request=0.9,
                                         quota_limit=0.9), max_len=64)
    eng.submit("f", np.arange(8, dtype=np.int32), max_new_tokens=6)
    (inst,) = eng.instances.values()
    inst.run_step()  # admission and the eager first round
    step = Model.decode_step_tokens

    def syncing(self, *args):
        tok, cache = step(self, *args)
        tok[0].item()  # a host sync inside the round
        return tok, cache

    monkeypatch.setattr(Model, "decode_step_tokens", syncing)
    before = kernels.counter_values()
    with pytest.raises(RuntimeError):
        inst.run_step()
    assert kernels.counter_values() == before
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="never falls back"):
        inst.run_step()
    rg = inst.round_graph
    assert rg.graph is None and rg.eager_rounds == 1 and rg.replays == 0
    assert torch.ones(4, device=cuda_device).sum().item() == 4.0
    # The dead instance can be dropped: its KV pools' memory pool tears
    # down (a per-pool emptyCache) with no capture left under way in the
    # allocator, where it would abort the process.
    import gc
    del eng, inst, rg
    gc.collect()
    torch.cuda.empty_cache()


# -- the bucketed admission as CUDA graphs (serving/graphs.py) ----------------


def _admission_engine(model, params, batching, **kw):
    from repro_torch.core.resources import Alloc
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(window=0.1, device="cuda")
    eng.deploy("f", model, params, Alloc(sm=1.0, quota_request=0.9,
                                         quota_limit=0.9),
               batching=batching, max_batch=4, max_len=64, block_size=16,
               **kw)
    return eng


def _serve_phases(eng, phases):
    """Serve each phase's (prompt, new tokens) to completion in turn."""
    out = []
    for phase in phases:
        reqs = [eng.submit("f", p, max_new_tokens=n) for p, n in phase]
        assert eng.pump(budget_s=300.0) == len(reqs)
        out += [r.tokens_out for r in reqs]
    return out


GRAPH_MODES = [("continuous", False), ("paged", False),
               ("continuous", True), ("paged", True)]


@pytest.mark.gpu
@pytest.mark.parametrize("batching,int8", GRAPH_MODES)
def test_prefill_replay_equals_eager_bit_for_bit(cuda_device, monkeypatch,
                                                 batching, int8):
    """From one state, a replayed admission of bucket 16 and the eager body
    on the same argument buffer give the same logits row, pools, slot
    tokens and pending tokens, bit for bit (paged: every block but the
    sink, whose last writer among the blocks sent there is not fixed); a
    second capture of the bucket raises."""
    import functools
    from repro_torch.serving.engine import _LEN, _ORD, _ROW, _SLOT
    if int8:
        monkeypatch.setenv("REPRO_KV_INT8", "1")
    model, params = _serving_model("tiny", cuda_device)
    eng = _admission_engine(model, params, batching)
    rng = np.random.default_rng(5)
    for n in (11, 13):  # bucket 16: the first eager, the second captured
        eng.submit("f", rng.integers(0, 256, n).astype(np.int32),
                   max_new_tokens=8)
    (inst,) = eng.instances.values()
    inst.run_step()
    graph = inst.prefill_graphs.by_bucket[16]
    assert (graph.eager_rounds, graph.captures, graph.replays) == (1, 1, 1)
    args = torch.zeros(inst._args.shape, dtype=torch.int64)
    args[_LEN], args[_SLOT], args[_ORD] = 14, 1, 0
    args[inst._tok0:inst._tok0 + 14] = torch.from_numpy(
        rng.integers(0, 256, 14))
    if batching == "paged":
        held = len(inst.pages.blocks(1))
        args[_ROW:inst._tok0] = torch.from_numpy(np.where(
            np.arange(inst.blocks_per_seq) < held, inst._tables[1],
            inst.allocator.n_blocks))
    inst._args.copy_(args)
    live = {"tok": inst._slot_tok_dev, "pending": inst._pending_dev,
            **inst.cache}
    start = {k: v.clone() for k, v in live.items()}
    body = functools.partial(inst._admission_body, 16, True)
    replayed = inst.prefill_graphs.run(16, body).clone()
    after_replay = {k: v.clone() for k, v in live.items()}
    for k, v in start.items():
        live[k].copy_(v)
    eager = body()
    torch.cuda.synchronize()
    assert graph.replays == 2 and graph.eager_rounds == 1
    assert torch.equal(replayed, eager)
    for k, v in live.items():
        cut = (slice(None), slice(inst.allocator.n_blocks)) if (
            batching == "paged" and k not in ("tok", "pending")) else ...
        assert torch.equal(after_replay[k][cut], v[cut]), k
    assert not torch.equal(after_replay["k"], start["k"])
    with pytest.raises(RuntimeError, match="captured once already"):
        graph.capture(body)


@pytest.mark.gpu
@pytest.mark.parametrize("batching,int8", GRAPH_MODES)
def test_prefill_graphs_streams_equal_host_argmax(cuda_device, monkeypatch,
                                                  batching, int8):
    """Buckets 8, 16 and 32 captured in that order on one shared pool, then
    replayed out of it (32, 8, 8, 16) in one pass: two replays of bucket 8
    before the pass's one sync, one of them a request done at prefill.
    Streams equal the host-argmax engine's; each bucket captures once and
    every admission of the second phase is a replay."""
    from repro_torch import kernels
    if int8:
        monkeypatch.setenv("REPRO_KV_INT8", "1")
    model, params = _serving_model("tiny", cuda_device)
    rng = np.random.default_rng(6)

    def prompts(spec):
        return [(rng.integers(0, 256, l).astype(np.int32), n)
                for l, n in spec]

    phases = [prompts([(5, 3), (7, 3), (12, 3), (14, 3), (20, 3), (30, 3)]),
              prompts([(25, 4), (6, 1), (8, 5), (10, 3)])]
    eng = _admission_engine(model, params, batching)
    (inst,) = eng.instances.values()
    got = _serve_phases(eng, phases[:1])
    pg = inst.prefill_graphs
    assert sorted(pg.by_bucket) == [8, 16, 32]
    assert pg.captures == 3 and pg.eager == 3
    graphs = {b: g.graph for b, g in pg.by_bucket.items()}
    replays, steps = pg.replays, inst.steps
    kernels.reset_launch_counts()
    got += _serve_phases(eng, phases[1:])
    assert pg.replays - replays == 4 and pg.captures == 3 and pg.eager == 3
    assert {b: g.graph for b, g in pg.by_bucket.items()} == graphs
    flash = kernels.launch_counts()["flash_attention"]
    assert flash == model.cfg.n_layers * 4
    ref = _admission_engine(model, params, batching, fused=False)
    assert got == _serve_phases(ref, phases)
    assert inst.sync_count == inst.steps and inst.steps > steps
    tel = eng.telemetry()["f/0"]
    assert (tel["prefill_captures"], tel["prefill_replays"]) == (3, 7)


@pytest.mark.gpu
def test_prefill_capture_failure_raises(cuda_device, monkeypatch):
    """An admission that syncs the host cannot be captured: the bucket's
    second admission raises, the launch counters are left as they were,
    and a later admission of that bucket raises too, with no eager
    fallback.  Last in the file: it leaves a failed capture behind."""
    from repro_torch import kernels
    from repro_torch.models.model import Model
    model, params = _serving_model("tiny", cuda_device)
    eng = _admission_engine(model, params, "continuous")
    (inst,) = eng.instances.values()
    eng.submit("f", np.arange(8, dtype=np.int32), max_new_tokens=4)
    inst.run_step()  # the bucket's eager admission and round
    prefill = Model.prefill

    def syncing(self, *args, **kw):
        logits, cache = prefill(self, *args, **kw)
        logits[0, 0].item()  # a host sync inside the admission
        return logits, cache

    monkeypatch.setattr(Model, "prefill", syncing)
    eng.submit("f", np.arange(7, dtype=np.int32), max_new_tokens=4)
    before = kernels.counter_values()
    with pytest.raises(RuntimeError):
        inst.run_step()
    assert kernels.counter_values() == before
    monkeypatch.undo()
    eng.submit("f", np.arange(6, dtype=np.int32), max_new_tokens=4)
    with pytest.raises(RuntimeError, match="never falls back"):
        inst._admit_fused(2, inst.queue.popleft(), False)
    graph = inst.prefill_graphs.by_bucket[8]
    assert graph.graph is None and graph.eager_rounds == 1
    assert graph.replays == 0 and graph.captures == 1
    assert torch.ones(4, device=cuda_device).sum().item() == 4.0


@pytest.mark.gpu
def test_sampled_round_capture_failure_raises(cuda_device, monkeypatch):
    """A sampled round that syncs the host cannot be captured either: the
    second round raises, the counters stay, and the next round raises
    with no eager fallback.  Last in the file, after the prefill's: it
    leaves a failed capture behind."""
    from repro_torch import kernels
    from repro_torch.core.resources import Alloc
    from repro_torch.models.model import Model
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.speculative import SamplingConfig
    model, params = _serving_model("tiny", cuda_device)
    eng = ServingEngine(window=0.1, device="cuda")
    eng.deploy("f", model, params, Alloc(sm=1.0, quota_request=0.9,
                                         quota_limit=0.9), max_len=64,
               sampling=SamplingConfig(temperature=0.8, seed=5))
    eng.submit("f", np.arange(8, dtype=np.int32), max_new_tokens=6)
    (inst,) = eng.instances.values()
    inst.run_step()  # admission and the eager first round
    step = Model.decode_step_tokens

    def syncing(self, *args):
        out = step(self, *args)
        out[0][0].item()  # a host sync inside the round
        return out

    monkeypatch.setattr(Model, "decode_step_tokens", syncing)
    before = kernels.counter_values()
    with pytest.raises(RuntimeError):
        inst.run_step()
    assert kernels.counter_values() == before
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match="never falls back"):
        inst.run_step()
    assert inst.round_graph.graph is None and inst.round_graph.replays == 0


# -- gemma3's dual caches on the card -------------------------------------------


@pytest.mark.gpu
def test_gemma3_geometry_model_matches_cpu(cuda_device):
    """A 6-layer GeGLU model on dual caches with gemma3-27b's heads (32 q /
    16 kv of 128, q_dim 4096 != d_model 512), tied and scaled embeddings,
    5 local layers of window 32 and 1 global: a 90-token prefill past the
    window and 3 decode steps in bf16 on the card through the kernels,
    against the same weights in f32 on the CPU, within 5e-2 of the largest
    logit (``chip_smoke.REF_TOL``: bf16 weights and activations against
    f32)."""
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.models import build_model
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="gemma3-heads", family="dense", n_layers=6,
                      d_model=512, n_heads=32, n_kv_heads=16, head_dim=128,
                      d_ff=1024, vocab_size=512, mlp="geglu",
                      rope_theta=1e6, tie_embeddings=True, embed_scale=True,
                      sliding_window=32, local_global_ratio=5)
    model = build_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for leaf in p_cpu["layers"].values():  # the zero-initialised norms
        if isinstance(leaf, torch.Tensor):
            leaf.copy_(torch.randn(leaf.shape, generator=gen) * 0.1)
    p_gpu, p_ref = _to(p_cpu, cuda_device), _to(p_cpu, None, torch.float32)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, 512, (1, 90)).astype(np.int32))

    def close(got, want):
        rel = (got.float().cpu() - want).abs().max() / want.abs().max()
        assert torch.isfinite(got).all() and rel < 5e-2, rel

    before = dmod.decode_attention.launches
    lg, cg = model.prefill(p_gpu, prompt.to(cuda_device), max_len=128)
    lr, cr = model.prefill(p_ref, prompt, max_len=128)
    close(lg, lr)
    assert cg["k"].shape[2] == 32 and cg["global_k"].shape[:3] == (1, 1, 128)
    tok = model.sample_greedy(lr)
    for _ in range(3):
        lg, cg = model.decode_step(p_gpu, tok.to(cuda_device), cg)
        lr, cr = model.decode_step(p_ref, tok, cr)
        close(lg, lr)
        tok = model.sample_greedy(lr)
    assert dmod.decode_attention.launches == before + 3  # the global layer


def _to(tree, device, dtype=None):
    if isinstance(tree, dict):
        return {k: _to(v, device, dtype) for k, v in tree.items()}
    return tree.to(device=device, dtype=dtype)


@pytest.mark.gpu
def test_gemma3_reduced_round_replay_equals_eager_body(cuda_device):
    """gemma3-27b's reduced config (window 8, 2 global layers of 6), four
    live slots with prompts past the window: the captured round, replayed,
    and the eager round body over the same state write the same slot
    tokens, positions, rolled ``k``/``v`` and ``global_k``/``global_v``,
    bit for bit; later rounds replay and the streams equal a
    ``fused=False`` engine's."""
    model, params = _serving_model("gemma3-27b", cuda_device)
    rng = np.random.default_rng(8)
    arrivals = [(rng.integers(0, 256, l).astype(np.int32), 12)
                for l in (5, 13, 20, 9)]
    from repro_torch.core.resources import Alloc
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(window=0.1, device="cuda")
    eng.deploy("f", model, params, Alloc(sm=1.0, quota_request=0.9,
                                         quota_limit=0.9),
               max_batch=4, max_len=64)
    reqs = [eng.submit("f", p, max_new_tokens=n) for p, n in arrivals]
    (inst,) = eng.instances.values()
    for _ in range(3):  # admissions + eager round, capture, replay
        inst.run_step()
    rg = inst.round_graph
    assert rg.captures == 1 and rg.replays == 2 and inst.n_active() == 4
    assert set(inst.cache) == {"k", "v", "global_k", "global_v", "pos"}

    def state():
        return {"tok": inst._slot_tok_dev, **inst.cache}

    start = {k: v.clone() for k, v in state().items()}
    rg.replay()
    replayed = {k: v.clone() for k, v in state().items()}
    for k, v in state().items():
        v.copy_(start[k])
    inst._round_body()
    torch.cuda.synchronize()
    assert not [k for k, v in state().items()
                if not torch.equal(v, replayed[k])]
    assert not [k for k in inst.cache
                if torch.equal(start[k], replayed[k])]
    for k, v in state().items():  # back to the state the instance expects
        v.copy_(start[k])
    assert eng.pump(budget_s=120.0) == 4
    assert rg.captures == 1 and rg.replays == inst.rounds
    host, _ = _graph_engine(model, params, "continuous", arrivals,
                            fused=False, max_batch=4)
    assert [r.tokens_out for r in reqs] == host


# -- the MoE block: deterministic, captured, routed as on the CPU -------------


def _moe_block(device):
    """One expert block with qwen2-moe-a2.7b's routing (60 experts, top-4,
    4 shared) at d = 256, expert d_ff 128, on ``device``: (cfg, params)."""
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.layers import init_params
    cfg = ModelConfig(name="moe-block", family="moe", n_layers=1,
                      d_model=256, n_heads=2, n_kv_heads=2, d_ff=128,
                      vocab_size=256, n_experts=60, top_k=4,
                      n_shared_experts=4, moe_d_ff=128)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, init_params(moe.moe_specs(cfg), gen)


MOE_SHAPES = [(8, 1, 2.0), (8, 5, 2.0), (1, 512, 0.5), (1, 512, 2.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,cf", MOE_SHAPES)
def test_moe_apply_eager_twice_bit_equal(cuda_device, b, s, cf):
    """A decode round (8 tokens), a verify window (8 x 5) and a 512-token
    prefill, with and without drops: two eager calls on the same inputs
    give the same output bit for bit (no float atomics in the combine)."""
    from repro_torch.models import moe
    cfg, params = _moe_block(cuda_device)
    x = _cuda_rand(np.random.default_rng(b * s), (b, s, cfg.d_model),
                   cuda_device)
    y1, aux1 = moe.moe_apply(params, x, cfg, cf)
    y2, aux2 = moe.moe_apply(params, x, cfg, cf)
    assert torch.isfinite(y1.float()).all()
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,cf", MOE_SHAPES)
def test_moe_apply_captures_and_replay_equals_eager(cuda_device, b, s, cf):
    """The block captures into a CUDA graph (no host sync, no
    data-dependent shape) and a replay on new inputs equals the eager
    call on them bit for bit."""
    from repro_torch.models import moe
    from repro_torch.serving.graphs import RoundGraph
    cfg, params = _moe_block(cuda_device)
    rng = np.random.default_rng(s)
    x = _cuda_rand(rng, (b, s, cfg.d_model), cuda_device)
    out = torch.empty_like(x)

    def body():
        return out.copy_(moe.moe_apply(params, x, cfg, cf)[0])

    rg = RoundGraph(cuda_device)
    rg.run(body)  # eager
    rg.run(body)  # captured, replayed
    x.copy_(_cuda_rand(rng, (b, s, cfg.d_model), cuda_device))
    rg.replay()
    torch.cuda.synchronize()
    want = moe.moe_apply(params, x, cfg, cf)[0]
    assert rg.captures == 1 and rg.replays == 2
    assert torch.equal(out, want)


@pytest.mark.gpu
@pytest.mark.parametrize("cf", [0.5, 2.0])
def test_moe_routing_equals_cpu(cuda_device, cf):
    """512 tokens with integer features and an integer router, so the
    logits are exact on both devices and ties are common: the card's
    ``top_e``, ``dest`` and ``keep`` equal the CPU's as integers (drops at
    capacity factor 0.5), and its bf16 output is within 2e-2 of the
    CPU's f32 run on the same weights."""
    from repro_torch.models import moe
    cfg, params = _moe_block(cuda_device)
    rng = np.random.default_rng(12)
    x_np = rng.integers(-2, 3, (1, 512, cfg.d_model)).astype(np.float32)
    router = rng.integers(-3, 4, (cfg.d_model, cfg.n_experts))
    params["router"] = torch.as_tensor(router, dtype=torch.float32,
                                       device=cuda_device)
    x = torch.as_tensor(x_np, device=cuda_device).to(torch.bfloat16)
    cpu = {k: (v.cpu().float() if torch.is_tensor(v) else
               {k2: v2.cpu().float() for k2, v2 in v.items()})
           for k, v in params.items()}
    cap = moe._capacity(512, cfg, cf)
    got = moe.route(params["router"], x[0], cfg, cap)
    want = moe.route(cpu["router"], torch.from_numpy(x_np[0]), cfg, cap)
    for key in ("top_e", "dest", "keep"):
        assert torch.equal(got[key].cpu(), want[key]), key
    assert (not want["keep"].all()) == (cf < 1)
    y = moe.moe_apply(params, x, cfg, cf)[0].float().cpu()
    ref = moe.moe_apply(cpu, torch.from_numpy(x_np), cfg, cf)[0]
    assert torch.isfinite(y).all()
    assert ((y - ref).abs().max() / ref.abs().max()).item() < 2e-2


# -- the encoder-decoder and vision families: non-causal flash over a
#    context, decode over a full context cache, the round under a graph ----


@pytest.mark.gpu
@pytest.mark.parametrize("sq,sk,h,kv,d", [
    (1024, 1024, 16, 16, 64),  # seamless's encoder (bidirectional)
    (512, 1024, 16, 16, 64),   # seamless's cross prefill, G = 1
    (512, 1600, 32, 8, 128),   # vision's cross prefill, 25 tiles of 64
    (9, 12, 4, 4, 16),         # the reduced configs: a sub-tile context
    (9, 12, 4, 2, 16)])
def test_flash_kernel_non_causal_context(cuda_device, sq, sk, h, kv, d):
    """Flash with ``causal=False`` over a context whose length differs
    from the query's (the encoder's own 1024 rows too), at the full
    configs' heads and the reduced ones' 12-row context."""
    rng = np.random.default_rng(sq + sk + d)
    q = _cuda_rand(rng, (1, sq, h, d), cuda_device)
    k = _cuda_rand(rng, (1, sk, kv, d), cuda_device)
    v = _cuda_rand(rng, (1, sk, kv, d), cuda_device)
    got = fa.flash_attention(q, k, v, causal=False)
    want = fa.flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("s,h,kv,d", [(12, 4, 2, 16), (1024, 16, 16, 64),
                                      (1600, 32, 8, 128)])
def test_decode_kernel_full_context_cache(cuda_device, s, h, kv, d):
    """The dense decode kernel with every row at ``cache_len = S``, as a
    cross layer attends its context cache each round: the reduced
    configs' 12 rows (under one tile), seamless's 1024 (G = 1) and
    vision's 1600 (G = 4), B = 8."""
    rng = np.random.default_rng(s + d)
    q = _cuda_rand(rng, (8, 1, h, d), cuda_device)
    kc = _cuda_rand(rng, (8, s, kv, d), cuda_device)
    vc = _cuda_rand(rng, (8, s, kv, d), cuda_device)
    lens = torch.full((8,), s, dtype=torch.int32, device=cuda_device)
    torch.testing.assert_close(
        da.decode_attention(q, kc, vc, lens).float(),
        da.decode_attention_plain(q, kc, vc, lens).float(), atol=2e-2,
        rtol=2e-2)


@pytest.mark.gpu
def test_vlm_reduced_round_replay_equals_eager_body(cuda_device):
    """llama-3.2-vision's reduced config (a cross layer after every 2 of 4
    self layers), gates and norms filled, three live slots of four with
    their own contexts: the round captured through ``RoundGraph`` and
    replayed, and the eager round over the same state, write the same
    slot tokens, positions, ``k`` and ``v`` bit for bit and leave
    ``cross_k``/``cross_v`` as prefill wrote them; the round launches the
    decode kernel 4 + 2 times."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.graphs import RoundGraph

    model = build_model(get_config("llama-3.2-vision-11b", reduced=True))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = model.init(gen)
    for leaf in (params["cross_layers"]["gate_attn"],
                 params["cross_layers"]["gate_mlp"]):
        leaf.fill_(0.7)
    cfg = model.cfg
    rng = np.random.default_rng(4)
    pool = model.init_slot_cache(4, 64, cuda_device)
    tok = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    for slot, n in ((0, 5), (1, 17), (3, 9)):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                                 dtype=torch.int32, device=cuda_device)
        ctx = _cuda_rand(rng, (1, cfg.n_context_tokens, cfg.d_model),
                         cuda_device)
        logits, entry = model.prefill(params, prompt, max_len=64, ctx=ctx)
        model.merge_slot(pool, entry, slot)
        tok[slot] = model.sample_greedy(logits)[0]

    def body():
        new, advanced = model.decode_step_tokens(params, tok, pool)
        pool["pos"].copy_(advanced["pos"])
        return tok.copy_(new)

    rg = RoundGraph(cuda_device)
    for _ in range(3):  # eager, captured and replayed, replayed
        rg.run(body)
    assert rg.captures == 1 and rg.replays == 2

    def state():
        return {"tok": tok, **pool}

    start = {k: v.clone() for k, v in state().items()}
    kernels.reset_launch_counts()
    rg.replay()
    assert kernels.launch_counts()["decode_attention"] == 6
    replayed = {k: v.clone() for k, v in state().items()}
    for k, v in state().items():
        v.copy_(start[k])
    body()
    torch.cuda.synchronize()
    assert not [k for k, v in state().items()
                if not torch.equal(v, replayed[k])]
    assert [k for k in pool if torch.equal(start[k], replayed[k])] == \
        ["cross_k", "cross_v"]


# -- sharded pods on the card --------------------------------------------------


def _pod_streams(device, shards, batching, sampling=None, arch="qwen2-7b"):
    """``arch``'s smoke cut (qwen2-7b's: 4 q over 2 kv heads of 16) served
    through ``ClusterFrontend(n_nodes=4)`` on the card as a
    ``shards``-member pod, under the int8 gate as the caller set it;
    returns (streams, instance)."""
    from repro_torch.configs import get_config
    from repro_torch.core.resources import Alloc
    from repro_torch.models import build_model
    from repro_torch.serving import ClusterFrontend

    model = build_model(get_config(arch, reduced=True))
    params = model.init(torch.Generator(device=device).manual_seed(0))
    fe = ClusterFrontend(n_nodes=4, device=device)
    fe.place_instance("f", model, params,
                      Alloc(sm=0.25, quota_request=0.5, quota_limit=1.0),
                      max_batch=4, max_len=64, batching=batching,
                      sampling=sampling, shards=shards)
    rng = np.random.default_rng(3)
    reqs = [fe.submit("f", rng.integers(0, 256, n).astype(np.int32),
                      max_new_tokens=8) for n in (5, 17, 30, 9, 12)]
    fe.pump(budget_s=120.0)
    assert all(r.done for r in reqs)
    (p,) = fe.placements
    return [r.tokens_out for r in reqs], fe.engines[p.node].instances[
        p.inst_id]


@pytest.mark.gpu
@pytest.mark.parametrize("batching", ["continuous", "paged"])
@pytest.mark.parametrize("shards", [2, 4])
def test_pod_streams_equal_one_instance_on_the_card(cuda_device, batching,
                                                    shards):
    """A pod whose members share the card serves one instance's greedy and
    sampled streams at the smoke cut's small widths (bf16), its rounds
    replayed from one captured graph: split heads at 2 members, the
    replicated pool at 4."""
    from repro_torch.serving.speculative import SamplingConfig

    for sampling in (None, SamplingConfig(temperature=0.8, top_k=8,
                                          seed=7)):
        one, _ = _pod_streams(cuda_device, 1, batching, sampling)
        pod, inst = _pod_streams(cuda_device, shards, batching, sampling)
        assert pod == one
        rg = inst.round_graph
        assert inst.group.one_device and rg.captures == 1
        assert rg.replays == inst.rounds - 1


def _pod_replay_equals_eager(inst) -> None:
    """Four more requests admitted and a round run, then the pod's round
    replayed from its graph and its eager body run from the same state:
    bit for bit over the slot tokens and every member's pool leaves
    (paged: its pages, and the shared page tables, positions and active
    mask)."""
    from repro_torch.serving.engine import ServeRequest

    rng = np.random.default_rng(4)
    for n in (6, 11, 20, 3):
        inst.queue.append(ServeRequest(
            req_id=n, prompt=rng.integers(0, 256, n).astype(np.int32),
            max_new_tokens=12))
    for _ in range(2):
        inst.run_step()

    def state():
        out = {"tok": inst._slot_tok_dev, **{
            f"{m}{k}": v for m, pool in enumerate(inst.cache)
            for k, v in pool.items()}}
        if inst.batching == "paged":
            out["paged state"] = inst._state_dev
        return out

    start = {k: v.clone() for k, v in state().items()}
    inst.round_graph.replay()
    replayed = {k: v.clone() for k, v in state().items()}
    for k, v in state().items():
        v.copy_(start[k])
    inst._round_body()
    torch.cuda.synchronize()
    assert all(torch.equal(v, replayed[k]) for k, v in state().items())


@pytest.mark.gpu
@pytest.mark.parametrize("batching", ["continuous", "paged"])
def test_pod_round_replay_equals_eager_body(cuda_device, batching):
    """A 2-member pod's replayed round equals its eager round body bit for
    bit over the slot tokens and every member's pool leaves."""
    _, inst = _pod_streams(cuda_device, 2, batching)
    _pod_replay_equals_eager(inst)


POD_KINDS = [("qwen2-7b", True, "continuous"), ("qwen2-7b", True, "paged"),
             ("gemma3-27b", False, "continuous"),
             ("mixtral-8x7b", False, "continuous"),
             ("qwen2-moe-a2.7b", False, "continuous"),
             ("qwen2-moe-a2.7b", False, "paged")]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,int8,batching", POD_KINDS,
                         ids=[f"{a}-{'int8-' if q else ''}{b}"
                              for a, q, b in POD_KINDS])
def test_pod_families_on_the_card(cuda_device, monkeypatch, arch, int8,
                                  batching):
    """int8 KV, gemma3's dual caches, mixtral's rolled moe and qwen2-moe as
    pods on the card at their smoke cuts (bf16 weights): greedy streams
    at 1, 2 and 4 members equal, every pod's round one capture; each
    member's int8 codes and scales tensors of their own, every layer's
    view on a 16-byte boundary (the int8 kernels' rule); a 2-member pod's
    replayed round equal to its eager body over every member's pool."""
    monkeypatch.setenv("REPRO_KV_INT8", "1" if int8 else "0")
    one, _ = _pod_streams(cuda_device, 1, batching, arch=arch)
    for shards in (2, 4):
        pod, inst = _pod_streams(cuda_device, shards, batching, arch=arch)
        assert pod == one, shards
        assert inst.kv_int8 == int8 and inst.round_graph.captures == 1
        for pool in inst.cache:
            assert ("k_scale" in pool) == int8
            for key, leaf in pool.items():
                if key in ("k", "v", "k_scale", "v_scale"):
                    assert leaf._base is None, key
                    assert all(leaf[i].data_ptr() % 16 == 0
                               for i in range(leaf.shape[0])), key
    _, inst = _pod_streams(cuda_device, 2, batching, arch=arch)
    _pod_replay_equals_eager(inst)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["decode_attention", "paged_decode_attention",
                                  "decode_attention_quant",
                                  "paged_decode_attention_quant"])
@pytest.mark.parametrize("h,kv", [(16, 16), (28, 4), (48, 4)])
def test_member_heads_decode_as_the_whole_launch(cuda_device, name, h, kv):
    """A pod member's slice of the heads, its split of S planned for the
    whole model's kv heads (``plan_kv``), attends as the whole launch's
    heads bit for bit, at 2 and 4 members (qwen2-moe-a2.7b's 16 / 16
    heads, qwen2-7b's 28 / 4, starcoder2-15b's 48 / 4; B=8, S=1024,
    mixed lengths)."""
    from repro_torch.models.attention import kv_quantize
    rng = np.random.default_rng(17)
    b, s, bs = 8, 1024, 16
    q = _cuda_rand(rng, (b, 1, h, 128), cuda_device)
    kc, vc = (_cuda_rand(rng, (b, s, kv, 128), cuda_device)
              for _ in range(2))
    lens = torch.tensor([1024, 1, 517, 64, 1000, 333, 768, 129],
                        dtype=torch.int32, device=cuda_device)
    paged = name.startswith("paged")
    if paged:
        order = torch.as_tensor(rng.permutation(b * s // bs),
                                device=cuda_device)
        tables = order.to(torch.int32).view(b, s // bs)
        pool = []
        for x in (kc, vc):
            pages = torch.empty_like(x).view(b * s // bs, bs, kv, 128)
            pages[order] = x.reshape(b * s // bs, bs, kv, 128)
            pool.append(pages)
        kc, vc = pool
    leaves = ((kc, vc) if "quant" not in name
              else (*(kv_quantize(x)[0] for x in (kc, vc)),
                    *(kv_quantize(x)[1] for x in (kc, vc))))
    tail = (tables, lens) if paged else (lens,)
    fn = getattr(da, name)
    whole = fn(q, *leaves, *tail)
    for shards in (2, 4):
        km, hm = kv // shards, h // shards
        for m in range(shards):
            got = fn(q[:, :, m * hm:(m + 1) * hm].contiguous(),
                     *(x[:, :, m * km:(m + 1) * km].contiguous()
                       for x in leaves), *tail, plan_kv=kv)
            assert torch.equal(got, whole[:, :, m * hm:(m + 1) * hm]), \
                (shards, m)


@pytest.mark.gpu
def test_pods_on_other_member_devices_keep_their_own_weights(cuda_device):
    """Two pods of one function on one primary, with their second member
    on another card and then on the primary's: each gets member trees on
    its own members' devices (never the other pod's), and both serve one
    instance's greedy streams.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from repro_torch.configs import get_config
    from repro_torch.core.links import NetworkLinks
    from repro_torch.core.resources import Alloc
    from repro_torch.models import build_model
    from repro_torch.serving import ClusterFrontend

    model = build_model(get_config("qwen2-7b", reduced=True))
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    links = NetworkLinks(3, default_bps=8e9)
    links.set_link(0, 1, 64e9)
    fe = ClusterFrontend(n_nodes=3, links=links,
                         devices=["cuda:0", "cuda:1", "cuda:0"])
    alloc = Alloc(sm=0.25, quota_request=0.5, quota_limit=1.0)
    for fast in ((0, 1), (0, 2)):
        links.set_link(*fast, 64e9)
        assert fe.place_instance("f", model, params, alloc, max_batch=4,
                                 max_len=64, shards=2) is not None
        links.set_link(*fast, 1e9)
    insts = [fe.engines[0].instances[p.inst_id] for p in fe.placements]
    assert [p.member_nodes for p in fe.placements] == [(0, 1), (0, 2)]
    assert [i.weights_key for i in insts] == ["f@tp2:cuda:0,cuda:1",
                                              "f@tp2"]
    for inst in insts:
        for tree, dev in zip(inst.params, inst.group.devices):
            assert all(leaf.device == dev for leaf in _tree_leaves(tree))
    one, _ = _pod_streams(cuda_device, 1, "continuous")
    rng = np.random.default_rng(3)
    reqs = [fe.submit("f", rng.integers(0, 256, n).astype(np.int32),
                      max_new_tokens=8) for n in (5, 17, 30, 9, 12)]
    fe.pump(budget_s=120.0)
    assert [r.tokens_out for r in reqs] == one


@pytest.mark.gpu
def test_mixtral_pod_across_two_cards_gives_one_instances_streams(
        cuda_device):
    """mixtral-8x7b's smoke cut (moe on a rolled cache of window 16) as a
    2-member pod over ``cuda:0`` and ``cuda:1``, eager as declared, serves
    one instance's greedy streams, prompts of 17 and 30 tokens past the
    window.  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from repro_torch.configs import get_config
    from repro_torch.core.resources import Alloc
    from repro_torch.models import build_model
    from repro_torch.serving import ClusterFrontend

    one, _ = _pod_streams(cuda_device, 1, "continuous",
                          arch="mixtral-8x7b")
    model = build_model(get_config("mixtral-8x7b", reduced=True))
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    fe = ClusterFrontend(n_nodes=2, devices=["cuda:0", "cuda:1"])
    assert fe.place_instance("f", model, params,
                             Alloc(sm=0.25, quota_request=0.5,
                                   quota_limit=1.0),
                             max_batch=4, max_len=64, shards=2) is not None
    (p,) = fe.placements
    inst = fe.engines[p.node].instances[p.inst_id]
    assert inst.round_graph.always_eager
    assert [str(d) for d in inst.group.devices] == ["cuda:0", "cuda:1"]
    for tree, dev in zip(inst.params, inst.group.devices):
        assert all(leaf.device == dev for leaf in _tree_leaves(tree))
    rng = np.random.default_rng(3)
    reqs = [fe.submit("f", rng.integers(0, 256, n).astype(np.int32),
                      max_new_tokens=8) for n in (5, 17, 30, 9, 12)]
    fe.pump(budget_s=120.0)
    assert all(r.done for r in reqs) and inst.round_graph.captures == 0
    assert [r.tokens_out for r in reqs] == one


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


# -- gradients: the autograd Functions of the training path's kernels --------


def _input_grads(fn, inputs, seed):
    """Gradients of ``fn(*inputs)`` (a tensor or a tuple) against normal
    output gradients from ``seed``, for every floating input."""
    xs = [x.detach().clone().requires_grad_() for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gen = torch.Generator(device=outs[0].device).manual_seed(seed)
    torch.autograd.backward(outs, [torch.randn(o.shape, generator=gen,
                                               device=o.device).to(o.dtype)
                                   for o in outs])
    return [x.grad for x in xs]


def _grads_close(got, want, what):
    """Each input gradient finite and within 2e-2 of the plain version's,
    as max |diff| / max |plain| (bf16 gradients of sums over a sequence,
    in another order)."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.isfinite(g.float()).all(), (what, i)
        rel = ((g.float() - w.float()).abs().max()
               / w.float().abs().max().clamp(min=1e-30)).item()
        assert rel <= 2e-2, (what, i, rel)


GRAD_FLASH_CASES = [  # (B, Sq, Sk, causal, window, D, heads)
    (2, 512, 512, True, None, 128, (28, 4)),    # qwen2-7b's training shape
    (1, 640, 640, True, 1024, 64, (25, 5)),     # hymba's meta + 512 rows
    (1, 200, 200, True, 33, 64, (25, 5)),       # a window inside the rows
    (1, 1024, 1024, False, None, 64, (16, 16)),  # seamless's encoder
    (2, 77, 100, False, None, 128, (32, 8))]    # a cross attention


@pytest.mark.gpu
@pytest.mark.parametrize("case", GRAD_FLASH_CASES)
def test_flash_function_grads_vs_plain(cuda_device, case):
    """``ops.flash_attention`` under autograd: the kernel forward (launched
    once, within 2e-2 of the plain version) and the plain backward.  Its
    input gradients equal autograd of the plain version by construction
    (the backward recomputes that version), so the check of the kernel is
    its forward's agreement at the same causal and window settings."""
    from repro_torch.kernels import ops
    b, sq, sk, causal, window, d, (h, kv) = case
    rng = np.random.default_rng(sq + sk + d)
    q = _cuda_rand(rng, (b, sq, h, d), cuda_device)
    k = _cuda_rand(rng, (b, sk, kv, d), cuda_device)
    v = _cuda_rand(rng, (b, sk, kv, d), cuda_device)
    kw = dict(causal=causal, window=window)
    before = fa.flash_attention.launches
    got = _input_grads(lambda *x: ops.flash_attention(*x, **kw), (q, k, v), 1)
    assert fa.flash_attention.launches == before + 1
    want = _input_grads(lambda *x: fa.flash_attention_plain(*x, **kw),
                        (q, k, v), 1)
    _grads_close(got, want, f"flash {case}")
    with torch.no_grad():
        err = (ops.flash_attention(q, k, v, **kw).float()
               - fa.flash_attention_plain(q, k, v, **kw).float()).abs().max()
    assert err.item() <= 2e-2, f"flash {case}: forward max abs err {err}"


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 16, 77])
def test_wkv6_function_grads_vs_plain(cuda_device, s):
    """``ops.wkv6_scan`` under autograd (the step kernel at S = 1, the
    chunked one from 16), every input's gradient, u and the state
    included, against autograd of the plain loop."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import wkv6
    inputs = _wkv_inputs(np.random.default_rng(s), 2, s, 32, cuda_device)
    before = wkv6.wkv6_scan.launches
    got = _input_grads(ops.wkv6_scan, inputs, 2)
    assert wkv6.wkv6_scan.launches == before + 1
    _grads_close(got, _input_grads(wkv6.wkv6_scan_plain, inputs, 2),
                 f"wkv6 S={s}")


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 16, 77])
def test_ssm_function_grads_vs_plain(cuda_device, s):
    """``ops.ssm_scan`` under autograd at N = 16 (the step kernel at S = 1,
    the chunked one from 16) against autograd of the plain loop."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan
    inputs = _ssm_inputs(np.random.default_rng(s), 2, s, 25, cuda_device)
    before = ssm_scan.ssm_scan.launches
    got = _input_grads(ops.ssm_scan, inputs, 3)
    assert ssm_scan.ssm_scan.launches == before + 1
    _grads_close(got, _input_grads(ssm_scan.ssm_scan_plain, inputs, 3),
                 f"ssm S={s}")


@pytest.mark.gpu
def test_kernel_wrappers_refuse_an_input_that_wants_a_gradient(cuda_device):
    """Each wrapper raises on a CUDA input that requires grad under grad
    mode (its output would drop the gradient), never falling back to the
    plain version; under ``torch.no_grad`` it launches; the scan's
    autograd path refuses ``state_out``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssm_scan, wkv6
    rng = np.random.default_rng(0)
    q = _cuda_rand(rng, (1, 32, 28, 128), cuda_device)
    k = _cuda_rand(rng, (1, 32, 4, 128), cuda_device)
    wkv = _wkv_inputs(rng, 1, 16, 32, cuda_device)
    ssm = _ssm_inputs(rng, 1, 16, 25, cuda_device)
    calls = [(fa.flash_attention, (q, k, k)),
             (wkv6.wkv6_scan, wkv), (wkv6.wkv6_step, wkv),
             (wkv6.wkv6_chunked, wkv), (ssm_scan.ssm_scan, ssm),
             (ssm_scan.ssm_step, ssm), (ssm_scan.ssm_chunked, ssm)]
    for fn, args in calls:
        wanting = [a.detach().clone().requires_grad_() for a in args]
        before = fn.launches
        with pytest.raises(RuntimeError, match="gives no gradient"):
            fn(*wanting)
        assert fn.launches == before
        with torch.no_grad():
            fn(*wanting)
        assert fn.launches == before + 1
    x = [a.detach().clone().requires_grad_() for a in ssm]
    with pytest.raises(ValueError, match="state_out"):
        ops.ssm_scan(*x, state_out=torch.empty_like(ssm[-1]))


@pytest.mark.gpu
def test_forward_without_grad_runs_the_serving_kernels(cuda_device):
    """``Model.forward`` on params that want no gradient (or under
    ``torch.no_grad``) launches the wrappers as serving does, one flash a
    layer, records no graph, and its last position's logits are
    prefill's within 2e-2."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    model = build_model(get_config("qwen2-7b", reduced=True))
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, model.cfg.vocab_size, (2, 40)), dtype=torch.int32,
        device=cuda_device)
    before = fa.flash_attention.launches
    logits, aux = model.forward(params, tokens)
    assert fa.flash_attention.launches == before + model.cfg.n_layers
    assert not logits.requires_grad and float(aux) == 0.0
    with torch.no_grad():
        again, _ = model.forward(params, tokens, remat=True)
    assert torch.equal(again, logits)
    last, _ = model.prefill(params, tokens)
    rel = ((logits[:, -1] - last).abs().max() / last.abs().max()).item()
    assert rel <= 2e-2, rel


# -- the rwkv and hybrid families' pods (card only) ---------------------------


def _member_heads_equal(fn, x, axes):
    """``fn`` on a 2- and a 4-member pod's head slices of ``x`` (each
    input cut along its head axis in ``axes``; the state is last) gives
    each member the whole launch's heads bit for bit: outputs and final
    state."""
    out, state = fn(*x)
    h = x[-1].shape[1]
    for shards in (2, 4):
        hm = h // shards
        for m in range(shards):
            o, st = fn(*(t.narrow(a, m * hm, hm).contiguous()
                         for t, a in zip(x, axes)))
            assert torch.equal(o, out.narrow(2, m * hm, hm)), (shards, m)
            assert torch.equal(st, state.narrow(1, m * hm, hm)), (shards, m)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["wkv6_chunked", "wkv6_step"])
def test_member_heads_wkv6_as_the_whole_launch(cuda_device, kernel):
    """A 2- and a 4-member rwkv6-1.6b pod's member (16 and 8 of its 32
    heads of 64) scans its heads as the whole launch does, bit for bit:
    the chunked kernel at a B=1, S=512 prefill, the step kernel at a B=8,
    S=1 round."""
    from repro_torch.kernels import wkv6
    b, s = (1, 512) if kernel == "wkv6_chunked" else (8, 1)
    x = _wkv_inputs(np.random.default_rng(19), b, s, 32, cuda_device)
    _member_heads_equal(getattr(wkv6, kernel), x, (2, 2, 2, 2, 0, 1))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["ssm_chunked", "ssm_step"])
def test_member_heads_ssm_as_the_whole_launch(cuda_device, kernel):
    """A 2- and a 4-member reduced hymba pod's member (2 and 1 of its 4
    SSM heads of 16, N=8) scans its heads as the whole launch does, bit
    for bit: the chunked kernel at S=64, the step kernel at a B=8, S=1
    round."""
    from repro_torch.kernels import ssm_scan
    b, s = (1, 64) if kernel == "ssm_chunked" else (8, 1)
    x = _ssm_inputs(np.random.default_rng(23), b, s, 4, cuda_device, d=16,
                    n=8)
    _member_heads_equal(getattr(ssm_scan, kernel), x, (2, 2, 0, 2, 2, 1))


RECURRENT_CUTS = {"rwkv6": ("rwkv6-1.6b", {}),
                  "hymba": ("hymba-1.5b", {}),
                  "hymba-5q1kv": ("hymba-1.5b", dict(d_model=80, n_heads=5,
                                                     n_kv_heads=1))}


@pytest.mark.gpu
@pytest.mark.parametrize("cut", list(RECURRENT_CUTS))
def test_recurrent_pod_streams_equal_one_instance_on_the_card(cuda_device,
                                                              cut):
    """rwkv6-1.6b's and hymba-1.5b's smoke cuts and a hymba cut with 5 q
    over 1 kv head at d=80 serve one instance's greedy streams as 2- and
    4-member pods whose members share the card (bf16), every pod's
    rounds replayed from one captured graph: rwkv's state split at 2 and
    replicated at 4, hymba's K/V and SSM state split at 2, its K/V
    replicated at 4, the cut's every pool replicated."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.resources import Alloc
    from repro_torch.models import build_model
    from repro_torch.serving import ClusterFrontend

    arch, over = RECURRENT_CUTS[cut]
    model = build_model(dataclasses.replace(get_config(arch, reduced=True),
                                            **over))
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (5, 17, 30, 9, 12)]
    streams = {}
    for shards in (1, 2, 4):
        fe = ClusterFrontend(n_nodes=4, device=cuda_device)
        fe.place_instance("f", model, params,
                          Alloc(sm=0.25, quota_request=0.5, quota_limit=1.0),
                          max_batch=4, max_len=64, shards=shards)
        reqs = [fe.submit("f", q, max_new_tokens=8) for q in prompts]
        fe.pump(budget_s=120.0)
        assert all(r.done for r in reqs)
        (p,) = fe.placements
        inst = fe.engines[p.node].instances[p.inst_id]
        assert inst.round_graph.captures == 1 and inst.round_graph.replays
        streams[shards] = [r.tokens_out for r in reqs]
    assert streams[2] == streams[1] and streams[4] == streams[1]

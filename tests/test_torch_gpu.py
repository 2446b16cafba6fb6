"""The port's CUDA kernels against their plain PyTorch versions, and the
engine's decode round and bucketed admissions as CUDA graphs against
their eager references, on the card.  Marked ``gpu``: without a card
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


def _int8_cache(rng, shape, device):
    """Random bf16 rows quantized on the card: (codes, scales)."""
    from repro_torch.models.attention import kv_quantize
    return kv_quantize(_cuda_rand(rng, shape, device))


@pytest.mark.gpu
@pytest.mark.parametrize("lens_case", ["mixed", "one", "full", "past_end"])
def test_int8_decode_kernels_vs_plain_and_each_other(cuda_device, lens_case):
    """int8 dense and paged decode against their plain versions, and
    bit-equal to each other on identical codes."""
    b, s, bs = 8, 1024, 16
    rng = np.random.default_rng(13)
    lens_np = {"mixed": np.array([1024, 1, 517, 64, 1000, 333, 768, 129]),
               "one": np.ones(b), "full": np.full(b, s),
               "past_end": np.array([1024, 1, 517, 64, 1000, 333, 768, 129])
               + s}[lens_case].astype(np.int32)
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
@pytest.mark.parametrize("bs", [8, 32, 64])
def test_int8_paged_equals_dense_at_page_sizes(cuda_device, bs):
    """int8 pages of 8, 32 and 64 rows: the paged kernel walks the same
    tiles of 16 logical rows as the dense one, so it is bit-equal to it."""
    b, s = 8, 1024
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
    """A model and its bf16 weights drawn on the card: ``tiny`` is a
    2-layer dense config at head dim 16 (the kernels take 16-128), the
    others the reduced rwkv6-1.6b and hymba-1.5b."""
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


def _graph_engine(model, params, batching, arrivals, **kw):
    from repro_torch.core.resources import Alloc
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(window=0.1, device="cuda")
    eng.deploy("f", model, params, Alloc(sm=1.0, quota_request=0.9,
                                         quota_limit=0.9),
               batching=batching, max_batch=2, max_len=64, block_size=16,
               **kw)
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


@pytest.mark.gpu
def test_round_graph_capture_failure_raises(cuda_device, monkeypatch):
    """A round that syncs the host cannot be captured: the second round
    raises, the launch counters are left as they were, and the instance
    serves no further round, eagerly or otherwise.  Near the end of the
    file, as the prefill's counterpart after it: each leaves a failed
    capture behind."""
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

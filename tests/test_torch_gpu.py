"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: without a card each test skips at run time (the
kernels have no CPU mode).  Imports torch and numpy only, so the file
runs on the card's machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerance 2e-2: bf16 outputs, sums in another order than the plain
versions (as ``test_kernels.py`` holds bf16 kernels).
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


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (1, 512, 512, True, None, 0), (2, 37, 37, True, None, 0),
    (1, 1, 1, True, None, 0), (1, 100, 100, True, 33, 0),
    (1, 20, 84, True, None, 64), (2, 40, 70, False, None, 0)])
def test_flash_kernel_vs_plain(cuda_device, case):
    b, sq, sk, causal, window, off = case
    rng = np.random.default_rng(sq + sk)
    q = _cuda_rand(rng, (b, sq, 28, 128), cuda_device)
    k = _cuda_rand(rng, (b, sk, 4, 128), cuda_device)
    v = _cuda_rand(rng, (b, sk, 4, 128), cuda_device)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window,
                             q_offset=off)
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    q_offset=off)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 100])
def test_decode_kernels_vs_plain_and_each_other(cuda_device, window):
    b, s, bs = 8, 1024, 16
    rng = np.random.default_rng(11)
    lens_np = np.array([1024, 1, 517, 64, 1000, 333, 768, 129], np.int32)
    q = _cuda_rand(rng, (b, 1, 28, 128), cuda_device)
    kc = _cuda_rand(rng, (b, s, 4, 128), cuda_device)
    vc = _cuda_rand(rng, (b, s, 4, 128), cuda_device)
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
    kp = torch.zeros((1 + b * m, bs, 4, 128), dtype=torch.bfloat16,
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

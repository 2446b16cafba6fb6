"""Prefill flash attention: CUDA kernel wrapper, plain version, counter.

Kernel: ``csrc/flash_attention.cu`` (replaces
``repro/kernels/flash_attention.py::flash_attention_pallas``; the source
note there says what bounds it and what its design does about it).
Plain version: the counterpart of ``repro/kernels/ops.py::_xla_flash``
(chunked online softmax, ragged tails padded and masked).

``flash_attention`` takes the plain version for a tensor on the CPU and
launches the kernel for a CUDA tensor, or raises (as it does for a CUDA
input that wants a gradient: the kernel gives none);
``flash_attention.launches`` counts kernel launches.
``FlashAttentionFn`` gives the call a gradient (``ops.flash_attention``
takes it under autograd): the kernel forward, a plain backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.grad import recompute_grads, refuse_grad

NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0,
                          block_q: int = 512, block_k: int = 512
                          ) -> torch.Tensor:
    """GQA attention, q (B,Sq,H,D) over k/v (B,Sk,K,D), in f32 blocks.

    kv blocks hidden entirely by the causal mask or the window are
    skipped: their contribution is exactly zero (alpha = 1, p = 0 after a
    live block; wiped by alpha = 0 before one), so skipping them changes
    no value.
    """
    orig_dtype = q.dtype
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    g = h // n_kv
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    pad_q, pad_k = (-sq) % block_q, (-sk) % block_k
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    sqp, skp = sq + pad_q, sk + pad_k
    qg = q.reshape(b, sqp, n_kv, g, d).float() * d ** -0.5
    kf, vf = k.float(), v.float()
    dev = q.device
    out = torch.empty((b, sqp, n_kv, g, d), dtype=torch.float32, device=dev)
    for q0 in range(0, sqp, block_q):
        qb = qg[:, q0:q0 + block_q]  # (B, bq, K, G, D)
        q_pos = q_offset + q0 + torch.arange(block_q, device=dev)
        q_lo, q_hi = q_offset + q0, q_offset + q0 + block_q - 1
        acc = torch.zeros((b, n_kv, g, block_q, d), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, n_kv, g, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, n_kv, g, block_q), dtype=torch.float32,
                        device=dev)
        for k0 in range(0, skp, block_k):
            if causal and k0 > q_hi:
                break
            if window is not None and k0 + block_k - 1 <= q_lo - window:
                continue
            kb, vb = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
            k_pos = k0 + torch.arange(block_k, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", qb, kb)
            mask = (k_pos < sk)[None, :].expand(block_q, block_k)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vb)
            m = m_new
        blk = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + block_q] = blk.permute(0, 3, 1, 2, 4)
    return out.reshape(b, sqp, h, d)[:, :sq].to(orig_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Returns (B, Sq, H, D).  CPU: plain version; CUDA: the kernel (bf16,
    head dim 64 or 128, contiguous operands starting at 16-byte
    boundaries) or an error.  The kernel rounds the softmax weights to
    bf16 for the second product (at most 2^-8 relative per weight)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    refuse_grad("flash_attention", q, k, v)
    b, sq, h, d = q.shape
    kb, sk, n_kv, kd = k.shape
    if v.shape != k.shape or kb != b or kd != d or h % n_kv:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if d not in build.HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in "
                         f"{build.HEAD_DIMS}")
    o = torch.empty_like(q)
    bf16 = torch.bfloat16
    ptrs = build.pointers("flash_attention", q.device,
                          {"q": (q, bf16), "k": (k, bf16), "v": (v, bf16),
                           "o": (o, bf16)}, align=16)
    with torch.cuda.device(q.device):
        err = build.library().repro_flash_attention_bf16(
            *ptrs, b, sq, sk, h, n_kv, d, int(causal),
            -1 if window is None else int(window), int(q_offset),
            d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` with a gradient.  The forward is the wrapper:
    the kernel on the card, the plain version on the CPU.  The backward
    recomputes ``flash_attention_plain`` under autograd from the saved q,
    k, v and returns its input gradients.  That is how JAX's training
    gets this gradient: XLA differentiates the plain chunked path of
    ``ops`` (``_xla_flash``), outside any Pallas kernel, so there is no
    backward kernel to port (a hand-written one, FlashAttention-2 style
    from a saved log-sum-exp, is ROADMAP.md Queue 2)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset)
        return flash_attention(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, do):
        grads = recompute_grads(
            lambda q, k, v: flash_attention_plain(q, k, v, **ctx.kw),
            ctx.saved_tensors, ctx.needs_input_grad[:3], (do,))
        return (*grads, None, None, None)

"""Ops the models call: the port's counterpart of ``repro.kernels.ops``
for the slices ported so far (attention, int8-KV attention, WKV-6, the
selective scan, the samplers and the speculative verify).

Each kernel op dispatches on the device of its input: a CPU tensor goes
to the plain PyTorch version, a CUDA tensor to the hand-written kernel
(or the call raises — there is no fallback).  Where autograd wants a
gradient, the three kernels of the training path (``flash_attention``,
``wkv6_scan``, ``ssm_scan``) go through their autograd Functions instead:
the same forward, and a backward that recomputes a plain version under
autograd, as JAX's training differentiates its plain path
(``kernels/grad.py``).  The samplers
(``greedy_sample``, ``_filtered_logits``, ``sample_tokens``),
``speculative_verify``, ``verify_attention`` and
``paged_verify_attention`` have no kernel of their own: the JAX package
computes them in XLA, with no Pallas original, and they stay plain torch
ops on both devices.  Their noise comes from the key stream of
``keys``.
"""

from __future__ import annotations

import torch

from typing import Optional

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import keys
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels import wkv6 as _wkv6
from repro_torch.kernels.decode_attention import (
    decode_attention, decode_attention_quant, paged_decode_attention,
    paged_decode_attention_quant)
from repro_torch.kernels.grad import needs_grad
from repro_torch.kernels.ref import NEG_INF

__all__ = ["flash_attention", "decode_attention", "paged_decode_attention",
           "decode_attention_quant", "paged_decode_attention_quant",
           "wkv6_scan", "ssm_scan", "greedy_sample", "sample_tokens",
           "speculative_verify", "verify_attention",
           "paged_verify_attention"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Prefill attention (``kernels/flash_attention.py``), through
    ``FlashAttentionFn`` where autograd wants a gradient."""
    if needs_grad(q, k, v):
        return _flash.FlashAttentionFn.apply(q, k, v, causal, window,
                                             q_offset)
    return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV-6 recurrence (``kernels/wkv6.py``), through ``Wkv6ScanFn``
    where autograd wants a gradient."""
    if needs_grad(r, k, v, w, u, state):
        return _wkv6.Wkv6ScanFn.apply(r, k, v, w, u, state)
    return _wkv6.wkv6_scan(r, k, v, w, u, state)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, state: torch.Tensor,
             state_out: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan (``kernels/ssm_scan.py``), through ``SsmScanFn``
    where autograd wants a gradient; that path takes no ``state_out``."""
    if needs_grad(x, dt, a_log, b, c, state):
        if state_out is not None:
            raise ValueError("ssm_scan: state_out is an in-place write, "
                             "which autograd cannot differentiate; under "
                             "grad the scan returns its final state")
        return _ssm.SsmScanFn.apply(x, dt, a_log, b, c, state)
    return _ssm.ssm_scan(x, dt, a_log, b, c, state, state_out=state_out)


def greedy_sample(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """On-device greedy sampler: argmax over the (padded) vocab, clipped to
    the real ``vocab_size`` (ops.py:176-177).  Returns int32 tokens with
    the leading shape of ``logits``."""
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.clamp(tok, max=vocab_size - 1)


# --------------------------------------------------------------------------
# Sampling and speculative verify (ops.py:180-304) — plain torch ops on both
# devices: the JAX package computes them in XLA, with no Pallas original.
# --------------------------------------------------------------------------


def _filtered_logits(logits: torch.Tensor, vocab_size: int,
                     temperature: float, top_k: int, top_p: float
                     ) -> torch.Tensor:
    """Vocab-clipped, temperature-scaled f32 logits with top-k and top-p
    (nucleus) filtering; excluded entries sit at ``NEG_INF``
    (ops.py:180-210).  The padded vocab is masked before the filters, so a
    cutoff never counts padding, and the top-1 entry always survives."""
    v = logits.shape[-1]
    idx = torch.arange(v, device=logits.device)
    logits = torch.where(idx < vocab_size, logits.float(), NEG_INF)
    logits = logits / max(temperature, 1e-6)
    if 0 < top_k < vocab_size:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        # mass strictly before each sorted entry; keep while < top_p, so
        # the nucleus always holds the argmax.
        before = torch.cumsum(probs, dim=-1) - probs
        cutoff = torch.clamp((before < top_p).sum(dim=-1, keepdim=True),
                             min=1)
        thresh = torch.gather(srt, -1, cutoff - 1)
        logits = torch.where(logits < thresh, NEG_INF, logits)
    return logits


def sample_tokens(logits: torch.Tensor, key: torch.Tensor, vocab_size: int,
                  *, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Stochastic sampler (temperature / top-k / top-p) by the Gumbel trick
    on the filtered logits, with noise from ``key`` (``keys.gumbel``);
    int32 tokens, always ``< vocab_size`` (ops.py:213-234).
    ``temperature == 0`` is ``greedy_sample``, bit for bit."""
    if temperature == 0.0:
        return greedy_sample(logits, vocab_size)
    filt = _filtered_logits(logits, vocab_size, temperature, top_k, top_p)
    g = keys.gumbel(key, filt.shape)
    tok = torch.argmax(filt + g, dim=-1).to(torch.int32)
    return torch.clamp(tok, max=vocab_size - 1)


def speculative_verify(target_logits: torch.Tensor,
                       draft_logits: torch.Tensor,
                       draft_tokens: torch.Tensor, key: torch.Tensor,
                       vocab_size: int, *, temperature: float = 1.0,
                       top_k: int = 0, top_p: float = 1.0,
                       greedy: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Speculative rejection sampling (ops.py:237-304).  target_logits
    (B, k+1, V) score ``[t0, d_1..d_k]``; draft_logits (B, k, Vd) proposed
    the int32 ``draft_tokens`` (B, k).  Returns ``(out (B, k+1), n_accept
    (B,))``, int32: the emitted stream is ``out[:, :n_accept + 1]``, the
    accepted draft prefix and one token of the corrected residual (or the
    bonus target sample when every draft was accepted).  Greedy mode
    takes the argmax over the padded width and clips, as
    ``greedy_sample``, and accepts while it agrees with the draft."""
    b, kp1, _ = target_logits.shape
    k = kp1 - 1
    if greedy or temperature == 0.0:
        g = greedy_sample(target_logits, vocab_size)            # (B, k+1)
        accept = (g[:, :k] == draft_tokens).to(torch.int64)
        n_accept = torch.cumprod(accept, dim=1).sum(dim=1)
        return g, n_accept.to(torch.int32)
    tl = target_logits[..., :vocab_size]
    dl = draft_logits[..., :vocab_size]
    ukey, ckey = keys.split(key, 2)
    p_t = torch.softmax(
        _filtered_logits(tl, vocab_size, temperature, top_k, top_p), dim=-1)
    p_d = torch.softmax(
        _filtered_logits(dl, vocab_size, temperature, top_k, top_p), dim=-1)
    d = draft_tokens.long()[..., None]
    pt_d = torch.gather(p_t[:, :k], -1, d)[..., 0]              # (B, k)
    pd_d = torch.gather(p_d, -1, d)[..., 0]
    u = keys.uniform(ukey, (b, k))
    accept = (u * pd_d < pt_d).to(torch.int64)
    n_accept = torch.cumprod(accept, dim=1).sum(dim=1)          # (B,)
    # The residual at the first rejected position; at position k (all
    # accepted) the draft adds nothing and it is the target's (the bonus).
    p_d_pad = torch.cat([p_d, torch.zeros_like(p_t[:, :1])], dim=1)
    at = n_accept[:, None, None].expand(b, 1, p_t.shape[-1])
    pt_at = torch.gather(p_t, 1, at)[:, 0]                      # (B, V)
    pd_at = torch.gather(p_d_pad, 1, at)[:, 0]
    residual = torch.clamp(pt_at - pd_at, min=0.0)
    mass = residual.sum(dim=-1, keepdim=True)
    residual = torch.where(mass > 0, residual, pt_at)
    logr = torch.where(residual > 0,
                       torch.log(torch.clamp(residual, min=1e-30)), NEG_INF)
    g = keys.gumbel(ckey, logr.shape)
    corr = torch.clamp(torch.argmax(logr + g, dim=-1).to(torch.int32),
                       max=vocab_size - 1)                      # (B,)
    dpad = torch.cat([draft_tokens.to(torch.int32), corr[:, None]], dim=1)
    pos = torch.arange(kp1, device=dpad.device)
    out = torch.where(pos[None, :] < n_accept[:, None], dpad, corr[:, None])
    return out, n_accept.to(torch.int32)


# --------------------------------------------------------------------------
# Verify attention (ops.py:342-422) — plain torch on both devices, as XLA
# computes it in the JAX package.
# --------------------------------------------------------------------------


def verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor
                     ) -> torch.Tensor:
    """Multi-token GQA attention for the speculative verify: q (B, W, H, D)
    against a (B, S, K, D) cache whose rows ``cache_len .. cache_len+W-1``
    hold the window, with a per-query-row causal mask (window query j sees
    rows ``< cache_len + j + 1``).  f32 scores and sums, output in q's
    dtype."""
    b, w, h, d = q.shape
    s, n_kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(b, w, n_kv, h // n_kv, d) * d ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float())
    pos = torch.arange(s, device=q.device)
    limit = (cache_len.long()[:, None, None]
             + torch.arange(w, device=q.device)[None, :, None] + 1)
    valid = pos[None, None, :] < limit                          # (B, W, S)
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
    return out.reshape(b, w, h, d).to(q.dtype)


def _gather_pages(pages: torch.Tensor, block_tables: torch.Tensor
                  ) -> torch.Tensor:
    """(N, bs, K, D) pages + (B, M) table -> (B, M*bs, K, D) caches in
    logical order."""
    b, m = block_tables.shape
    g = pages[block_tables.long()]  # (B, M, bs, K, D)
    return g.reshape(b, m * pages.shape[1], *pages.shape[2:])


def paged_verify_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           cache_len: torch.Tensor) -> torch.Tensor:
    """``verify_attention`` against block-paged KV: the pages are gathered
    into contiguous caches first."""
    return verify_attention(q, _gather_pages(k_pages, block_tables),
                            _gather_pages(v_pages, block_tables), cache_len)

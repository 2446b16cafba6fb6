"""Naive full-matrix oracles (O(S^2) memory) for the attention kernels.

Counterparts of ``repro.kernels.ref.mha_reference`` and
``decode_reference``: the ground truth the plain versions and the CUDA
kernels are held against in the tests.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Naive GQA attention. q: (B,Sq,H,D); k,v: (B,Sk,K,D)."""
    b, sq, h, d = q.shape
    _, sk, n_kv, _ = k.shape
    g = h // n_kv
    qf = (q.float() * d ** -0.5).reshape(b, sq, n_kv, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def decode_reference(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """One query token per sequence against a padded (B,S,K,D) cache."""
    b, _, h, d = q.shape
    _, s, n_kv, _ = k_cache.shape
    g = h // n_kv
    qf = q.float().reshape(b, 1, n_kv, g, d) * d ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k_cache.float())
    pos = torch.arange(s, device=q.device)
    cl = cache_len.to(q.device).long()
    valid = pos[None, :] < cl[:, None]
    if window is not None:
        valid &= pos[None, :] > cl[:, None] - 1 - window
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)

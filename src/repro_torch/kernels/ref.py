"""Naive oracles for the kernels: full-matrix attention (O(S^2) memory),
and the WKV-6 recurrence and the selective scan as Python loops over time.

Counterparts of ``repro.kernels.ref.mha_reference``, ``decode_reference``,
``wkv6_reference`` and ``ssm_reference``: the ground truth the plain
versions and the CUDA kernels are held against in the tests.
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


def wkv6_reference(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 recurrence, Python loop over time (ref.py:58-71)."""
    _, s, _, _ = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    st = state.float()  # (B, H, Dk, Dv)
    outs = []
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        att = st + uf[None, :, :, None] * kv
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], att))
        st = torch.exp(wf[:, t])[..., None] * st + kv
    out = torch.stack(outs, dim=1)
    return out.to(r.dtype), st.to(state.dtype)


def ssm_reference(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, state: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan, Python loop over time (ref.py:74-89)."""
    _, s, _, _ = x.shape
    a = -torch.exp(a_log.float())
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b, c))
    st = state.float()  # (B, H, D, N)
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t][..., None] * a[None])  # (B, H, N)
        dbx = (dtf[:, t][..., None] * bf[:, t])[:, :, None, :] \
            * xf[:, t][..., None]
        st = da[:, :, None, :] * st + dbx
        ys.append(torch.einsum("bhdn,bhn->bhd", st, cf[:, t]))
    y = torch.stack(ys, dim=1)
    return y.to(x.dtype), st.to(state.dtype)

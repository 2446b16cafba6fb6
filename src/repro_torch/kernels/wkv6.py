"""RWKV-6 WKV recurrence: CUDA kernel wrapper, plain version, launch
counter.

Kernel: ``csrc/wkv6.cu`` (replaces ``repro/kernels/wkv6.py::wkv6_pallas``;
the source note there says what bounds it and what its design does about
it).  Plain version: the f32 scan of ``repro/kernels/ops.py::wkv6_scan``
(xla path, ops.py:497-512) as a loop over time.

The wrapper takes the plain version for a tensor on the CPU and launches
the kernel for a CUDA tensor, or raises; ``wkv6_scan.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_SIZE = 64  # the kernel's D (rwkv6 head size)


def wkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B,S,H,D) (w: log-space decay, negative); u (H,D); state
    (B,H,D,D) mapping k-dim x v-dim.  Scans in f32 and returns (out in
    ``r.dtype``, final state in ``state.dtype``)."""
    b, s, h, d = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    st = state.float()
    out = torch.empty((b, s, h, d), dtype=torch.float32, device=r.device)
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B,H,Dk,Dv)
        out[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], st + uf * kv)
        st = torch.exp(wf[:, t])[..., None] * st + kv
    return out.to(r.dtype), st.to(state.dtype)


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV-6 recurrence over S >= 1 steps from ``state``; returns (out
    (B,S,H,D), final state (B,H,D,D)).  On the card: r, k, v, w, u bf16,
    state f32, D = 64; out bf16, the state f32 in a new buffer."""
    if r.device.type == "cpu":
        return wkv6_scan_plain(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan: no kernel for {r.device}")
    b, s, h, d = r.shape
    if (d != HEAD_SIZE or s < 1 or any(x.shape != r.shape for x in (k, v, w))
            or tuple(u.shape) != (h, d)
            or tuple(state.shape) != (b, h, d, d)):
        raise ValueError(
            f"wkv6_scan: bad shapes r{tuple(r.shape)} u{tuple(u.shape)} "
            f"state{tuple(state.shape)} (head size must be {HEAD_SIZE})")
    out = torch.empty_like(r)
    new_state = torch.empty_like(state)
    bf16, f32 = torch.bfloat16, torch.float32
    ptrs = build.pointers(
        "wkv6_scan", r.device,
        {"r": (r, bf16), "k": (k, bf16), "v": (v, bf16), "w": (w, bf16),
         "u": (u, bf16), "state": (state, f32), "out": (out, bf16),
         "new_state": (new_state, f32)})
    with torch.cuda.device(r.device):
        err = build.library().repro_wkv6_bf16(
            *ptrs, b, s, h, d, torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, "wkv6_scan")
    wkv6_scan.launches += 1
    return out, new_state


wkv6_scan.launches = 0

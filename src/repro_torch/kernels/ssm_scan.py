"""Mamba-style selective scan (the Hymba SSM heads): CUDA kernel wrapper,
plain version, launch counter.

Kernel: ``csrc/ssm_scan.cu`` (replaces ``repro/kernels/ssm_scan.py::
ssm_scan_pallas``; the source note there says what bounds it and what its
design does about it).  Plain version: the f32 scan of
``repro/kernels/ops.py::ssm_scan`` (xla path, ops.py:515-548) as a loop
over time.

The wrapper takes the plain version for a tensor on the CPU and launches
the kernel for a CUDA tensor, or raises; ``ssm_scan.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

STATE_SIZES = (8, 16)  # the kernel's N: hymba's ssm_state, and its reduced one
ROWS = 16        # state rows (of D) per CTA: D must be a multiple


def ssm_scan_plain(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, state: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,D); dt (B,S,H) (post-softplus); a_log (H,N); b, c
    (B,S,H,N); state (B,H,D,N).  Per step, in f32,
    ``S <- S * exp(dt * A) + x^T (dt * b)`` with ``A = -exp(a_log)``, then
    ``y = S c`` from the updated state.  Returns (y in ``x.dtype``, final
    state in ``state.dtype``)."""
    bsz, s, h, d = x.shape
    a = -torch.exp(a_log.float())  # (H, N)
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b, c))
    st = state.float()
    y = torch.empty((bsz, s, h, d), dtype=torch.float32, device=x.device)
    for t in range(s):
        dtt = dtf[:, t, :, None]  # (B, H, 1)
        da = torch.exp(dtt * a[None])  # (B, H, N)
        st = da[:, :, None, :] * st \
            + (dtt * bf[:, t])[:, :, None, :] * xf[:, t, :, :, None]
        y[:, t] = torch.einsum("bhdn,bhn->bhd", st, cf[:, t])
    return y.to(x.dtype), st.to(state.dtype)


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, state: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan over S >= 1 steps from ``state``; returns (y
    (B,S,H,D), final state (B,H,D,N)).  On the card: x, dt, a_log, b, c
    bf16, state f32, N = 8 or 16, D a multiple of 16; y bf16, the state f32 in
    a new buffer."""
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, a_log, b, c, state)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: no kernel for {x.device}")
    bsz, s, h, d = x.shape
    n = a_log.shape[-1]
    if (n not in STATE_SIZES or d % ROWS or s < 1
            or tuple(dt.shape) != (bsz, s, h)
            or tuple(a_log.shape) != (h, n)
            or any(tuple(t.shape) != (bsz, s, h, n) for t in (b, c))
            or tuple(state.shape) != (bsz, h, d, n)):
        raise ValueError(
            f"ssm_scan: bad shapes x{tuple(x.shape)} dt{tuple(dt.shape)} "
            f"a_log{tuple(a_log.shape)} b{tuple(b.shape)} "
            f"c{tuple(c.shape)} state{tuple(state.shape)} (N must be one "
            f"of {STATE_SIZES}, D a multiple of {ROWS})")
    y = torch.empty_like(x)
    new_state = torch.empty_like(state)
    bf16, f32 = torch.bfloat16, torch.float32
    ptrs = build.pointers(
        "ssm_scan", x.device,
        {"x": (x, bf16), "dt": (dt, bf16), "a_log": (a_log, bf16),
         "b": (b, bf16), "c": (c, bf16), "state": (state, f32),
         "y": (y, bf16), "new_state": (new_state, f32)})
    with torch.cuda.device(x.device):
        err = build.library().repro_ssm_scan_bf16(
            *ptrs, bsz, s, h, d, n,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "ssm_scan")
    ssm_scan.launches += 1
    return y, new_state


ssm_scan.launches = 0

"""RWKV-6 WKV recurrence: CUDA kernel wrappers, plain versions, launch
counters.

Kernels: ``csrc/wkv6.cu`` (both replace
``repro/kernels/wkv6.py::wkv6_pallas``; the source note there says what
bounds them and what their design does about it): a step kernel for
``S < CHUNKED_MIN_S`` (a decode round, S = 1) and a chunked kernel on the
tensor cores from there up (prefill).  Each shape has exactly one kernel.
Plain version: the f32 scan of ``repro/kernels/ops.py::wkv6_scan`` (xla
path, ops.py:497-512) as a loop over time.  ``wkv6_chunked_plain``
repeats the chunked kernel's algorithm: the tests hold it against the
loop, and on the card ``Wkv6ScanFn``'s backward differentiates it
(nothing on the serving path calls it).

``wkv6_scan`` takes the plain version for a tensor on the CPU and launches
a kernel for a CUDA tensor, or raises (as every wrapper here does for a
CUDA input that wants a gradient: the kernels give none); on a meta
tensor it returns empty outputs and records the kernel the card would run
(``kernels/meta.py``).
``wkv6_scan.launches`` counts its launches of either kernel;
``wkv6_step.launches`` and ``wkv6_chunked.launches`` count each kernel's
own.  ``Wkv6ScanFn`` gives the scan a gradient (``ops.wkv6_scan`` takes
it under autograd): the kernel forward, a plain backward.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.grad import (recompute_grads, refuse_grad,
                                      scan_backward_plain)

HEAD_SIZE = 64      # the kernels' D (rwkv6 head size)
CHUNK = 16          # steps per chunk of the chunked kernel (one mma k16)
CHUNKED_MIN_S = 16  # S from which the chunked kernel runs: one chunk


def wkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B,S,H,D) (w: log-space decay, negative); u (H,D); state
    (B,H,D,D) mapping k-dim x v-dim.  Scans in the dtype ``Tensor.float``
    gives (f32) and returns (out in ``r.dtype``, final state in
    ``state.dtype``)."""
    b, s, h, d = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    st = state.float()
    out = torch.empty((b, s, h, d), dtype=rf.dtype, device=r.device)
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]  # (B,H,Dk,Dv)
        out[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], st + uf * kv)
        st = torch.exp(wf[:, t])[..., None] * st + kv
    return out.to(r.dtype), st.to(state.dtype)


def wkv6_chunked_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                       chunk: int = CHUNK
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked kernel's algorithm in f32, for the tests: the same
    function as ``wkv6_scan_plain``.  Per chunk of ``chunk`` steps (a power
    of two; rows past S are zero, w = 0 there), with A the running sum of
    w from the chunk's start:

    * the inter-chunk term (r_t . e^{A_{t-1}}) S_0;
    * the scores P[t][s] = sum_i r_t[i] k_s[i] e^{A_{t-1}[i] - A_s[i]}
      (s < t), each factored through a boundary between s and t: with z
      the highest power of two in t XOR s, ref = (t // z) z - 1, the last
      step of the z-block just below t's, and P = Q_z Q_z^T masked to the
      pairs of level z, where Q_z holds r_t e^{A_{t-1} - A_ref} on rows t
      in an odd z-block and k_s e^{A_ref' - A_s} (ref' the last step of
      s's own z-block) on the others; the bonus u on the diagonal;
    * S_L = e^{A_L} . S_0 + sum_s (k_s . e^{A_L - A_s}) (x) v_s.

    No exponent is positive, whatever the decay."""
    if chunk < 1 or chunk & (chunk - 1):
        raise ValueError(f"chunk {chunk} is not a power of two")
    b, s, h, d = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()
    st = state.float()
    out = torch.empty((b, s, h, d), dtype=rf.dtype, device=r.device)
    rows = torch.arange(chunk, device=r.device)
    for c0 in range(0, s, chunk):
        n = min(chunk, s - c0)

        def take(x):
            y = x.new_zeros((b, chunk, h, d))
            y[:, :n] = x[:, c0:c0 + n]
            return y

        rc, kc, vc, wc = (take(x) for x in (rf, kf, vf, wf))
        a = torch.cumsum(wc, dim=1)  # A_t
        a_prev = torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], 1)
        o = torch.einsum("bthi,bhij->bthj", rc * torch.exp(a_prev), st)
        p = torch.diag_embed(torch.einsum("bthi,hi,bthi->bht", rc, uf, kc))
        z = chunk // 2
        while z >= 1:
            block = rows // z
            upper = (block % 2 == 1)[None, :, None, None]
            ref_t = (block * z - 1).clamp(min=0)        # rows in odd blocks
            ref_s = block * z + z - 1                   # rows in even blocks
            # Row 0's a_prev - a[0] = -w_0 > 0 in the branch not taken:
            # zero it, so no exp overflows into the gradient (0 * inf).
            q = torch.where(
                upper, rc * torch.exp(torch.where(upper, a_prev - a[:, ref_t],
                                                  0.0)),
                kc * torch.exp(a[:, ref_s] - a))
            x = rows[:, None] ^ rows[None, :]
            level = (x >= z) & (x < 2 * z) & (rows[:, None] > rows[None, :])
            p = p + torch.einsum("bthi,bshi->bhts", q, q) * level
            z //= 2
        o = o + torch.einsum("bhts,bshj->bthj", p, vc)
        out[:, c0:c0 + n] = o[:, :n]
        a_end = a[:, -1]
        st = torch.exp(a_end)[..., None] * st + torch.einsum(
            "bshi,bshj->bhij", kc * torch.exp(a_end[:, None] - a), vc)
    return out.to(r.dtype), st.to(state.dtype)


def _launch(name: str, fn: str, r, k, v, w, u, state
            ) -> tuple[torch.Tensor, torch.Tensor]:
    b, s, h, d = r.shape
    if (d != HEAD_SIZE or s < 1 or any(x.shape != r.shape for x in (k, v, w))
            or tuple(u.shape) != (h, d)
            or tuple(state.shape) != (b, h, d, d)):
        raise ValueError(
            f"{name}: bad shapes r{tuple(r.shape)} u{tuple(u.shape)} "
            f"state{tuple(state.shape)} (head size must be {HEAD_SIZE})")
    refuse_grad(name, r, k, v, w, u, state)
    out = torch.empty_like(r)
    new_state = torch.empty_like(state)
    bf16, f32 = torch.bfloat16, torch.float32
    ptrs = build.pointers(
        name, r.device,
        {"r": (r, bf16), "k": (k, bf16), "v": (v, bf16), "w": (w, bf16),
         "u": (u, bf16, 2), "state": (state, f32, 4), "out": (out, bf16),
         "new_state": (new_state, f32, 4)}, align=16)
    with torch.cuda.device(r.device):
        err = getattr(build.library(), fn)(
            *ptrs, b, s, h, d, torch.cuda.current_stream(r.device).cuda_stream)
    build.check(err, name)
    return out, new_state


def wkv6_step(r, k, v, w, u, state) -> tuple[torch.Tensor, torch.Tensor]:
    """The step kernel on CUDA tensors (any S >= 1; the scan takes it below
    ``CHUNKED_MIN_S``)."""
    result = _launch("wkv6_step", "repro_wkv6_bf16", r, k, v, w, u, state)
    wkv6_step.launches += 1
    return result


def wkv6_chunked(r, k, v, w, u, state) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked kernel on CUDA tensors (any S >= 1; the scan takes it
    from ``CHUNKED_MIN_S`` up)."""
    result = _launch("wkv6_chunked", "repro_wkv6_chunked_bf16", r, k, v, w,
                     u, state)
    wkv6_chunked.launches += 1
    return result


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV-6 recurrence over S >= 1 steps from ``state``; returns (out
    (B,S,H,D), final state (B,H,D,D)).  On the card: r, k, v, w, u bf16,
    state f32, D = 64; out bf16, the state f32 in a new buffer; the step
    kernel below ``CHUNKED_MIN_S`` steps, the chunked kernel from there."""
    if r.device.type == "cpu":
        return wkv6_scan_plain(r, k, v, w, u, state)
    if r.device.type == "meta":
        out, new_state = torch.empty_like(r), torch.empty_like(state)
        meta.record("wkv6_chunked" if r.shape[1] >= CHUNKED_MIN_S
                    else "wkv6_step", (r, k, v, w, u, state),
                    (out, new_state))
        return out, new_state
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan: no kernel for {r.device}")
    kernel = wkv6_chunked if r.shape[1] >= CHUNKED_MIN_S else wkv6_step
    result = kernel(r, k, v, w, u, state)
    wkv6_scan.launches += 1
    return result


wkv6_step.launches = 0
wkv6_chunked.launches = 0
wkv6_scan.launches = 0


def wkv6_backward_plain(r, k, v, w, u, state
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version ``Wkv6ScanFn``'s backward differentiates
    (``grad.scan_backward_plain``): ``wkv6_chunked_plain`` at
    ``grad_chunk(S)`` steps a chunk where the forward ran the chunked
    kernel, else the loop."""
    return scan_backward_plain(wkv6_scan_plain, wkv6_chunked_plain,
                               CHUNKED_MIN_S, r, k, v, w, u, state)


class Wkv6ScanFn(torch.autograd.Function):
    """``wkv6_scan`` with a gradient.  The forward is the wrapper: a
    kernel on the card, the plain loop on the CPU.  The backward
    recomputes the plain version of what the forward ran
    (``wkv6_backward_plain``) under autograd from the saved inputs and
    returns their gradients.  That is how JAX's training gets this
    gradient: XLA differentiates the plain scan of ``ops`` (``wkv6_scan``'s
    xla path), outside any Pallas kernel, so there is no backward kernel
    to port (a hand-written one is ROADMAP.md Queue 2)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.save_for_backward(r, k, v, w, u, state)
        return wkv6_scan(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, d_out, d_state):
        if d_out.device.type == "meta":
            return meta.backward("wkv6_scan", ctx.saved_tensors,
                                 ctx.needs_input_grad, (d_out, d_state))
        return recompute_grads(wkv6_backward_plain, ctx.saved_tensors,
                               ctx.needs_input_grad, (d_out, d_state))

"""Mamba-style selective scan (the Hymba SSM heads): CUDA kernel wrappers,
plain versions, launch counters.

Kernels: ``csrc/ssm_scan.cu`` (both replace ``repro/kernels/ssm_scan.py::
ssm_scan_pallas``; the source note there says what bounds them and what
their design does about it): a step kernel for ``S < CHUNKED_MIN_S`` (a
decode round, S = 1) and a chunked kernel on the tensor cores from there
up (prefill).  Each shape has exactly one kernel.  Plain version: the f32
scan of ``repro/kernels/ops.py::ssm_scan`` (xla path, ops.py:515-548) as a
loop over time.  ``ssm_chunked_plain`` repeats the chunked kernel's
algorithm: the tests hold it against the loop, and on the card
``SsmScanFn``'s backward differentiates it (nothing on the serving path
calls it).

``ssm_scan`` takes the plain version for a tensor on the CPU and launches
a kernel for a CUDA tensor, or raises (as every wrapper here does for a
CUDA input that wants a gradient: the kernels give none).
``ssm_scan.launches`` counts its launches of either kernel;
``ssm_step.launches`` and ``ssm_chunked.launches`` count each kernel's
own.  ``SsmScanFn`` gives the scan a gradient (``ops.ssm_scan`` takes it
under autograd): the kernel forward, a plain backward, and no
``state_out``.

``state_out``: ``ssm_scan``, ``ssm_step`` and ``ssm_chunked`` write the
final state into a buffer the caller gives, which may be ``state``
itself.  Both kernels read each
state element before they write it, in the same thread (the step kernel)
or the same warp (the chunked kernel's chain warp), and no other thread
touches it, so the hybrid model updates its pool's layer view in place
and copies nothing.  A ``state_out`` that overlaps ``state`` in part, or
any input, is refused, as is one off a 16-byte boundary on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.grad import (recompute_grads, refuse_grad,
                                      scan_backward_plain)

STATE_SIZES = (8, 16)  # the kernels' N: hymba's ssm_state, and its reduced one
ROWS = 16           # state rows (of D) per CTA: D must be a multiple
CHUNK = 16          # steps per chunk of the chunked kernel (one mma k16)
CHUNKED_MIN_S = 16  # S from which the chunked kernel runs: one chunk


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


def ssm_chunked_plain(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, state: torch.Tensor,
                      chunk: int = CHUNK
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked kernel's algorithm in f32, for the tests: the same
    function as ``ssm_scan_plain``.  Per chunk of ``chunk`` steps (a power
    of two; rows past S are zero, dt = 0 there), with L the running sum of
    dt from the chunk's start (inclusive) and k_s = dt_s b_s:

    * the inter-chunk term (c_t . e^{A L_t}) S_0 (y reads the state after
      step t, so the decay includes step t's own);
    * the scores P[t][s] = sum_n c_t[n] k_s[n] e^{A_n (L_t - L_s)} (s < t),
      each factored through a boundary between s and t: with z the highest
      power of two in t XOR s, ref = (t // z) z - 1, the last step of the
      z-block just below t's, and P = Q_z Q_z^T masked to the pairs of
      level z, where Q_z holds c_t e^{A (L_t - L_ref)} on rows t in an odd
      z-block and k_s e^{A (L_ref' - L_s)} (ref' the last step of s's own
      z-block) on the others; c_t . k_t (exponent 0) on the diagonal;
    * S_L = e^{A L_L} . S_0 + sum_s x_s (x) (k_s . e^{A (L_L - L_s)}).

    No exponent is positive, whatever dt and A."""
    if chunk < 1 or chunk & (chunk - 1):
        raise ValueError(f"chunk {chunk} is not a power of two")
    bsz, s, h, d = x.shape
    a = -torch.exp(a_log.float())  # (H, N)
    xf, dtf, bf, cf = (t.float() for t in (x, dt, b, c))
    st = state.float()
    y = torch.empty((bsz, s, h, d), dtype=torch.float32, device=x.device)
    rows = torch.arange(chunk, device=x.device)

    def decay(delta):  # (B, L, H) -> e^{A delta}, (B, L, H, N)
        return torch.exp(delta[..., None] * a)

    for c0 in range(0, s, chunk):
        m = min(chunk, s - c0)

        def take(t):
            out = t.new_zeros((bsz, chunk) + t.shape[2:])
            out[:, :m] = t[:, c0:c0 + m]
            return out

        xc, dtc, bc, cc = (take(t) for t in (xf, dtf, bf, cf))
        lam = torch.cumsum(dtc, dim=1)  # (B, L, H)
        k = dtc[..., None] * bc
        yc = torch.einsum("bthn,bhdn->bthd", cc * decay(lam), st)
        p = torch.diag_embed(torch.einsum("bthn,bthn->bht", cc, k))
        z = chunk // 2
        while z >= 1:
            block = rows // z
            upper = (block % 2 == 1)[None, :, None, None]
            ref_t = (block * z - 1).clamp(min=0)        # rows in odd blocks
            ref_s = block * z + z - 1                   # rows in even blocks
            q = torch.where(upper, cc * decay(lam - lam[:, ref_t]),
                            k * decay(lam[:, ref_s] - lam))
            xor = rows[:, None] ^ rows[None, :]
            level = (xor >= z) & (xor < 2 * z) & (rows[:, None] > rows[None, :])
            p = p + torch.einsum("bthn,bshn->bhts", q, q) * level
            z //= 2
        yc = yc + torch.einsum("bhts,bshd->bthd", p, xc)
        y[:, c0:c0 + m] = yc[:, :m]
        lam_end = lam[:, -1]  # (B, H)
        st = torch.exp(lam_end[..., None] * a)[:, :, None, :] * st \
            + torch.einsum("bshd,bshn->bhdn", xc,
                           k * decay(lam_end[:, None] - lam))
    return y.to(x.dtype), st.to(state.dtype)


def _span(t: torch.Tensor) -> tuple[int, int]:
    """The bytes [lo, hi) that ``t``'s elements lie in (torch's strides are
    never negative)."""
    lo = t.data_ptr()
    if t.numel() == 0:
        return lo, lo
    last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return lo, lo + (last + 1) * t.element_size()


def _check_state_out(name: str, state: torch.Tensor,
                     state_out: torch.Tensor, *inputs: torch.Tensor) -> None:
    """``state_out`` takes the final state: the state's shape, dtype and
    device, contiguous, and either ``state`` itself (the same bytes) or
    apart from it; it overlaps none of ``inputs`` (x, dt, a_log, b, c)."""
    if (tuple(state_out.shape) != tuple(state.shape)
            or state_out.dtype != state.dtype
            or state_out.device != state.device
            or not state_out.is_contiguous()):
        raise ValueError(
            f"{name}: state_out must be a contiguous {state.dtype} tensor of "
            f"shape {tuple(state.shape)} on {state.device}, got "
            f"{state_out.dtype} {tuple(state_out.shape)} on "
            f"{state_out.device}")
    out = _span(state_out)

    def overlaps(t):
        lo, hi = _span(t)
        return t.device == state_out.device and lo < out[1] and out[0] < hi

    if overlaps(state) and _span(state) != out:
        raise ValueError(f"{name}: state_out overlaps state in part (it must "
                         f"be state itself or apart from it)")
    if any(overlaps(t) for t in inputs):
        raise ValueError(f"{name}: state_out overlaps x, dt, a_log, b or c")


def _launch(name: str, fn: str, x, dt, a_log, b, c, state, state_out
            ) -> tuple[torch.Tensor, torch.Tensor]:
    bsz, s, h, d = x.shape
    n = a_log.shape[-1]
    if (n not in STATE_SIZES or d % ROWS or s < 1
            or tuple(dt.shape) != (bsz, s, h)
            or tuple(a_log.shape) != (h, n)
            or any(tuple(t.shape) != (bsz, s, h, n) for t in (b, c))
            or tuple(state.shape) != (bsz, h, d, n)):
        raise ValueError(
            f"{name}: bad shapes x{tuple(x.shape)} dt{tuple(dt.shape)} "
            f"a_log{tuple(a_log.shape)} b{tuple(b.shape)} "
            f"c{tuple(c.shape)} state{tuple(state.shape)} (N must be one "
            f"of {STATE_SIZES}, D a multiple of {ROWS})")
    refuse_grad(name, x, dt, a_log, b, c, state)
    if state_out is None:
        state_out = torch.empty_like(state)
    else:
        _check_state_out(name, state, state_out, x, dt, a_log, b, c)
    y = torch.empty_like(x)
    bf16, f32 = torch.bfloat16, torch.float32
    ptrs = build.pointers(
        name, x.device,
        {"x": (x, bf16), "dt": (dt, bf16, 2), "a_log": (a_log, bf16, 8),
         "b": (b, bf16), "c": (c, bf16), "state": (state, f32),
         "y": (y, bf16), "state_out": (state_out, f32)}, align=16)
    with torch.cuda.device(x.device):
        err = getattr(build.library(), fn)(
            *ptrs, bsz, s, h, d, n,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, name)
    return y, state_out


def ssm_step(x, dt, a_log, b, c, state, state_out=None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The step kernel on CUDA tensors (any S >= 1; the scan takes it below
    ``CHUNKED_MIN_S``)."""
    result = _launch("ssm_step", "repro_ssm_scan_bf16", x, dt, a_log, b, c,
                     state, state_out)
    ssm_step.launches += 1
    return result


def ssm_chunked(x, dt, a_log, b, c, state, state_out=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked kernel on CUDA tensors (any S >= 1; the scan takes it
    from ``CHUNKED_MIN_S`` up)."""
    result = _launch("ssm_chunked", "repro_ssm_chunked_bf16", x, dt, a_log,
                     b, c, state, state_out)
    ssm_chunked.launches += 1
    return result


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, state: torch.Tensor,
             state_out: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan over S >= 1 steps from ``state``; returns (y
    (B,S,H,D), final state (B,H,D,N)).  The final state goes to
    ``state_out`` where one is given (``state`` itself, to update it in
    place, or a buffer apart from it and from the inputs) and is returned;
    else to a new buffer.  On the card: x, dt, a_log, b, c bf16, state
    f32, N = 8 or 16, D a multiple of 16, the state and ``state_out``
    16-byte aligned; y bf16; the step kernel below ``CHUNKED_MIN_S``
    steps, the chunked kernel from there."""
    if x.device.type == "cpu":
        if state_out is None:
            return ssm_scan_plain(x, dt, a_log, b, c, state)
        _check_state_out("ssm_scan", state, state_out, x, dt, a_log, b, c)
        y, st = ssm_scan_plain(x, dt, a_log, b, c, state)
        return y, state_out.copy_(st)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: no kernel for {x.device}")
    kernel = ssm_chunked if x.shape[1] >= CHUNKED_MIN_S else ssm_step
    result = kernel(x, dt, a_log, b, c, state, state_out)
    ssm_scan.launches += 1
    return result


ssm_step.launches = 0
ssm_chunked.launches = 0
ssm_scan.launches = 0


def ssm_backward_plain(x, dt, a_log, b, c, state
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version ``SsmScanFn``'s backward differentiates
    (``grad.scan_backward_plain``): ``ssm_chunked_plain`` at
    ``grad_chunk(S)`` steps a chunk where the forward ran the chunked
    kernel, else the loop."""
    return scan_backward_plain(ssm_scan_plain, ssm_chunked_plain,
                               CHUNKED_MIN_S, x, dt, a_log, b, c, state)


class SsmScanFn(torch.autograd.Function):
    """``ssm_scan`` with a gradient, and no ``state_out`` (an in-place write
    of a state autograd saved would corrupt it): the final state comes
    back in a new buffer.  The forward is the wrapper: a kernel on the
    card, the plain loop on the CPU.  The backward recomputes the plain
    version of what the forward ran (``ssm_backward_plain``) under
    autograd from the saved inputs and returns their gradients.  That is
    how JAX's training gets this gradient: XLA differentiates the plain
    scan of ``ops`` (``ssm_scan``'s xla path), outside any Pallas kernel,
    so there is no backward kernel to port (a hand-written one is
    ROADMAP.md Queue 2)."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, state):
        ctx.save_for_backward(x, dt, a_log, b, c, state)
        return ssm_scan(x, dt, a_log, b, c, state)

    @staticmethod
    def backward(ctx, d_y, d_state):
        return recompute_grads(ssm_backward_plain, ctx.saved_tensors,
                               ctx.needs_input_grad, (d_y, d_state))

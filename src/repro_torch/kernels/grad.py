"""Gradients for the kernels on the training path: the refusal every
kernel wrapper makes of an input that wants a gradient, and the backward
the autograd Functions share.

The JAX package has no backward kernel (no ``custom_vjp``): its training
differentiates the plain path of ``ops`` (the ``xla`` backend, ops.py:25),
outside any Pallas kernel.  The port's counterpart is a
``torch.autograd.Function`` beside each kernel on the training path
(``FlashAttentionFn``, ``Wkv6ScanFn``, ``SsmScanFn``): its forward is the
wrapper (the hand-written kernel on the card, the plain version on the
CPU), and its backward recomputes a plain version of the same function
under autograd from the saved inputs (``recompute_grads``).  For the
two scans, ``scan_backward_plain`` picks that plain version.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

GRAD_CHUNK = 512  # most steps a chunk of a scan's plain backward recompute


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper gives no gradient: on a CUDA tensor that wants one
    it raises rather than return an output autograd cannot see past (the
    output would be a leaf, and gradients into the inputs would be
    dropped with no error).  The autograd Functions call the wrappers
    inside their forward, where grad mode is off."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the kernel gives no gradient, and an input requires "
            f"one; call it through repro_torch.kernels.ops (its autograd "
            f"Function) or under torch.no_grad()")


def recompute_grads(fn: Callable, inputs: Sequence[torch.Tensor],
                    needs: Sequence[bool],
                    grad_outputs: Sequence[torch.Tensor]) -> tuple:
    """The gradients of ``fn(*inputs)`` (a tensor or a tuple of them) for
    the inputs whose ``needs`` is set, None for the others: ``fn`` runs
    again under autograd on detached copies of the inputs, and
    ``torch.autograd.grad`` takes ``grad_outputs`` through it.  The
    profiler sees the work as ``plain_backward``."""
    with torch.enable_grad(), torch.profiler.record_function(
            "plain_backward"):
        xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, needs)]
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        live = [(o, g) for o, g in zip(outs, grad_outputs) if o.requires_grad]
        got = iter(torch.autograd.grad(
            [o for o, _ in live], [x for x, n in zip(xs, needs) if n],
            [g for _, g in live]))
    return tuple(next(got) if n else None for n in needs)


def grad_chunk(s: int) -> int:
    """A scan backward's chunk for S steps: the least power of two holding
    them, at most ``GRAD_CHUNK`` (each chunk costs the torch ops of its
    log2 levels, so few large chunks launch least; every exponent stays
    a sum of decays, never positive, whatever the chunk)."""
    return min(GRAD_CHUNK, 1 << max(s - 1, 0).bit_length())


def scan_backward_plain(loop: Callable, chunked: Callable, chunked_min_s: int,
                        *inputs: torch.Tensor) -> tuple:
    """The plain version a scan's Function differentiates in its backward,
    run on ``inputs`` (time on dim 1 of the first): where the forward ran
    the chunked kernel (a CUDA tensor, S >= ``chunked_min_s``), that
    kernel's algorithm ``chunked`` at ``grad_chunk(S)`` steps a chunk (a
    few hundred torch ops a layer where the loop takes thousands); else
    (the CPU, the step kernel) the ``loop``."""
    x = inputs[0]
    if x.device.type == "cuda" and x.shape[1] >= chunked_min_s:
        return chunked(*inputs, chunk=grad_chunk(x.shape[1]))
    return loop(*inputs)

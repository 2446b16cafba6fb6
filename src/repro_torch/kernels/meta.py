"""Shape-only kernel calls on the meta device.

A kernel wrapper given a tensor on the ``meta`` device computes nothing
and launches nothing: it returns empty outputs of the kernel's shapes and
dtypes and records the call here (its name, the shape and element size of
every operand it reads and every output it writes, and its options), so
the dry run (``launch/dryrun.py``) can trace a whole step at full width
with no card and no allocation and reckon the kernels' FLOPs and bytes
from the shapes (``analysis.roofline.kernel_call_cost``).  The autograd
Functions' backward does the same on meta, as ``<name>.backward``.
Outside ``recording()`` a meta call records nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """One shape-only call: operands read and outputs written as (shape,
    bytes an element), and the call's options."""

    name: str
    reads: tuple[tuple[tuple[int, ...], int], ...]
    writes: tuple[tuple[tuple[int, ...], int], ...]
    options: tuple[tuple[str, object], ...] = ()

    def option(self, key: str, default=None):
        return dict(self.options).get(key, default)


_SINK: Optional[list[KernelCall]] = None


@contextlib.contextmanager
def recording() -> Iterator[list[KernelCall]]:
    """Collect the meta calls made inside the block, in call order."""
    global _SINK
    prev, _SINK = _SINK, []
    try:
        yield _SINK
    finally:
        _SINK = prev


def _shapes(tensors: Sequence[torch.Tensor]):
    return tuple((tuple(t.shape), t.element_size()) for t in tensors)


def record(name: str, reads: Sequence[torch.Tensor],
           writes: Sequence[torch.Tensor], **options) -> None:
    """Note a shape-only call of kernel ``name`` (inside ``recording()``)."""
    if _SINK is not None:
        _SINK.append(KernelCall(name, _shapes(reads), _shapes(writes),
                                tuple(sorted(options.items()))))


def backward(name: str, inputs: Sequence[torch.Tensor],
             needs: Sequence[bool], grad_outputs: Sequence[torch.Tensor],
             **options) -> tuple:
    """The meta backward of an autograd Function: empty gradients for the
    inputs that need one, recorded as ``<name>.backward``."""
    grads = tuple(torch.empty_like(x) if n else None
                  for x, n in zip(inputs, needs))
    record(f"{name}.backward", [*inputs, *grad_outputs],
           [g for g in grads if g is not None], **options)
    return grads

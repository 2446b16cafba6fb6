"""PyTorch/CUDA port of the FaST-GShare serving data plane.

A second package beside the JAX reference ``repro``; it imports ``torch``
and numpy only, never ``jax`` or anything under ``repro``.  See README.md
for the module map and the kernel build.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: every entry point runs on ``cuda`` unless the
    caller names another device (the CPU tests pass ``device="cpu"``).
    Asking for ``cuda`` on a machine without a card raises — there is no
    silent CPU fallback.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        if dev.index is None:  # compare equal to the tensors' device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev

"""Hand-written CUDA kernels of the port, their plain PyTorch versions, and
the launch counters that show a run went through them."""

from __future__ import annotations

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash

KERNELS = {
    "flash_attention": _flash.flash_attention,
    "decode_attention": _decode.decode_attention,
    "paged_decode_attention": _decode.paged_decode_attention,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0

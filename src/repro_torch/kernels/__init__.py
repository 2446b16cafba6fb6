"""Hand-written CUDA kernels of the port, their plain PyTorch versions, and
the launch counters that show a run went through them."""

from __future__ import annotations

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels import wkv6 as _wkv6

KERNELS = {
    "flash_attention": _flash.flash_attention,
    "decode_attention": _decode.decode_attention,
    "paged_decode_attention": _decode.paged_decode_attention,
    "decode_attention_quant": _decode.decode_attention_quant,
    "paged_decode_attention_quant": _decode.paged_decode_attention_quant,
    "wkv6_step": _wkv6.wkv6_step,
    "wkv6_chunked": _wkv6.wkv6_chunked,
    "ssm_step": _ssm.ssm_step,
    "ssm_chunked": _ssm.ssm_chunked,
}


# Ops that pick one of the kernels above by shape; each counts its launches
# of any of them.
DISPATCHERS = (_wkv6.wkv6_scan, _ssm.ssm_scan)
COUNTED = (*KERNELS.values(), *DISPATCHERS)  # every ``.launches`` counter


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def counter_values() -> list[int]:
    """Every counter of ``COUNTED``, in its order."""
    return [fn.launches for fn in COUNTED]


def add_launches(delta: list[int]) -> None:
    """Add ``delta`` (one entry per counter of ``COUNTED``) to the counters:
    a replayed CUDA graph runs no wrapper, so its launches are counted
    here, once per replay."""
    for fn, n in zip(COUNTED, delta, strict=True):
        fn.launches += n

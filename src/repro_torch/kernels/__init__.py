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


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in (*KERNELS.values(), *DISPATCHERS):
        fn.launches = 0

"""Parameter specs and common layers (counterpart of
``repro.models.layers``).

Parameters are plain nested dicts of tensors in the JAX layouts: ``x @ W``
with ``W`` shaped ``(d_in, d_out)`` and a stacked leading ``layers`` axis,
so a JAX param tree bridges over leaf for leaf (``repro_torch.bridge``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    init: str = "normal"  # normal (std 1/sqrt(fan_in)) | zeros | small
    stacked: bool = False  # leading dim is the stacked "layers" axis


def stack_tree(spec_tree: Any, n: int) -> Any:
    """Add a leading stacked-layers dim to every spec of a tree."""
    if isinstance(spec_tree, dict):
        return {k: stack_tree(v, n) for k, v in spec_tree.items()}
    return PSpec((n, *spec_tree.shape), spec_tree.init, stacked=True)


def param_logical_names(spec_tree: Any) -> Any:
    """PSpec tree -> logical-name-tuple tree (same structure).  The port
    names only the stacked ``"layers"`` axis, the unit of the fleet
    store's layer-by-layer upload; every other dim is ``None`` (the
    sharding names arrive with sharded pods, ROADMAP.md Queue 1 item 11)."""
    if isinstance(spec_tree, dict):
        return {k: param_logical_names(v) for k, v in spec_tree.items()}
    rest = (None,) * (len(spec_tree.shape) - spec_tree.stacked)
    return ("layers",) + rest if spec_tree.stacked else rest


def init_params(spec_tree: Any, generator: torch.Generator) -> Any:
    """Materialize bf16 parameters from a PSpec tree, one leaf at a time,
    on the generator's device, with the init rules of ``repro.models.
    layers.init_params`` (normal with std 1/sqrt(fan_in), ``small`` std
    0.02, zeros).  Stacked leaves are drawn one layer slice at a time so
    the f32 draw never holds more than one slice."""
    device, dtype = generator.device, torch.bfloat16

    def one(spec: PSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        shape = spec.shape
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = 0.02 if spec.init == "small" else 1.0 / math.sqrt(fan_in)
        out = torch.empty(shape, dtype=dtype, device=device)
        rows = out.view(-1, *shape[-2:]) if len(shape) > 2 else out[None]
        for piece in rows:
            piece.copy_(torch.randn(piece.shape, generator=generator,
                                    dtype=torch.float32, device=device) * std)
        return out

    def walk(tree: Any) -> Any:
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return one(tree)

    return walk(spec_tree)


def param_count(spec_tree: Any) -> int:
    if isinstance(spec_tree, dict):
        return sum(param_count(v) for v in spec_tree.values())
    return math.prod(spec_tree.shape)


# --------------------------------------------------------------------------
# Normalization / positional encodings
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm scaling by ``1 + weight`` in f32 (layers.py:104-109) — not
    ``torch.nn.RMSNorm``, which scales by ``weight``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=device) / dh))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding on split halves (not interleaved pairs).
    x: (B, S, H, D); positions: (S,) or (B, S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP block
# --------------------------------------------------------------------------


def mlp_specs(d: int, f: int) -> dict[str, PSpec]:
    return {"w_gate": PSpec((d, f)), "w_up": PSpec((d, f)),
            "w_down": PSpec((f, d))}


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP; the activation runs in f32 and casts back
    (layers.py:174)."""
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    return (F.silu(gate.float()).to(x.dtype) * up) @ params["w_down"]

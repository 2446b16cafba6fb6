"""Parameter specs and common layers (counterpart of
``repro.models.layers``).

Parameters are plain nested dicts of tensors in the JAX layouts: ``x @ W``
with ``W`` shaped ``(d_in, d_out)`` and a stacked leading ``layers`` axis,
so a JAX param tree bridges over leaf for leaf (``repro_torch.bridge``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.distributed.sharding import TPGroup, gather_cols


@dataclasses.dataclass(frozen=True)
class PSpec:
    """Declaration of one parameter tensor: its shape, the logical name of
    each dim (``repro_torch.distributed.sharding``: ``"tp"`` for a
    projection's split dim, ``"vocab"``, ``"fsdp"``, ``"layers"`` for the
    stacked axis, ...), exactly as the JAX package declares them
    (layers.py:31)."""

    shape: tuple[int, ...]
    names: tuple[Optional[str], ...]
    init: str = "normal"  # normal (std 1/sqrt(fan_in)) | zeros | small
    dtype: torch.dtype = torch.bfloat16  # the MoE router is f32

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.names):
            raise ValueError(f"rank mismatch {self.shape} vs {self.names}")


def stack_tree(spec_tree: Any, n: int) -> Any:
    """Add a leading stacked-layers dim to every spec of a tree."""
    if isinstance(spec_tree, dict):
        return {k: stack_tree(v, n) for k, v in spec_tree.items()}
    return dataclasses.replace(spec_tree, shape=(n, *spec_tree.shape),
                               names=("layers", *spec_tree.names))


def param_logical_names(spec_tree: Any) -> Any:
    """PSpec tree -> logical-name-tuple tree (same structure): what a
    sharded pod's placement resolves, and the fleet store's unit of
    upload (a leading ``"layers"`` dim is uploaded layer by layer)."""
    if isinstance(spec_tree, dict):
        return {k: param_logical_names(v) for k, v in spec_tree.items()}
    return spec_tree.names


# The names of the two projection layouts: column-parallel (d_in, d_out)
# and row-parallel (d_out, d_in) (layers.py:156-164).
COL = ("fsdp", "tp")
ROW = ("tp", "fsdp")
NORM = (None,)
EMBED = ("vocab", "fsdp")
HEAD = ("fsdp", "vocab")


def init_params(spec_tree: Any, generator: torch.Generator) -> Any:
    """Materialize parameters from a PSpec tree, one leaf at a time, each
    in its spec's dtype (bf16 but the MoE router's f32), on the
    generator's device, with the init rules of ``repro.models.
    layers.init_params`` (normal with std 1/sqrt(fan_in), ``small`` std
    0.02, zeros).  Stacked leaves are drawn one layer slice at a time so
    the f32 draw never holds more than one slice."""
    device = generator.device

    def one(spec: PSpec) -> torch.Tensor:
        dtype = spec.dtype
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


def unstack(tree: Any) -> list:
    """The layers of a stacked tree (every leaf (L, ...)) as L trees of
    views, cut with one ``torch.unbind`` a leaf: autograd then gathers a
    leaf's gradients of every layer in one stack onto the stacked leaf,
    where an indexed view a layer would add a zero-filled gradient of the
    whole leaf per layer."""
    if isinstance(tree, dict):
        parts = {k: unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return torch.unbind(tree)


def checkpointed(body: Callable, on: bool) -> Callable:
    """``body`` itself, or with ``on`` the body recomputed in the backward
    from its inputs (``torch.utils.checkpoint``, non-reentrant): nothing
    of the body is kept for the backward, the counterpart of JAX's
    ``jax.checkpoint(policy=nothing_saveable)``.  The layers draw no
    random numbers, so the recompute keeps no RNG state."""
    if not on:
        return body
    return functools.partial(torch.utils.checkpoint.checkpoint, body,
                             use_reentrant=False, preserve_rng_state=False)


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


_FREQS: dict = {}


def rope_freqs(dh: int, theta: float, device=None) -> torch.Tensor:
    """The (D/2,) f32 inverse frequencies, made once per (dh, theta,
    device) and kept; inside a graph capture, whose allocations belong to
    the graph, they are made anew and not kept."""
    device = torch.device("cpu" if device is None else device)
    key = (dh, theta, device)
    freqs = _FREQS.get(key)
    if freqs is None:
        with torch.inference_mode(False):  # usable under autograd later
            freqs = 1.0 / (theta ** (torch.arange(
                0, dh, 2, dtype=torch.float32, device=device) / dh))
        if not (device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            _FREQS[key] = freqs
    return freqs


def rope_tables(positions: torch.Tensor, dh: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rotation at ``positions`` ((S,) or (B, S)) over both halves of
    a head: (cos, sin), each (B or 1, S, 1, D) f32, sin negated over the
    first half.  One pair serves a layer's q and k."""
    angles = positions[..., None].float() * rope_freqs(dh, theta,
                                                       positions.device)
    if angles.dim() == 2:
        angles = angles[None]
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], dim=-1)[:, :, None, :],
            torch.cat([-sin, sin], dim=-1)[:, :, None, :])


def rotate(x: torch.Tensor, tables: tuple) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, D) by ``rope_tables``' pair, on
    split halves (not interleaved pairs): [x1 cos - x2 sin, x2 cos + x1
    sin] in f32."""
    cos, sin = tables
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    return (xf * cos + torch.cat([x2, x1], dim=-1) * sin).to(x.dtype)


# --------------------------------------------------------------------------
# MLP block
# --------------------------------------------------------------------------


def mlp_specs(d: int, f: int, kind: str) -> dict[str, PSpec]:
    """The MLP's leaves (layers.py:153-165): gated (``swiglu``, ``geglu``)
    ``w_gate``/``w_up``/``w_down``, or ``gelu`` ``w_up``/``w_down`` with
    zero-initialised biases."""
    if kind in ("swiglu", "geglu"):
        return {"w_gate": PSpec((d, f), COL), "w_up": PSpec((d, f), COL),
                "w_down": PSpec((f, d), ROW)}
    return {"w_up": PSpec((d, f), COL),
            "b_up": PSpec((f,), ("tp",), init="zeros"),
            "w_down": PSpec((f, d), ROW),
            "b_down": PSpec((d,), NORM, init="zeros")}


def _mlp_act(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """The column-parallel half of the MLP: the up (and gate) projections
    and the activation, (…, d_ff) or a member's columns of it."""
    if kind in ("swiglu", "geglu"):
        gate = x @ params["w_gate"]
        up = x @ params["w_up"]
        act = (F.silu(gate.float()) if kind == "swiglu"
               else F.gelu(gate.float(), approximate="tanh"))
        return act.to(x.dtype) * up
    h = x @ params["w_up"] + params["b_up"]
    return F.gelu(h.float(), approximate="tanh").to(x.dtype)


def _mlp_down(params: dict, h: torch.Tensor, kind: str) -> torch.Tensor:
    """The row-parallel half: ``w_down`` over the whole of d_ff."""
    out = h @ params["w_down"]
    return out if kind in ("swiglu", "geglu") else out + params["b_down"]


def mlp_apply(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """SwiGLU, GeGLU or GELU-with-biases MLP; the activation runs in f32
    and casts back (layers.py:168-180).  GELU is the tanh approximation,
    as JAX's ``gelu(approximate=True)``: the exact erf form differs by
    about 1e-3, enough to flip greedy near-ties."""
    return _mlp_down(params, _mlp_act(params, x, kind), kind)


def mlp_tp(lps: list, hs: list, kind: str, group: TPGroup, d_ff: int
           ) -> list:
    """The MLP of a sharded pod: each member's columns of the activation
    (its slices of ``w_gate``/``w_up``/``b_up``), gathered in member order
    before ``w_down``, which each member runs whole (layers.py:168-180
    under ``serve_pspec``).  lps, hs: each member's leaves and input;
    returns each member's output."""
    acts = gather_cols([_mlp_act(lp, h, kind) for lp, h in zip(lps, hs)],
                       group, d_ff)
    return [_mlp_down(lp, a, kind) for lp, a in zip(lps, acts)]

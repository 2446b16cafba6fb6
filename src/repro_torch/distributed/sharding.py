"""Logical sharding rules and the serving pod's member group (counterpart
of ``repro.distributed.sharding``).

Models declare every parameter and cache dim by a *logical* name
(``"tp"``, ``"vocab"``, ``"kv_heads"``, ``"layers"``, ...).  The rules
below resolve those names to a spec tuple against a set of named axis
sizes (``{"serve": 2}``, ``{"model": 4, "data": 2}``): one entry per dim,
``None`` for a dim that stays whole, an axis name (or a tuple of them) for
a dim split over those axes.  They are plain functions of ``(names,
shape, axis_sizes)`` with JAX's divisibility and exclusivity rules, so
the port's plan for a shape is JAX's ``PartitionSpec`` entry for entry.

A sharded pod is one process driving an ordered list of member devices,
the counterpart of JAX's one-controller ``tp_mesh``: ``TPGroup``.  Its
one axis is ``SERVE_AXIS``; ``serve_pspec`` places a parameter on it
column-only (output dims split, contraction rows replicated), so every
exchange between members is a gather of exact per-member results.  A
pod's streams are one device's wherever a column slice's product equals
the slice of the full product: so in f32 on the CPU (the tests), not
always on the card, where cuBLAS may run another kernel for fewer
columns and the port's attention kernels take bf16 only (PERF.md,
``scripts/pod_exactness_probe.py``).  ``shard_put`` turns a tree
into one tree per member, each leaf its member's slice or a full copy on
the member's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch

from repro_torch import resolve_device
from repro_torch.core.model_sharing import pytree_nbytes

# The serving-path tensor axis: distinct from the training axis "model",
# so that no rule which splits a contraction maps to it.
SERVE_AXIS = "serve"

# Logical dimension name -> preferred mesh axes (in order).  ``"tp"`` is
# the parameter rule JAX's ``repro.models.layers`` adds on import.
RULES: dict[Optional[str], tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "seq_shard": ("pod", "data"),
    "d_model": (),
    "heads": ("model", SERVE_AXIS),
    "kv_heads": ("model", SERVE_AXIS),
    "d_ff": ("model",),
    "vocab": ("model",),
    "fsdp": ("data",),
    "experts": ("model",),
    "layers": (),
    "state": (),
    "tp": ("model",),
    None: (),
}

Spec = tuple  # one entry per dim: None, an axis name, or a tuple of names


def _axes_in(axis_sizes: dict[str, int], axes: Sequence[str]
             ) -> tuple[str, ...]:
    return tuple(a for a in axes if a in axis_sizes)


def resolve_pspec(names: Sequence[Optional[str]], shape: Sequence[int],
                  axis_sizes: dict[str, int]) -> Spec:
    """Logical names -> spec, dropping rules that do not divide: each dim
    takes the longest prefix of its preferred axes whose product divides
    it, and an axis shards at most one dim of a tensor."""
    if len(names) != len(shape):
        raise ValueError(f"rank mismatch: {names} vs shape {shape}")
    spec: list[Any] = []
    used: set[str] = set()
    for name, dim in zip(names, shape):
        axes = _axes_in(axis_sizes, RULES.get(name, ()))
        axes = tuple(a for a in axes if a not in used)
        while axes and dim % math.prod(axis_sizes[a] for a in axes) != 0:
            axes = axes[:-1]
        if axes:
            used.update(axes)
            spec.append(axes if len(axes) > 1 else axes[0])
        else:
            spec.append(None)
    return tuple(spec)


def cache_pspec(shape: Sequence[int], axis_sizes: dict[str, int],
                layout: Sequence[Optional[str]] = ("layers", "batch", "seq",
                                                   "kv_heads", None)
                ) -> Spec:
    """KV-cache spec: an axis that neither the batch nor the kv heads can
    take moves to the sequence dim (context parallelism), and when even
    that does not divide, the plain ``resolve_pspec`` result stands."""
    names = list(layout)
    if "batch" not in names or "seq" not in names:
        return resolve_pspec(names, shape, axis_sizes)
    b_idx, s_idx = names.index("batch"), names.index("seq")
    seq_axes: list[str] = []
    dp_axes = _axes_in(axis_sizes, RULES["batch"])
    dp = math.prod(axis_sizes[a] for a in dp_axes)
    if dp and shape[b_idx] % dp != 0:
        names[b_idx] = None
        seq_axes.extend(dp_axes)
    if "kv_heads" in names:
        k_idx = names.index("kv_heads")
        tp_axes = _axes_in(axis_sizes, RULES["kv_heads"])
        tp = math.prod(axis_sizes[a] for a in tp_axes)
        if tp and shape[k_idx] % tp != 0:
            names[k_idx] = None
            seq_axes.extend(tp_axes)
    if seq_axes:
        total = math.prod(axis_sizes[a] for a in seq_axes)
        if shape[s_idx] % total == 0:
            parts = list(resolve_pspec(names, shape, axis_sizes))
            parts[s_idx] = (tuple(seq_axes) if len(seq_axes) > 1
                            else seq_axes[0])
            return tuple(parts)
    return resolve_pspec(names, shape, axis_sizes)


def serve_pspec(names: Sequence[Optional[str]], shape: Sequence[int],
                axis_sizes: dict[str, int]) -> Spec:
    """Column-only placement of a serving parameter: a trailing ``"tp"``
    dim (the column-parallel projections and their biases) and any
    ``"vocab"`` dim split over ``SERVE_AXIS`` when they divide it;
    everything else, the row-parallel ``"tp"`` of ``wo``/``w_down``
    first, is replicated, so every dot runs its whole reduction on one
    member."""
    if len(names) != len(shape):
        raise ValueError(f"rank mismatch: {names} vs shape {shape}")
    n = axis_sizes.get(SERVE_AXIS, 0)
    spec = []
    for i, (name, dim) in enumerate(zip(names, shape)):
        col = name == "vocab" or (name == "tp" and i == len(names) - 1)
        spec.append(SERVE_AXIS if (col and n > 1 and dim % n == 0)
                    else None)
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """A pod's members in order, primary first: the device each runs on
    (members may share one) and the fleet node each stands for."""

    devices: tuple[torch.device, ...]
    nodes: tuple[int, ...]

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        return self.devices[0]

    @property
    def axis_sizes(self) -> dict[str, int]:
        return {SERVE_AXIS: self.n}

    @property
    def one_device(self) -> bool:
        """Whether every member lies on the primary's device."""
        return all(d == self.primary for d in self.devices)

    def weights_key(self, fn: str) -> str:
        """The store key of ``fn``'s member trees on the primary:
        ``"{fn}@tp{n}"`` as in JAX (engine.py:1183) when every member lies
        on the primary's device, else followed by the member devices, so
        that a pod on other devices never takes trees placed for
        another."""
        key = f"{fn}@tp{self.n}"
        if self.one_device:
            return key
        return key + ":" + ",".join(str(d) for d in self.devices)


def tp_group(shards: int, devices: Optional[Sequence[Any]] = None,
             nodes: Optional[Sequence[int]] = None) -> Optional[TPGroup]:
    """The member group of a ``shards``-wide pod, or None at ``shards ==
    1``: the single-device path never sees a group.  ``devices`` names
    each member's device (default: the card, for every member);
    ``nodes`` the fleet node each member stands for (default 0..n-1)."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if shards == 1:
        return None
    devs = ([resolve_device(d) for d in devices] if devices is not None
            else [resolve_device(None)] * shards)
    if len(devs) != shards:
        raise ValueError(f"a {shards}-member group needs {shards} devices, "
                         f"got {len(devs)}")
    nodes = tuple(range(shards)) if nodes is None else tuple(nodes)
    if len(nodes) != shards:
        raise ValueError(f"a {shards}-member group needs {shards} nodes, "
                         f"got {len(nodes)}")
    return TPGroup(tuple(devs), nodes)


def serve_tp(group: Optional[TPGroup]) -> int:
    """The serving tensor degree of ``group``: 1 without one."""
    return 1 if group is None else group.n


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a leaf of ``spec`` lives in ``group``: member m holds slice m
    of every dim the spec splits (over ``SERVE_AXIS``, the group's one
    axis), and the whole of every other dim."""

    group: TPGroup
    spec: Spec

    def drop_leading(self) -> "Sharding":
        """The placement of one layer slice of a stacked leaf: the spec
        without its leading ``"layers"`` dim."""
        return Sharding(self.group, self.spec[1:])

    def shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """A member's shape of a leaf of ``shape``."""
        return tuple(d // self.group.n if entry is not None else d
                     for d, entry in zip(shape, self.spec))

    def piece(self, t: torch.Tensor, m: int) -> torch.Tensor:
        """Member ``m``'s view of ``t`` (no copy)."""
        if len(self.spec) != t.dim():
            raise ValueError(f"spec {self.spec} for a {t.dim()}-d tensor")
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            if entry not in (SERVE_AXIS, (SERVE_AXIS,)):
                raise ValueError(f"a serving group has only the "
                                 f"{SERVE_AXIS!r} axis, got {entry!r}")
            size = t.shape[d] // self.group.n
            t = t.narrow(d, m * size, size)
        return t

    def put(self, t: torch.Tensor) -> list[torch.Tensor]:
        """One new tensor per member: its piece of ``t``, copied onto its
        device (a replicated leaf is copied whole to every member)."""
        out = []
        for m, dev in enumerate(self.group.devices):
            piece = self.piece(t, m)
            dst = torch.empty(piece.shape, dtype=t.dtype, device=dev)
            out.append(dst.copy_(piece))
        return out


def gather_cols(parts: list, group: TPGroup, full: int) -> list:
    """The all-gather of a column-parallel result: each member's whole
    last dim, the members' pieces concatenated in member order on the
    member's device (members on one device share one copy; the copies
    stay on the device's stream, no host sync).  A replicated leaf's
    results, which hold all ``full`` columns already, pass through."""
    if parts[0].shape[-1] == full:
        return parts
    by_dev: dict = {}
    for dev in group.devices:
        if dev not in by_dev:
            by_dev[dev] = torch.cat([p.to(dev, non_blocking=True)
                                     for p in parts], dim=-1)
    return [by_dev[dev] for dev in group.devices]


def on_members(t: torch.Tensor, group: TPGroup) -> list:
    """``t`` on every member's device (one copy a device, shared)."""
    by_dev: dict = {}
    for dev in group.devices:
        if dev not in by_dev:
            by_dev[dev] = t.to(dev, non_blocking=True)
    return [by_dev[dev] for dev in group.devices]


def _walk(names_tree: Any, tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _walk(names_tree[k], v, fn) for k, v in tree.items()}
    return fn(names_tree, tree)


def _member_trees(placed: Any, n: int) -> list:
    """A tree of per-member lists -> a list of per-member trees."""
    def pick(tree, m):
        if isinstance(tree, dict):
            return {k: pick(v, m) for k, v in tree.items()}
        return tree[m]
    return [pick(placed, m) for m in range(n)]


def shard_put(tree: Any, names_tree: Any, group: TPGroup,
              resolver=resolve_pspec) -> list:
    """One tree per member: every leaf of ``tree`` (nested dicts of
    tensors) resolved by ``resolver(names, shape, axis_sizes)`` against
    ``group`` and copied onto each member's device, its slice of a split
    dim or the whole leaf.  ``names_tree`` mirrors ``tree`` with
    logical-name tuples at the leaves (``Model.param_names()``)."""
    placed = _walk(names_tree, tree, lambda names, leaf: Sharding(
        group, resolver(names, tuple(leaf.shape), group.axis_sizes))
        .put(leaf))
    return _member_trees(placed, group.n)


def sharding_for(names: Sequence[Optional[str]], shape: Sequence[int],
                 group: Optional[TPGroup], resolver=resolve_pspec
                 ) -> Optional[Sharding]:
    """The placement of one leaf in ``group`` by ``resolver`` (None
    without a group): what the fleet store uploads a pod's weights by,
    with ``serve_pspec``."""
    if group is None:
        return None
    return Sharding(group, resolver(names, shape, group.axis_sizes))


def per_member_bytes(group: TPGroup, *member_trees: Optional[list]
                     ) -> dict[int, int]:
    """Bytes each member holds of the given per-member tree lists (None
    skipped), keyed by the member's node: the counterpart of JAX's
    ``per_device_bytes``, by node because members may share a device."""
    out = {node: 0 for node in group.nodes}
    for trees in member_trees:
        if trees is None:
            continue
        for node, tree in zip(group.nodes, trees):
            out[node] += pytree_nbytes(tree)
    return out

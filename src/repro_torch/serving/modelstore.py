"""Fleet-level model store: a weight-swap cold-start tier (counterpart of
``repro.serving.modelstore``).

The per-node :class:`repro_torch.core.model_sharing.ModelStore` shares one
device-resident copy of a function's weights between co-located
instances (paper §3.5).  This module generalizes that into a *fleet*
tier:

    device memory  →  host RAM  →  peer node's host RAM  →  init from scratch

* ``FleetModelStore`` keeps a per-node host-RAM cache of *staged*
  weights (LRU with refcount pinning — a pod's live weights can never be
  evicted) and resolves every placement through the tier order above,
  counting hits, misses, and bytes moved.
* ``stage_params`` copies a param tree into ONE pinned host buffer (on a
  machine with a card) and splits it into per-layer shards: leaves
  stacked under a leading ``"layers"`` axis become one shard per layer.
  The shards are numpy views over that buffer, as JAX's are numpy
  arrays; ``StagedWeights.copy()`` (the peer transfer) pins its copy
  too.  A ``copy_`` from pageable memory is synchronous, so pinning is
  what lets the upload run in flight; it is paid once, at staging, inside
  the placement's measured cold-start window.
* ``upload_params`` re-assembles the tree on the device either
  ``"blocking"`` (each layer shard copied synchronously into its slice of
  the stacked leaf; the tree is resident when it returns — the reference
  mode) or ``"overlap"``: every stacked leaf is allocated once on the
  consumer's (current) stream, each layer shard is copied into ``dst[j]``
  with ``non_blocking=True`` on a side stream, and an event is recorded
  after the last copy.  The call returns with the copies in flight, and
  the consumer makes its stream wait on that event (``wait_event``,
  never a device-wide synchronize) before its first read: the frontend
  does so before it deploys the instance, so the instance's first
  admission and its graph captures are ordered after the upload.  Both
  modes give bit-identical tensors.

A re-upload (a node whose engine store no longer holds the weights) gives
new device addresses, so it only ever reaches instances built after it:
an instance's captured graphs keep the addresses of the tree it was
deployed with, which its engine store holds for as long as any instance
uses it.

The live frontend sources weights through ``acquire`` at placement time;
the control plane reads ``warm_nodes`` for warm-aware scale-up and defrag
targeting.  A sharded pod's placement passes ``sharding_for``: the
weights are staged whole, as for one device, and the upload copies each
member's slices straight to its device (modelstore.py:110-140 of the JAX
package), layer slice by layer slice.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from time import perf_counter
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = [
    "StagedWeights",
    "stage_params",
    "upload_params",
    "HostWeightCache",
    "ColdStartEvent",
    "FleetModelStore",
]

_ALIGN = 512  # byte alignment of each leaf in the staging buffer
# numpy has no bf16: a bf16 leaf is viewed as its 16-bit pattern.
_NP_VIEW = {torch.bfloat16: torch.int16}


def _flatten(tree: Any, prefix: tuple = ()) -> list:
    """``(path, leaf)`` pairs of a tree of nested dicts, keys sorted (the
    order ``jax.tree_util`` flattens dicts in, so leaf i here is leaf i
    of the JAX package's staged tree)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def _unflatten(paths: tuple, leaves: list) -> Any:
    if paths == ((),):
        return leaves[0]
    out: dict = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def _name_leaves(model) -> Optional[list]:
    """Leaf-aligned logical names for ``model``'s params, or None."""
    try:
        names = model.param_names()
    except Exception:
        return None
    return [name for _, name in _flatten(names)]


def _numpy_view(t: torch.Tensor) -> np.ndarray:
    return t.view(_NP_VIEW.get(t.dtype, t.dtype)).numpy()


@dataclass
class StagedWeights:
    """A param tree staged as host shards.

    ``leaves[i]`` is either one ndarray (unstacked leaf) or, when
    ``stacked[i]``, a list of per-layer ndarrays split along the leading
    ``"layers"`` axis — the unit of pipelined upload.  All of them are
    views over ``buffer``, one host byte tensor (pinned on a machine with
    a card); ``treedef`` holds the leaves' key paths, ``dtypes`` their
    torch dtypes (a bf16 leaf's numpy view holds its bit pattern) and
    ``layout`` each leaf's (byte offset, shape) in the buffer.
    """

    treedef: tuple
    leaves: List[Any]
    stacked: List[bool]
    nbytes: int
    dtypes: List[torch.dtype] = field(repr=False)
    layout: List[tuple] = field(repr=False)
    buffer: torch.Tensor = field(repr=False)

    @property
    def pinned(self) -> bool:
        return self.buffer.is_pinned()

    def host_tensor(self, i: int, j: Optional[int] = None) -> torch.Tensor:
        """Leaf ``i`` (or layer shard ``j`` of a stacked leaf) as a torch
        view of the buffer — what the upload copies from, so the pinned
        allocator tracks the copies that read it."""
        off, shape = self.layout[i]
        n = int(np.prod(shape)) * self.dtypes[i].itemsize
        t = self.buffer[off:off + n].view(self.dtypes[i]).view(shape)
        return t if j is None else t[j]

    def copy(self) -> "StagedWeights":
        """Deep host-to-host copy (the peer-transfer payload), pinned as
        the source is."""
        buf = torch.empty(self.buffer.shape, dtype=torch.uint8,
                          pin_memory=self.pinned)
        buf.copy_(self.buffer)
        return _staged_over(buf, self.treedef, self.dtypes, self.layout,
                            list(self.stacked), self.nbytes)


def _staged_over(buf: torch.Tensor, treedef: tuple, dtypes: list,
                 layout: list, stacked: list, nbytes: int) -> StagedWeights:
    staged = StagedWeights(treedef, [], stacked, nbytes, dtypes, layout, buf)
    for i, st in enumerate(stacked):
        arr = _numpy_view(staged.host_tensor(i))
        staged.leaves.append([arr[j] for j in range(arr.shape[0])]
                             if st else arr)
    return staged


def stage_params(model, params, *, pin: Optional[bool] = None
                 ) -> StagedWeights:
    """Stage a param tree (tensors on any device, or numpy arrays) into
    per-layer host shards of one host buffer, pinned when ``pin`` (default:
    when a card is present).  A device tree is copied with one
    asynchronous ``copy_`` per leaf into the pinned buffer and the
    device's current stream is synchronized once at the end."""
    if pin is None:
        pin = torch.cuda.is_available()
    flat = _flatten(params)
    names = _name_leaves(model)
    if names is not None and len(names) != len(flat):
        names = None
    leaves = [leaf if isinstance(leaf, torch.Tensor)
              else torch.from_numpy(np.ascontiguousarray(leaf))
              for _, leaf in flat]
    layout, stacked, off, nbytes = [], [], 0, 0
    for i, t in enumerate(leaves):
        name = names[i] if names is not None else ()
        stacked.append(bool(name) and name[0] == "layers" and t.dim() > 0
                       and t.shape[0] > 0)
        layout.append((off, tuple(t.shape)))
        size = t.numel() * t.element_size()
        nbytes += size
        off += -(-size // _ALIGN) * _ALIGN
    buf = torch.empty((off,), dtype=torch.uint8, pin_memory=pin)
    staged = _staged_over(buf, tuple(p for p, _ in flat),
                          [t.dtype for t in leaves], layout, stacked, nbytes)
    devices = set()
    for i, t in enumerate(leaves):
        staged.host_tensor(i).copy_(t, non_blocking=pin and t.is_cuda)
        if t.is_cuda:
            devices.add(t.device)
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()
    return staged


def upload_params(staged: StagedWeights, *, mode: str = "overlap",
                  device=None, shardings: Optional[List[Any]] = None):
    """Re-assemble staged shards on ``device`` (``None`` = the card).

    Returns ``(params, ready)``.  ``"blocking"`` copies every shard
    synchronously (``ready`` is None: the tree is resident).
    ``"overlap"`` on the card allocates each leaf once on the current
    stream, copies every layer shard into its slice with
    ``non_blocking=True`` on a side stream and returns at once, with
    ``ready`` the event recorded after the last copy: the consumer's
    stream must ``wait_event(ready)`` before it reads the tree.  On the
    CPU both modes copy synchronously.  Values are identical either way.

    ``shardings`` (leaf-aligned with ``staged.leaves``: a sharded pod's
    ``distributed.Sharding`` of each leaf) returns a list of member trees
    instead: each leaf's piece (``Sharding.piece``; a stacked leaf's
    layer slices placed by the spec without its leading ``"layers"`` dim,
    as JAX's ``_layer_sharding``) copied straight onto its member's
    device: members on one device share one upload of each leaf and
    take their pieces on the device; across devices a strided piece is
    staged through host memory by the copy.  The upload overlaps only
    when every member lies on ``device``; a group that spans devices
    uploads blocking.
    """
    if mode not in ("blocking", "overlap"):
        raise ValueError(f"unknown upload mode {mode!r}")
    dev = resolve_device(device)
    devices = [dev]
    if shardings is not None:
        if len(shardings) != len(staged.leaves):
            raise ValueError(f"shardings must align with staged leaves "
                             f"({len(shardings)} vs {len(staged.leaves)})")
        devices = list(shardings[0].group.devices)
    overlap = (mode == "overlap" and dev.type == "cuda"
               and all(d == dev for d in devices))

    # Members that share one device read one upload of each leaf (a
    # layer shard of a stacked leaf): the host-to-device copy of the whole
    # slice, contiguous from the staged buffer, then each member's piece
    # copied on the device.  Across devices each member's piece is copied
    # from the host, a strided piece through host memory.
    shared = all(d == devices[0] for d in devices)

    def piece(t: torch.Tensor, i: int, m: int,
              j: Optional[int] = None) -> torch.Tensor:
        if shardings is None:
            return t
        sh = shardings[i] if j is None else shardings[i].drop_leading()
        return sh.piece(t, m)

    out = [[torch.empty(shape if shardings is None
                        else shardings[i].shape(shape), dtype=dtype,
                        device=d)
            for i, ((_, shape), dtype) in enumerate(zip(staged.layout,
                                                        staged.dtypes))]
           for d in devices]
    side = ready = None
    if overlap:
        consumer = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(consumer)  # the allocations precede the copies
    with torch.cuda.stream(side) if overlap else contextlib.nullcontext():
        for i, st in enumerate(staged.stacked):
            if overlap:
                for leaves in out:
                    leaves[i].record_stream(side)
            for j in range(out[0][i].shape[0]) if st else (None,):
                src = staged.host_tensor(i, j)
                if shared and shardings is not None:
                    src = src.to(devices[0], non_blocking=overlap)
                for m, leaves in enumerate(out):
                    dst = leaves[i] if j is None else leaves[i][j]
                    dst.copy_(piece(src, i, m, j), non_blocking=overlap)
        if overlap:
            ready = torch.cuda.Event()
            ready.record(side)
    if not overlap:
        for d in set(devices):
            if d.type == "cuda":
                torch.cuda.current_stream(d).synchronize()
    trees = [_unflatten(staged.treedef, leaves) for leaves in out]
    return (trees[0] if shardings is None else trees), ready


@dataclass
class _CacheEntry:
    staged: StagedWeights
    nbytes: int
    pins: int = 0


class HostWeightCache:
    """One node's host-RAM weight cache: byte-budgeted LRU with pinning.

    ``pin``/``unpin`` track live pods whose weights came from this
    entry; eviction only ever considers unpinned entries and refuses
    (raises ``MemoryError``) rather than evict a pinned one.
    """

    def __init__(self, capacity_bytes: int = 4 << 30):
        if capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be positive")
        self.capacity_bytes = int(capacity_bytes)
        self._entries: "OrderedDict[str, _CacheEntry]" = OrderedDict()
        self.evictions = 0

    def contains(self, key: str) -> bool:
        return key in self._entries

    def keys(self):
        return list(self._entries)

    def used_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def pins(self, key: str) -> int:
        e = self._entries.get(key)
        return e.pins if e is not None else 0

    def get(self, key: str) -> StagedWeights:
        entry = self._entries[key]
        self._entries.move_to_end(key)
        return entry.staged

    def peek(self, key: str) -> Optional[StagedWeights]:
        entry = self._entries.get(key)
        return entry.staged if entry is not None else None

    def put(self, key: str, staged: StagedWeights) -> None:
        if key in self._entries:
            self._entries.move_to_end(key)
            return
        self._evict_for(staged.nbytes)
        self._entries[key] = _CacheEntry(staged, staged.nbytes)

    def pin(self, key: str) -> None:
        entry = self._entries.get(key)
        if entry is not None:
            entry.pins += 1

    def unpin(self, key: str) -> None:
        entry = self._entries.get(key)
        if entry is not None and entry.pins > 0:
            entry.pins -= 1

    def drop(self, key: str) -> None:
        self._entries.pop(key, None)

    def clear(self) -> None:
        self._entries.clear()

    def _evict_for(self, need_bytes: int) -> None:
        free = self.capacity_bytes - self.used_bytes()
        if free >= need_bytes:
            return
        # LRU order: oldest unpinned first.
        for key in list(self._entries):
            if free >= need_bytes:
                break
            entry = self._entries[key]
            if entry.pins > 0:
                continue
            del self._entries[key]
            self.evictions += 1
            free += entry.nbytes
        if free < need_bytes:
            raise MemoryError(
                f"host weight cache over capacity: need {need_bytes - free} "
                "more bytes but remaining entries are pinned"
            )


@dataclass
class ColdStartEvent:
    """One placement's trip through the weight tier.  ``upload_s`` is the
    host-side time of the upload call (the whole copy when blocking, its
    dispatch when overlapped); ``ready`` the overlapped upload's event."""

    fn: str
    node: int
    tier: str  # "device" | "host" | "peer" | "cold"
    mode: str  # "blocking" | "overlap"
    nbytes: int
    upload_s: float
    peer: Optional[int] = None
    ttft_s: Optional[float] = None  # resolved by the frontend
    placed_at: float = field(default=0.0, repr=False)
    ready: Optional[Any] = field(default=None, repr=False)


class FleetModelStore:
    """The fleet weight tier: per-node host caches + warm lookup.

    ``acquire`` resolves one placement: device-resident weights are
    reused as-is; a host hit re-uploads from the node's own cache; a
    peer hit copies the staged shards from another node's cache first
    (counted in ``bytes_peer``); a cold miss stages from ``params`` or
    ``loader()``.  Every non-device tier pins the host entry until
    ``release`` — live pods' weights are never evictable.
    """

    def __init__(self, host_budget_bytes: int = 4 << 30, *,
                 links: Optional[Any] = None):
        self.host_budget_bytes = int(host_budget_bytes)
        # Optional NetworkLinks graph: peer selection then prefers the
        # candidate with the fastest link to the acquiring node instead
        # of the lowest node id (the frontend wires its own graph in).
        self.links = links
        self._caches: Dict[int, HostWeightCache] = {}
        self._lock = threading.Lock()
        self.device_hits = 0
        self.host_hits = 0
        self.peer_hits = 0
        self.cold_misses = 0
        self.bytes_h2d = 0
        self.bytes_peer = 0
        self.bytes_staged = 0
        self.events: List[ColdStartEvent] = []

    def _cache_for(self, node: int) -> HostWeightCache:
        cache = self._caches.get(node)
        if cache is None:
            cache = self._caches[node] = HostWeightCache(self.host_budget_bytes)
        return cache

    def warm_nodes(self, key: str) -> List[int]:
        """Nodes whose host cache holds ``key`` (ascending id)."""
        with self._lock:
            return sorted(n for n, c in self._caches.items() if c.contains(key))

    def staged_nbytes(self, key: str) -> Optional[int]:
        """Byte size of ``key``'s staged weights, from any node's cache."""
        with self._lock:
            for cache in self._caches.values():
                staged = cache.peek(key)
                if staged is not None:
                    return staged.nbytes
        return None

    def acquire(
        self,
        node: int,
        key: str,
        model,
        params=None,
        loader: Optional[Callable[[], Any]] = None,
        *,
        resident: bool = False,
        mode: str = "overlap",
        sharding_for: Optional[Callable[[tuple, tuple], Any]] = None,
        device=None,
    ):
        """Source ``key``'s weights for a placement on ``node``, uploaded
        to ``device`` (``None`` = the card).

        Returns ``(device_params, ColdStartEvent)`` and pins the host
        entry backing them (pair with :meth:`release`).  After an
        overlapped upload ``event.ready`` is the event the consumer's
        stream must wait on before reading the params.
        ``sharding_for(names, shape) -> Sharding`` resolves each param
        leaf's placement in a sharded pod: the upload then streams every
        member's slices straight to its device and returns the member
        trees (the staged entry is the whole tree, shared with one-device
        placements).
        """
        with self._lock:
            cache = self._cache_for(node)
            if resident:
                # Device tier: the node's engine ModelStore already holds
                # the tree — ``params`` is returned untouched (it may be
                # None; the engine deploy ignores it on a store hit).
                self.device_hits += 1
                cache.pin(key)
                event = ColdStartEvent(key, node, "device", mode, 0, 0.0,
                                       placed_at=perf_counter())
                self.events.append(event)
                return params, event

            peer = None
            if cache.contains(key):
                tier = "host"
                self.host_hits += 1
                staged = cache.get(key)
            else:
                cands = [n for n in sorted(self._caches)
                         if n != node and self._caches[n].contains(key)]
                if self.links is not None and cands:
                    # Bandwidth-aware: pull from the warm peer with the
                    # fastest link to this node (ties to lowest id).
                    peer = self.links.best_peer(node, cands)
                else:
                    peer = cands[0] if cands else None
                if peer is not None:
                    tier = "peer"
                    self.peer_hits += 1
                    staged = self._caches[peer].peek(key).copy()
                    self.bytes_peer += staged.nbytes
                    cache.put(key, staged)
                else:
                    tier = "cold"
                    self.cold_misses += 1
                    if params is None and loader is None:
                        raise ValueError(
                            f"cold miss for {key!r} with neither params "
                            "nor a loader")
                    source = params if params is not None else loader()
                    staged = stage_params(model, source)
                    self.bytes_staged += staged.nbytes
                    cache.put(key, staged)
            cache.pin(key)

        shardings = None
        if sharding_for is not None:
            names = _name_leaves(model)
            shardings = [sharding_for(nm, ((len(leaf),) + leaf[0].shape)
                                      if st else leaf.shape)
                         for nm, leaf, st in zip(names, staged.leaves,
                                                 staged.stacked)]
        t0 = perf_counter()
        device_params, ready = upload_params(staged, mode=mode,
                                             device=device,
                                             shardings=shardings)
        upload_s = perf_counter() - t0
        with self._lock:
            self.bytes_h2d += staged.nbytes
            event = ColdStartEvent(key, node, tier, mode, staged.nbytes,
                                   upload_s, peer=peer,
                                   placed_at=perf_counter(), ready=ready)
            self.events.append(event)
        return device_params, event

    def release(self, node: int, key: str) -> None:
        """Unpin one placement's hold on ``key``'s host entry."""
        with self._lock:
            cache = self._caches.get(node)
            if cache is not None:
                cache.unpin(key)

    def drop_node(self, node: int) -> None:
        """A node died: its host RAM (and every pin on it) is gone."""
        with self._lock:
            cache = self._caches.pop(node, None)
            if cache is not None:
                cache.clear()

    def cache(self, node: int) -> HostWeightCache:
        with self._lock:
            return self._cache_for(node)

    def telemetry(self) -> dict:
        with self._lock:
            return {
                "device_hits": self.device_hits,
                "host_hits": self.host_hits,
                "peer_hits": self.peer_hits,
                "cold_misses": self.cold_misses,
                "bytes_h2d": self.bytes_h2d,
                "bytes_peer": self.bytes_peer,
                "bytes_staged": self.bytes_staged,
                "host_used_bytes": {
                    n: c.used_bytes() for n, c in self._caches.items()
                },
                "events": len(self.events),
            }

"""Model sharing (paper §3.5): one weight copy per function per node.

The paper shares model tensors between instances of the same function via
CUDA IPC handles exported by a Model Storage Server.  In the port the N
instances of a function are handed *the same* param tree of device
tensors; the runtime never copies it.  What remains to build is the
*bookkeeping*: a per-node store with STORE/GET semantics, refcounts,
eviction, and exact memory accounting (reproducing Fig. 13).

Two layers:

* ``ModelStore`` — the live store used by the serving engine; holds real
  trees (torch tensors or numpy) keyed by (function, tensor-set id).
* ``MemoryModel`` — closed-form per-node device-memory accounting used
  by the scheduler's admission control and the Fig.-13 benchmark:
  ``no_share(n) = n * (framework + weights)``;
  ``share(n) = (weights + server_overhead) + n * framework``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

# Fixed per-model overhead of the storage-server process context measured by
# the paper on V100 (§5.5, hatched areas of Fig. 13).
SERVER_CONTEXT_OVERHEAD = 300 * 1024 * 1024


def pytree_nbytes(tree: Any) -> int:
    """Total bytes of all leaf buffers in a tree of nested dicts of torch
    tensors or numpy arrays (the torch counterpart of the JAX package's
    ``jax.tree_util`` walk)."""
    if isinstance(tree, dict):
        return sum(pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, list):  # a sharded pod's member trees
        return sum(pytree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(np.asarray(tree).nbytes)


@dataclasses.dataclass
class _Entry:
    tree: Any
    nbytes: int
    refcount: int = 0


class ModelStore:
    """Per-node shared weight store with STORE()/GET() (paper Fig. 7).

    ``get`` is the hot path: it returns the stored pytree *by reference*
    (zero-copy) and bumps the refcount; ``put_back`` releases.  A miss with a
    ``loader`` triggers the STORE path, exactly like the paper's GET-miss
    falling back to STORE.
    """

    def __init__(self, capacity_bytes: Optional[int] = None):
        self._entries: dict[str, _Entry] = {}
        self._lock = threading.Lock()
        self.capacity_bytes = capacity_bytes
        self.stores = 0
        self.hits = 0
        self.misses = 0

    # -- STORE -----------------------------------------------------------

    def store(self, key: str, tree: Any) -> int:
        """Insert (or overwrite) the tensor set for ``key``; returns bytes."""
        nbytes = pytree_nbytes(tree)
        with self._lock:
            if self.capacity_bytes is not None:
                projected = self.used_bytes_locked() + nbytes - (
                    self._entries[key].nbytes if key in self._entries else 0
                )
                if projected > self.capacity_bytes:
                    self._evict_locked(projected - self.capacity_bytes)
            old = self._entries.get(key)
            refcount = old.refcount if old else 0
            self._entries[key] = _Entry(tree=tree, nbytes=nbytes, refcount=refcount)
            self.stores += 1
        return nbytes

    # -- GET -------------------------------------------------------------

    def get(self, key: str, loader: Optional[Callable[[], Any]] = None) -> Any:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry.refcount += 1
                self.hits += 1
                return entry.tree
            self.misses += 1
        if loader is None:
            raise KeyError(f"model {key!r} not in store and no loader given")
        tree = loader()
        self.store(key, tree)
        with self._lock:
            self._entries[key].refcount += 1
        return tree

    def put_back(self, key: str) -> None:
        with self._lock:
            entry = self._entries[key]
            if entry.refcount <= 0:
                raise RuntimeError(f"refcount underflow for {key!r}")
            entry.refcount -= 1

    # -- accounting / eviction --------------------------------------------

    def used_bytes_locked(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def used_bytes(self) -> int:
        with self._lock:
            return self.used_bytes_locked()

    def refcount(self, key: str) -> int:
        with self._lock:
            return self._entries[key].refcount if key in self._entries else 0

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._entries

    def _evict_locked(self, need_bytes: int) -> None:
        """Evict unreferenced entries (largest first) to free ``need_bytes``."""
        freed = 0
        victims = sorted(
            (k for k, e in self._entries.items() if e.refcount == 0),
            key=lambda k: -self._entries[k].nbytes,
        )
        for k in victims:
            if freed >= need_bytes:
                break
            freed += self._entries.pop(k).nbytes
        if freed < need_bytes:
            raise MemoryError(
                f"model store over capacity: need {need_bytes} more bytes but "
                f"only {freed} evictable"
            )


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """Closed-form footprint of a function's instances on one node (Fig. 13).

    ``framework_bytes`` is the per-instance runtime footprint (framework,
    activations, CUDA/XLA context); ``weight_bytes`` the parameters.
    """

    weight_bytes: int
    framework_bytes: int
    server_overhead: int = SERVER_CONTEXT_OVERHEAD

    def footprint(self, n_instances: int, sharing: bool, *,
                  server: bool = True) -> int:
        """Bytes ``n_instances`` of this function occupy on a node.

        ``server=False`` drops the storage-server context from the shared
        footprint — used by :func:`node_shared_footprint` when ONE store
        tier owns every function's weights on the node, so the context is
        charged once per tier rather than once per function.
        """
        if n_instances == 0:
            return 0
        if not sharing:
            return n_instances * (self.weight_bytes + self.framework_bytes)
        server_bytes = self.server_overhead if server else 0
        return (self.weight_bytes + server_bytes
                + n_instances * self.framework_bytes)

    def reduction(self, n_instances: int) -> float:
        """Fractional footprint reduction from sharing at ``n_instances``."""
        base = self.footprint(n_instances, sharing=False)
        shared = self.footprint(n_instances, sharing=True)
        return 1.0 - shared / base

    def max_instances(self, capacity_bytes: int, sharing: bool) -> int:
        """How many instances fit in ``capacity_bytes`` (Fig.-13 claim:
        7 ResNeXt pods with sharing vs 4 without on a 16G V100)."""
        n = 0
        while self.footprint(n + 1, sharing) <= capacity_bytes:
            n += 1
        return n


def node_shared_footprint(entries) -> int:
    """Node footprint when one store TIER owns every function's weights.

    The paper's Fig.-13 model charges one storage-server context per
    shared function; with the fleet model store there is exactly one
    server process per node, so the context is charged ONCE per node —
    ``max`` of the participating overheads, conservatively covering the
    largest context any function would have needed.

    ``entries`` iterates ``(MemoryModel, n_instances)`` pairs for the
    functions resident on the node (``n_instances == 0`` pairs are
    skipped).
    """
    total = 0
    overhead = 0
    for mm, n in entries:
        if n <= 0:
            continue
        total += mm.footprint(n, sharing=True, server=False)
        overhead = max(overhead, mm.server_overhead)
    return total + overhead

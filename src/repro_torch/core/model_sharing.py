"""Model sharing (paper §3.5): one weight copy per function per node.

The paper shares model tensors between instances of the same function via
CUDA IPC handles exported by a Model Storage Server.  In the port the N
instances of a function are handed *the same* param tree of device
tensors; the runtime never copies it.  What remains to build is the
*bookkeeping*: a per-node store with STORE/GET semantics, refcounts,
eviction, and exact memory accounting (reproducing Fig. 13).

``ModelStore`` is the live store used by the serving engine; it holds
real trees (torch tensors or numpy) keyed by (function, tensor-set id).
The closed-form ``MemoryModel`` of the JAX package arrives with the
placement frontend (ROADMAP.md, Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch


def pytree_nbytes(tree: Any) -> int:
    """Total bytes of all leaf buffers in a tree of nested dicts of torch
    tensors or numpy arrays (the torch counterpart of the JAX package's
    ``jax.tree_util`` walk)."""
    if isinstance(tree, dict):
        return sum(pytree_nbytes(v) for v in tree.values())
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

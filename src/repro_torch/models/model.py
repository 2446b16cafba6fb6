"""``Model``: family dispatch, steps and cache factories (counterpart of
``repro.models.model.Model`` for the families ported so far: the
full-cache dense SwiGLU family, RWKV-6 and the Hymba hybrid).

Cache leaves follow ``cache_shapes``/``paged_cache_shapes`` of the JAX
package (model.py:169-232, 316-342): bf16 K/V, or under the int8 gate
int8 codes plus (…, K, 1) bf16 scales; for rwkv an f32 ``wkv`` state and
bf16 token-shift rows; for the hybrid rolled bf16 K/V and an f32 ``ssm``
state (the int8 gate never applies to either).  The int8 gate
(``REPRO_KV_INT8``) is read where a cache is made — ``prefill``,
``init_slot_cache``, ``init_paged_cache`` — unless the caller pins it with
``kv_int8=``, as a serving instance does.
The cache methods that JAX expresses as functional updates of donated
buffers (``merge_slot``, ``append_paged``) write the preallocated pools in
place here, and refuse an entry whose leaves or dtypes differ from the
pool's instead of casting it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models import attention, hybrid, rwkv6, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (init_params, param_count,
                                      param_logical_names)

_FAMILY = {"dense": transformer, "rwkv": rwkv6, "hybrid": hybrid}


def default_kv_blocks(max_batch: int, max_len: int, block_size: int) -> int:
    """Default pool: the dense slot pool's total block count (one of which
    becomes the null page), minimum 2 (model.py:40-49)."""
    return max(max_batch * (-(-max_len // block_size)), 2)


def _nbytes(specs: dict) -> int:
    return sum(int(np.prod(shape)) * dtype.itemsize
               for shape, dtype in specs.values())


def _zeros(specs: dict, device) -> dict:
    return {key: torch.zeros(shape, dtype=dtype, device=device)
            for key, (shape, dtype) in specs.items()}


def _check_entry(what: str, pool: dict, entry: dict) -> None:
    """An entry must bring exactly the pool's leaves in the pool's dtypes:
    a silent cast would, for one, truncate bf16 K/V into int8 codes."""
    keys = set(pool) - {"pos"}
    if set(entry) - {"pos"} != keys:
        raise ValueError(f"{what}: entry leaves {sorted(entry)} do not match "
                         f"the pool's {sorted(pool)}")
    for key in sorted(keys):
        if entry[key].dtype != pool[key].dtype:
            raise TypeError(f"{what}: entry leaf {key!r} is "
                            f"{entry[key].dtype}, the pool holds "
                            f"{pool[key].dtype}")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self) -> None:
        cfg = self.cfg
        if cfg.family not in _FAMILY or (
                cfg.family == "dense" and not transformer.supports_paged(cfg)):
            raise NotImplementedError(
                f"{cfg.name}: the port serves the full-cache dense SwiGLU "
                f"family, rwkv6 and the hybrid so far (others: ROADMAP.md, "
                f"Queue 1)")

    @functools.cached_property
    def specs(self) -> Any:
        if self.cfg.family == "rwkv":
            return rwkv6.rwkv_specs(self.cfg)
        if self.cfg.family == "hybrid":
            return hybrid.hybrid_specs(self.cfg)
        return transformer.decoder_specs(self.cfg)

    # -- params -----------------------------------------------------------

    def init(self, generator: torch.Generator) -> Any:
        """bf16 parameters from ``generator``, drawn leaf by leaf on the
        generator's device."""
        return init_params(self.specs, generator)

    def param_names(self) -> Any:
        """The logical-name tuple of every param leaf, in the params'
        nesting (model.py:68): ``("layers", None, ...)`` for a stacked
        leaf, all ``None`` otherwise."""
        return param_logical_names(self.specs)

    def n_params(self) -> int:
        return param_count(self.specs)

    # -- steps ---------------------------------------------------------------

    def kv_int8(self) -> bool:
        """Whether a cache made now holds int8 K/V (the process gate)."""
        return attention.kv_int8_enabled(self.cfg)

    def _int8(self, kv_int8: Optional[bool]) -> bool:
        return self.kv_int8() if kv_int8 is None else kv_int8

    def prefill(self, params, tokens, *, max_len=None, length=None,
                kv_int8: Optional[bool] = None):
        if self.cfg.family in ("rwkv", "hybrid"):
            if length is not None:
                raise NotImplementedError(
                    f"{self.cfg.family} prefill runs at the exact prompt "
                    f"length")
            return _FAMILY[self.cfg.family].prefill(params, tokens, self.cfg,
                                                    max_len=max_len)
        return transformer.prefill(params, tokens, self.cfg, max_len=max_len,
                                   length=length, kv_int8=self._int8(kv_int8))

    def supports_bucketed_prefill(self) -> bool:
        """Right-padded prompts need full per-position caches: pad tokens
        would enter an rwkv or SSM recurrence, and a sliding-window cache
        is not addressed by absolute position (model.py:88-92)."""
        return self.cfg.family == "dense" and self.cfg.sliding_window is None

    def supports_paged(self) -> bool:
        return transformer.supports_paged(self.cfg)

    def decode_step(self, params, token, cache):
        return _FAMILY[self.cfg.family].decode_step(params, token, cache,
                                                    self.cfg)

    def decode_step_paged(self, params, token, cache, block_tables, pos):
        return transformer.decode_step_paged(params, token, cache,
                                             block_tables, pos, self.cfg)

    def sample_greedy(self, logits):
        return transformer.greedy_tokens(logits, self.cfg)

    def decode_step_tokens(self, params, token, cache):
        """One round returning ((B,) int32 tokens, cache); the logits never
        leave the device (model.py:110-128)."""
        if self.cfg.family == "dense":
            return transformer.decode_step_tokens(params, token, cache,
                                                  self.cfg)
        logits, cache = self.decode_step(params, token, cache)
        return transformer.greedy_tokens(logits, self.cfg), cache

    def decode_step_paged_tokens(self, params, token, cache, block_tables,
                                 pos, active):
        return transformer.decode_step_paged_tokens(
            params, token, cache, block_tables, pos, active, self.cfg)

    # -- cache layouts ---------------------------------------------------------

    def cache_specs(self, batch: int, max_len: int,
                    kv_int8: Optional[bool] = None) -> dict:
        """{leaf: (shape, dtype)} of a cache of ``batch`` sequences, ``pos``
        excluded (model.py:169-232)."""
        if self.cfg.family == "rwkv":
            return rwkv6.cache_specs(self.cfg, batch)
        if self.cfg.family == "hybrid":
            return hybrid.cache_specs(self.cfg, batch, max_len)
        return transformer.cache_specs(self.cfg, batch, max_len,
                                       self._int8(kv_int8))

    def paged_cache_specs(self, n_blocks: int, block_size: int,
                          kv_int8: Optional[bool] = None) -> dict:
        """{leaf: (shape, dtype)} of the paged pools (model.py:316-342)."""
        if not self.supports_paged():
            raise NotImplementedError(
                f"{self.cfg.name}: paged KV needs a full-cache dense config")
        return transformer.cache_specs(self.cfg, n_blocks, block_size,
                                       self._int8(kv_int8))

    # -- slot caches (continuous batching) ---------------------------------

    def init_slot_cache(self, n_slots: int, max_len: int, device=None,
                        kv_int8: Optional[bool] = None) -> dict:
        """Persistent decode-slot pool with a per-slot position vector."""
        cache = _zeros(self.cache_specs(n_slots, max_len, kv_int8), device)
        cache["pos"] = torch.zeros((n_slots,), dtype=torch.int32,
                                   device=device)
        return cache

    def merge_slot(self, cache: dict, entry: dict, slot) -> dict:
        """Copy a batch-1 prefill ``entry`` into slot ``slot`` of the pool,
        in place, leaf by leaf (every leaf's batch axis is 1; a
        device-to-device copy, no host sync).  ``slot`` is a host int or a
        (1,) int64 tensor on the pool's device, read there: a captured
        admission then serves every slot."""
        _check_entry("merge_slot", cache, entry)
        for key, leaf in cache.items():
            axis, src = ((0, entry["pos"].reshape(1)) if key == "pos"
                         else (1, entry[key]))
            if torch.is_tensor(slot):
                leaf.index_copy_(axis, slot, src)
            else:
                leaf.narrow(axis, slot, 1).copy_(src)
        return cache

    def gather_slot(self, cache: dict, slot: int) -> dict:
        """Slot ``slot`` of a pool as a batch-1 cache with a scalar pos
        (the inverse of ``merge_slot``)."""
        return {key: (leaf[slot] if key == "pos"
                      else leaf[:, slot:slot + 1]).clone()
                for key, leaf in cache.items()}

    # -- paged caches ---------------------------------------------------------

    def init_paged_cache(self, n_blocks: int, block_size: int, device=None,
                         kv_int8: Optional[bool] = None) -> dict:
        """Zeroed paged pools (block 0 is the engine's null block; a
        serving instance asks for one block more than its allocator holds,
        the write-only sink of ``append_paged``)."""
        return _zeros(self.paged_cache_specs(n_blocks, block_size, kv_int8),
                      device)

    def append_paged(self, cache: dict, entry: dict, block_row,
                     write=None) -> dict:
        """Scatter a batch-1 prefill ``entry`` (``max_len`` rows, a multiple
        of the block size) into physical pages of every leaf, in place:
        logical block i lands in ``block_row[i]``.

        Two forms.  With a host row mask ``write`` (host arrays both), only
        the blocks where ``write[i]`` is true are written, and the scatter
        indices are built on the host.  Without it, ``block_row`` is a
        (max_len / block_size,) int64 tensor on the pool's device and every
        logical block is written: the caller points the blocks it must not
        write at a sink block that nothing reads, so the scatter has one
        shape whatever the request holds and a captured admission serves
        every request.  That is JAX's ``mode="drop"`` sentinel
        (model.py:387-412, ``drop = n_blocks`` at engine.py:630) made a
        real, write-only block; which of the blocks sent there lands last
        is not fixed, so its contents are garbage by design."""
        _check_entry("append_paged", cache, entry)
        if write is not None:
            src = np.flatnonzero(np.asarray(write, bool))
            dst = np.asarray(block_row, np.int64)[src]
        for key, pages in cache.items():
            leaf = entry[key][:, 0]  # (L, max_len, K, Dh or 1)
            l, s = leaf.shape[:2]
            bs = pages.shape[2]
            blocks = leaf.reshape(l, s // bs, bs, *leaf.shape[2:])
            if write is None:
                pages.index_copy_(1, block_row, blocks)
            else:
                dev = pages.device
                pages.index_copy_(
                    1, torch.as_tensor(dst, device=dev),
                    blocks.index_select(1, torch.as_tensor(src, device=dev)))
        return cache

    def copy_block(self, cache: dict, src: int, dst: int) -> dict:
        """Copy physical page ``src`` into page ``dst`` of every leaf, in
        place (copy-on-write: the sequence diverging from a shared
        prompt-tail block gets its private copy before its first append,
        model.py:414-423).  One device copy per leaf; the pools keep their
        storage, so a captured graph that reads them sees the copy."""
        for pages in cache.values():
            pages[:, dst].copy_(pages[:, src])
        return cache

    def gather_pages(self, cache: dict, block_row, pos) -> dict:
        """Rebuild one sequence as a contiguous batch-1 dense cache, every
        leaf and the scalar ``pos`` on the pools' device — the inverse of
        ``append_paged``, and an entry ``merge_slot`` takes as it takes
        ``gather_slot``'s."""
        out = {}
        for key, pages in cache.items():
            idx = torch.as_tensor(np.asarray(block_row, np.int64),
                                  device=pages.device)
            g = pages.index_select(1, idx)  # (L, M, bs, K, Dh or 1)
            l, m, bs = g.shape[:3]
            out[key] = g.reshape(l, 1, m * bs, *g.shape[3:])
        out["pos"] = torch.as_tensor(pos, dtype=torch.int32,
                                     device=pages.device)
        return out

    # -- byte accounting ---------------------------------------------------------

    def kv_block_bytes(self, block_size: int,
                       kv_int8: Optional[bool] = None) -> int:
        """Bytes of one paged KV block across all layers and leaves
        (model.py:353-359)."""
        return _nbytes(self.paged_cache_specs(1, block_size, kv_int8))

    def dense_kv_bytes(self, batch: int, max_len: int,
                       kv_int8: Optional[bool] = None) -> int:
        """Bytes of the dense slot-pool reservation for the same capacity:
        every leaf plus the scalar int32 position, as ``cache_shapes``
        counts it (model.py:361-367)."""
        return _nbytes(self.cache_specs(batch, max_len, kv_int8)) + 4

    def kv_cache_bytes(self, *, batching: str, max_batch: int, max_len: int,
                       block_size: int = 16,
                       n_kv_blocks: Optional[int] = None,
                       kv_int8: Optional[bool] = None) -> int:
        """Decode-cache bytes one instance reserves under ``batching`` —
        what memory admission charges on top of weights and framework
        (model.py:369-379).  The paged count leaves out the sink block a
        paged pool holds past the allocator's blocks on the fused path."""
        if batching == "paged":
            n_blocks = (n_kv_blocks if n_kv_blocks is not None
                        else default_kv_blocks(max_batch, max_len,
                                               block_size))
            return n_blocks * self.kv_block_bytes(block_size, kv_int8)
        return self.dense_kv_bytes(max_batch, max_len, kv_int8)

"""``Model``: the dense family's steps and cache factories (counterpart of
``repro.models.model.Model`` for this slice).

KV caches are bf16, as in model.py:223-227.  The cache methods that JAX
expresses as functional updates of donated buffers (``merge_slot``,
``append_paged``) write the preallocated pools in place here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_params, param_count

KV_DTYPE = torch.bfloat16


def default_kv_blocks(max_batch: int, max_len: int, block_size: int) -> int:
    """Default pool: the dense slot pool's total block count (one of which
    becomes the null page), minimum 2 (model.py:40-49)."""
    return max(max_batch * (-(-max_len // block_size)), 2)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self) -> None:
        if not transformer.supports_paged(self.cfg):
            raise NotImplementedError(
                f"{self.cfg.name}: the port serves the full-cache dense "
                f"SwiGLU family only so far (others: ROADMAP.md, Queue 1)")

    @functools.cached_property
    def specs(self) -> Any:
        return transformer.decoder_specs(self.cfg)

    # -- params -----------------------------------------------------------

    def init(self, generator: torch.Generator) -> Any:
        """bf16 parameters from ``generator``, drawn leaf by leaf on the
        generator's device."""
        return init_params(self.specs, generator)

    def n_params(self) -> int:
        return param_count(self.specs)

    # -- steps ---------------------------------------------------------------

    def prefill(self, params, tokens, *, max_len=None, length=None):
        return transformer.prefill(params, tokens, self.cfg, max_len=max_len,
                                   length=length)

    def supports_bucketed_prefill(self) -> bool:
        return self.cfg.sliding_window is None

    def supports_paged(self) -> bool:
        return transformer.supports_paged(self.cfg)

    def decode_step(self, params, token, cache):
        return transformer.decode_step(params, token, cache, self.cfg)

    def decode_step_paged(self, params, token, cache, block_tables, pos):
        return transformer.decode_step_paged(params, token, cache,
                                             block_tables, pos, self.cfg)

    def sample_greedy(self, logits):
        return transformer.greedy_tokens(logits, self.cfg)

    def decode_step_tokens(self, params, token, cache):
        return transformer.decode_step_tokens(params, token, cache, self.cfg)

    def decode_step_paged_tokens(self, params, token, cache, block_tables,
                                 pos, active):
        return transformer.decode_step_paged_tokens(
            params, token, cache, block_tables, pos, active, self.cfg)

    # -- slot caches (continuous batching) ---------------------------------

    def _kv_shape(self, batch: int, rows: int) -> tuple[int, ...]:
        cfg = self.cfg
        return (cfg.n_layers, batch, rows, cfg.n_kv_heads, cfg.dh)

    def init_slot_cache(self, n_slots: int, max_len: int,
                        device=None) -> dict:
        """Persistent decode-slot pool with a per-slot position vector."""
        shape = self._kv_shape(n_slots, max_len)
        return {"k": torch.zeros(shape, dtype=KV_DTYPE, device=device),
                "v": torch.zeros(shape, dtype=KV_DTYPE, device=device),
                "pos": torch.zeros((n_slots,), dtype=torch.int32,
                                   device=device)}

    def merge_slot(self, cache: dict, entry: dict, slot: int) -> dict:
        """Copy a batch-1 prefill ``entry`` into slot ``slot`` of the pool,
        in place (a device-to-device copy; no host sync)."""
        cache["k"][:, slot] = entry["k"][:, 0]
        cache["v"][:, slot] = entry["v"][:, 0]
        cache["pos"][slot] = entry["pos"]
        return cache

    def gather_slot(self, cache: dict, slot: int) -> dict:
        """Slot ``slot`` of a pool as a batch-1 cache with a scalar pos
        (the inverse of ``merge_slot``)."""
        return {"k": cache["k"][:, slot:slot + 1].clone(),
                "v": cache["v"][:, slot:slot + 1].clone(),
                "pos": cache["pos"][slot].clone()}

    # -- paged caches ---------------------------------------------------------

    def init_paged_cache(self, n_blocks: int, block_size: int,
                         device=None) -> dict:
        """Zeroed paged KV pools (block 0 is the engine's null block)."""
        shape = self._kv_shape(n_blocks, block_size)
        return {"k": torch.zeros(shape, dtype=KV_DTYPE, device=device),
                "v": torch.zeros(shape, dtype=KV_DTYPE, device=device)}

    def append_paged(self, cache: dict, entry: dict, block_row,
                     write) -> dict:
        """Scatter a batch-1 prefill ``entry`` (``max_len`` rows, a multiple
        of the block size) into physical pages, in place: logical block i
        lands in ``block_row[i]`` where the row mask ``write[i]`` is true.
        The explicit mask replaces JAX's ``mode="drop"`` sentinel
        (model.py:387-412); both arguments are host arrays, so the scatter
        indices are built without a device sync."""
        src = np.flatnonzero(np.asarray(write, bool))
        dst = np.asarray(block_row, np.int64)[src]
        for key, pages in cache.items():
            leaf = entry[key][:, 0]  # (L, max_len, K, Dh)
            l, s = leaf.shape[:2]
            bs = pages.shape[2]
            blocks = leaf.reshape(l, s // bs, bs, *leaf.shape[2:])
            dev = pages.device
            pages.index_copy_(
                1, torch.as_tensor(dst, device=dev),
                blocks.index_select(1, torch.as_tensor(src, device=dev))
                .to(pages.dtype))
        return cache

    def gather_pages(self, cache: dict, block_row, pos) -> dict:
        """Rebuild one sequence as a contiguous batch-1 dense cache — the
        inverse of ``append_paged``."""
        out = {}
        for key, pages in cache.items():
            idx = torch.as_tensor(np.asarray(block_row, np.int64),
                                  device=pages.device)
            g = pages.index_select(1, idx)  # (L, M, bs, K, Dh)
            l, m, bs = g.shape[:3]
            out[key] = g.reshape(l, 1, m * bs, *g.shape[3:])
        out["pos"] = torch.as_tensor(pos, dtype=torch.int32)
        return out

    def kv_block_bytes(self, block_size: int) -> int:
        """Bytes of one paged KV block across all layers and leaves."""
        per = int(np.prod(self._kv_shape(1, block_size)))
        return 2 * per * KV_DTYPE.itemsize

    def dense_kv_bytes(self, batch: int, max_len: int) -> int:
        """Bytes of the dense slot-pool reservation for the same capacity
        (K/V rows plus the scalar int32 position of ``cache_shapes``, as
        model.py:361-367 counts)."""
        per = int(np.prod(self._kv_shape(batch, max_len)))
        return 2 * per * KV_DTYPE.itemsize + 4

"""``Model``: family dispatch, steps and cache factories (counterpart of
``repro.models.model.Model`` for every family: dense, MoE, vision,
encoder-decoder, RWKV-6 and the Hymba hybrid).

Cache leaves follow ``cache_shapes``/``paged_cache_shapes`` of the JAX
package (model.py:169-232, 316-342): bf16 K/V, or under the int8 gate
int8 codes plus (…, K, 1) bf16 scales; for a dual-cache dense config
(gemma3) rolled bf16 K/V for every layer plus full-length bf16
``global_k``/``global_v`` for its global layers; for rwkv an f32 ``wkv``
state and bf16 token-shift rows; for the hybrid rolled bf16 K/V and an
f32 ``ssm`` state (the int8 gate never applies to a rolled cache); for the
vision and encoder-decoder families bf16 full-length K/V plus the bf16
context caches ``cross_k``/``cross_v``.  The int8 gate
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

from repro_torch.distributed.sharding import (Sharding, TPGroup, on_members,
                                              resolve_pspec)
from repro_torch.kernels import keys
from repro_torch.models import attention, encdec, hybrid, rwkv6, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (init_params, param_count,
                                      param_logical_names)

_KV_NAMES = ("layers", "batch", "seq", "kv_heads", None)
_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "encdec": encdec, "rwkv": rwkv6, "hybrid": hybrid}


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
        if cfg.family not in _FAMILY:
            raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")

    @functools.cached_property
    def specs(self) -> Any:
        if self.cfg.family == "rwkv":
            return rwkv6.rwkv_specs(self.cfg)
        if self.cfg.family == "hybrid":
            return hybrid.hybrid_specs(self.cfg)
        if self.cfg.family == "encdec":
            return encdec.encdec_specs(self.cfg)
        return transformer.decoder_specs(self.cfg)

    # -- params -----------------------------------------------------------

    def init(self, generator: torch.Generator) -> Any:
        """Parameters from ``generator``, drawn leaf by leaf on the
        generator's device, each in its spec's dtype (bf16; the MoE
        router f32)."""
        return init_params(self.specs, generator)

    def param_names(self) -> Any:
        """The logical-name tuple of every param leaf, in the params'
        nesting, as JAX's specs declare them (model.py:68)."""
        return param_logical_names(self.specs)

    def n_params(self) -> int:
        return param_count(self.specs)

    # -- steps ---------------------------------------------------------------

    def kv_int8(self) -> bool:
        """Whether a cache made now holds int8 K/V (the process gate)."""
        return attention.kv_int8_enabled(self.cfg)

    def _int8(self, kv_int8: Optional[bool]) -> bool:
        return self.kv_int8() if kv_int8 is None else kv_int8

    def _check_ctx(self, ctx, what: str) -> None:
        if (ctx is not None) != self.needs_ctx():
            raise ValueError(
                f"{self.cfg.name}: {what} needs a context of shape "
                f"{self.ctx_shape(1)[0]} a prompt"
                if self.needs_ctx() else
                f"{self.cfg.name}: a {self.cfg.family} model takes no context")

    def forward(self, params, tokens, *, ctx=None, remat=False, train=True):
        """(f32 logits (B, S, V_padded), f32 aux loss) over the whole of
        ``tokens`` (B, S), for training (model.py:76-80): every family,
        the vision and encoder-decoder ones with their context ``ctx``.
        ``remat`` recomputes each layer in the backward; ``train`` runs
        the moe layers at ``moe_cf_train``.  Under autograd the kernels
        go through their Functions (``kernels/ops.py``), and a
        gradient lands on the stacked leaves of ``params``."""
        self._check_ctx(ctx, "forward")
        return _FAMILY[self.cfg.family].forward(params, tokens, self.cfg,
                                                ctx=ctx, remat=remat,
                                                train=train)

    def prefill(self, params, tokens, *, max_len=None, ctx=None,
                length=None, kv_int8: Optional[bool] = None):
        """(last-position logits (B, V), a cache of ``max_len`` rows).  The
        vision and encoder-decoder families need ``ctx``, the stubbed
        frontend's (B, n_context_tokens, d_model) embeddings in the
        params' dtype on their device (``ctx_shape``); the others refuse
        it (model.py:84-88)."""
        family = self.cfg.family
        self._check_ctx(ctx, "prefill")
        if family in ("rwkv", "hybrid", "encdec"):
            if length is not None:
                raise NotImplementedError(
                    f"{family} prefill runs at the exact prompt length")
            kw = {"ctx": ctx} if ctx is not None else {}
            return _FAMILY[family].prefill(params, tokens, self.cfg,
                                           max_len=max_len, **kw)
        return transformer.prefill(params, tokens, self.cfg, max_len=max_len,
                                   length=length, kv_int8=self._int8(kv_int8),
                                   ctx=ctx)

    def supports_bucketed_prefill(self) -> bool:
        """Right-padded prompts need full per-position caches: pad tokens
        would enter an rwkv or SSM recurrence, and a sliding-window cache
        is not addressed by absolute position (model.py:88-92)."""
        return (self.cfg.family in ("dense", "moe")
                and self.cfg.sliding_window is None)

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

    def sample_tokens(self, logits, key, sampling):
        """The fused sampler with a key: greedy when ``sampling`` is None,
        else temperature / top-k / top-p (model.py:105-108)."""
        return transformer.sampled_tokens(logits, self.cfg, key, sampling)

    def decode_step_tokens(self, params, token, cache, key=None,
                           sampling=None):
        """One round returning ((B,) int32 tokens, cache); the logits never
        leave the device (model.py:110-151).  With a key buffer the round
        advances it in place and samples, every family through the same
        sampler, and returns the key as a third element."""
        if self.cfg.family in ("dense", "moe", "vlm"):
            return transformer.decode_step_tokens(params, token, cache,
                                                  self.cfg, key, sampling)
        logits, cache = self.decode_step(params, token, cache)
        if key is None:
            return transformer.greedy_tokens(logits, self.cfg), cache
        sub = keys.advance(key)
        return (transformer.sampled_tokens(logits, self.cfg, sub, sampling),
                cache, key)

    def decode_step_paged_tokens(self, params, token, cache, block_tables,
                                 pos, active, key=None, sampling=None):
        return transformer.decode_step_paged_tokens(
            params, token, cache, block_tables, pos, active, self.cfg, key,
            sampling)

    # -- speculative verify (model.py:153-163) ---------------------------------

    def supports_speculative(self, kv_int8: Optional[bool] = None) -> bool:
        """Whether the batched verify step covers this config: full-cache
        dense or moe, with bf16 KV (the int8 gate, or ``kv_int8``, off)."""
        return transformer.supports_speculative(self.cfg,
                                                self._int8(kv_int8))

    def verify_step(self, params, tokens, cache):
        """Score a (B, W) window in one forward against the dense slot
        pool: (logits (B, W, V), cache), positions untouched."""
        return transformer.verify_step(params, tokens, cache, self.cfg)

    def verify_step_paged(self, params, tokens, cache, block_tables, pos,
                          active=None):
        return transformer.verify_step_paged(params, tokens, cache,
                                             block_tables, pos, self.cfg,
                                             active)

    # -- cache layouts ---------------------------------------------------------

    def cache_specs(self, batch: int, max_len: int,
                    kv_int8: Optional[bool] = None) -> dict:
        """{leaf: (shape, dtype)} of a cache of ``batch`` sequences, ``pos``
        excluded (model.py:169-232)."""
        if self.cfg.family == "rwkv":
            return rwkv6.cache_specs(self.cfg, batch)
        if self.cfg.family == "hybrid":
            return hybrid.cache_specs(self.cfg, batch, max_len)
        if self.cfg.family == "encdec":
            if kv_int8:
                raise ValueError(f"{self.cfg.name}: int8 KV covers the dense "
                                 f"and moe families only")
            return encdec.cache_specs(self.cfg, batch, max_len)
        return transformer.cache_specs(self.cfg, batch, max_len,
                                       self._int8(kv_int8))

    def paged_cache_specs(self, n_blocks: int, block_size: int,
                          kv_int8: Optional[bool] = None) -> dict:
        """{leaf: (shape, dtype)} of the paged pools (model.py:316-342)."""
        if not self.supports_paged():
            raise NotImplementedError(
                f"{self.cfg.name}: paged KV needs a full-cache dense/moe "
                f"config")
        return transformer.cache_specs(self.cfg, n_blocks, block_size,
                                       self._int8(kv_int8))

    def cache_names(self, batch: int, max_len: int,
                    kv_int8: Optional[bool] = None) -> dict[str, tuple]:
        """The logical dim names of every cache leaf, ``pos`` included
        (model.py:234-251): what a sharded pod's pools resolve.  The int8
        scales and gemma3's ``global_k``/``global_v`` take the K/V names,
        so they split by kv head with the codes."""
        if self.cfg.family == "rwkv":
            return {"wkv": ("layers", "batch", "heads", None, None),
                    "tm_x": ("layers", "batch", None),
                    "cm_x": ("layers", "batch", None), "pos": ()}
        names = {key: (("layers", "batch", "heads", None, None)
                       if key == "ssm" else _KV_NAMES)
                 for key in self.cache_specs(batch, max_len, kv_int8)}
        names["pos"] = ()
        return names

    def paged_cache_names(self, n_blocks: int, block_size: int,
                          kv_int8: Optional[bool] = None
                          ) -> dict[str, tuple]:
        """The paged pools' dim names (model.py:344-351): the kv heads
        split over a pod's members when they divide it, the physical
        blocks never do."""
        return {key: ("layers", None, None, "kv_heads", None)
                for key in self.paged_cache_specs(n_blocks, block_size,
                                                  kv_int8)}

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

    # -- stubbed modality frontends (model.py:443-451) -------------------------

    def needs_ctx(self) -> bool:
        """Whether ``prefill`` takes a context: the encoder-decoder's audio
        frames or the vision model's image patches."""
        return self.cfg.family in ("encdec", "vlm")

    def ctx_shape(self, batch: int) -> Optional[tuple[tuple[int, ...],
                                                      torch.dtype]]:
        """(shape, dtype) of the context of ``batch`` prompts, or None."""
        if not self.needs_ctx():
            return None
        return ((batch, self.cfg.n_context_tokens, self.cfg.d_model),
                torch.bfloat16)


class PodModel:
    """A ``Model`` served as a sharded pod over ``group``: params and
    caches are lists of member trees, primary first (params as
    ``shard_put`` places them by ``serve_pspec``, pools by their
    ``cache_names``), while logits, the sampled tokens and the key stream
    live on the primary.  It answers the calls the serving engine makes of
    a ``Model`` on params and caches, so an instance runs a pod through
    the same admission and round bodies as one device.  The dense and moe
    families, on full, rolled and dual caches, bf16 or int8 KV
    (``kv_int8``, the default of every pool it makes); the rwkv and
    hybrid families are refused (``transformer.tp_refusal``; the
    families that prefill with a context are refused before a pod is
    built, by ``engine.context_refusal``).  A pod neither speculates nor
    migrates, so it has no verify step and no slot export."""

    def __init__(self, model: Model, group: TPGroup, kv_int8: bool):
        why = transformer.tp_refusal(model.cfg)
        if why:
            raise NotImplementedError(why)
        self.model, self.cfg, self.group = model, model.cfg, group
        self.kv_int8 = kv_int8

    def _int8(self, kv_int8: Optional[bool]) -> bool:
        return self.kv_int8 if kv_int8 is None else kv_int8

    def _pools(self, specs: dict, names: dict) -> list:
        """Each member's zeroed leaves of ``specs``, resolved by
        ``names`` against the group: every leaf a tensor of its own on
        its member's device (never a view of a wider pool, so the int8
        codes keep the kernels' 16-byte alignment)."""
        out = [{} for _ in self.group.devices]
        for key, (shape, dtype) in specs.items():
            sh = Sharding(self.group, resolve_pspec(names[key], shape,
                                                    self.group.axis_sizes))
            for m, dev in enumerate(self.group.devices):
                out[m][key] = torch.zeros(sh.shape(shape), dtype=dtype,
                                          device=dev)
        return out

    def _slot_pools(self, batch: int, max_len: int, kv_int8) -> list:
        int8 = self._int8(kv_int8)
        return self._pools(self.model.cache_specs(batch, max_len, int8),
                           self.model.cache_names(batch, max_len, int8))

    def init_slot_cache(self, n_slots: int, max_len: int, device=None,
                        kv_int8: Optional[bool] = None) -> list:
        """Each member's slot pool, with its own per-slot positions
        (``device`` is the primary's; every member's is its own)."""
        caches = self._slot_pools(n_slots, max_len, kv_int8)
        for c, dev in zip(caches, self.group.devices):
            c["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        return caches

    def init_paged_cache(self, n_blocks: int, block_size: int, device=None,
                         kv_int8: Optional[bool] = None) -> list:
        """Each member's pages: its kv heads of every physical block."""
        int8 = self._int8(kv_int8)
        return self._pools(
            self.model.paged_cache_specs(n_blocks, block_size, int8),
            self.model.paged_cache_names(n_blocks, block_size, int8))

    def prefill(self, params, tokens, *, max_len=None, length=None,
                kv_int8: Optional[bool] = None, ctx=None):
        b, s = tokens.shape
        max_len = max_len or s
        return transformer.prefill_tp(
            params, tokens, self.cfg, self.group,
            self._slot_pools(b, max_len, kv_int8), max_len=max_len,
            length=length)

    def merge_slot(self, caches: list, entries: list, slot) -> list:
        slots = (on_members(slot, self.group) if torch.is_tensor(slot)
                 else [slot] * self.group.n)
        for c, e, sl in zip(caches, entries, slots):
            self.model.merge_slot(c, e, sl)
        return caches

    def append_paged(self, caches: list, entries: list, block_row,
                     write=None) -> list:
        rows = (on_members(block_row, self.group)
                if torch.is_tensor(block_row) else [block_row] * self.group.n)
        for c, e, row in zip(caches, entries, rows):
            self.model.append_paged(c, e, row, write)
        return caches

    def copy_block(self, caches: list, src: int, dst: int) -> list:
        """Copy-on-write in every member's pool: each holds its own kv
        heads of the page."""
        for c in caches:
            self.model.copy_block(c, src, dst)
        return caches

    def decode_step(self, params, token, caches):
        return transformer.decode_step_tp(params, token, caches, self.cfg,
                                          self.group)

    def decode_step_paged(self, params, token, caches, block_tables, pos):
        return transformer.decode_step_paged_tp(
            params, token, caches, block_tables, pos, self.cfg, self.group)

    def sample_greedy(self, logits):
        return self.model.sample_greedy(logits)

    def sample_tokens(self, logits, key, sampling):
        return self.model.sample_tokens(logits, key, sampling)

    def _sampled(self, logits, key, sampling):
        if key is None:
            return self.model.sample_greedy(logits)
        return self.model.sample_tokens(logits, keys.advance(key), sampling)

    def decode_step_tokens(self, params, token, caches, key=None,
                           sampling=None):
        """One fused round: (the tokens, each member's cache with its
        advanced ``pos``[, the key]), sampled once, on the primary."""
        logits, caches = self.decode_step(params, token, caches)
        tok = self._sampled(logits, key, sampling)
        return (tok, caches) if key is None else (tok, caches, key)

    def decode_step_paged_tokens(self, params, token, caches, block_tables,
                                 pos, active, key=None, sampling=None):
        active = active.to(torch.int32)
        logits, caches = transformer.decode_step_paged_tp(
            params, token, caches, block_tables, pos, self.cfg, self.group,
            active)
        out = (self._sampled(logits, key, sampling), caches, pos + active)
        return out if key is None else out + (key,)

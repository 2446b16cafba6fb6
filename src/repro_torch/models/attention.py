"""GQA attention blocks: projections, prefill and decode paths, cache
writes (counterpart of ``repro.models.attention``, dense paths only).

Cache conventions: a dense cache is (B, S_max, K, Dh) with write row =
position; paged pools are (N, bs, K, Dh) physical blocks.  Rotary
embeddings are applied before caching.  Where JAX returns an updated
(donated) cache, the port writes the preallocated cache IN PLACE and
returns the same tensor — the counterpart of XLA donation.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import PSpec, apply_rope


def attn_specs(cfg: ModelConfig) -> dict[str, PSpec]:
    d, hq, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = {"wq": PSpec((d, hq)), "wk": PSpec((d, kv)), "wv": PSpec((d, kv)),
         "wo": PSpec((hq, d))}
    if cfg.qkv_bias:
        s["bq"] = PSpec((hq,), init="zeros")
        s["bk"] = PSpec((kv,), init="zeros")
        s["bv"] = PSpec((kv,), init="zeros")
    return s


def _project_q(params: dict, x: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    b, s, _ = x.shape
    return q.reshape(b, s, cfg.n_heads, cfg.dh)


def _project_kv(params: dict, x: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, torch.Tensor]:
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    b, s, _ = x.shape
    return (k.reshape(b, s, cfg.n_kv_heads, cfg.dh),
            v.reshape(b, s, cfg.n_kv_heads, cfg.dh))


def _output(params: dict, o: torch.Tensor) -> torch.Tensor:
    b, s, h, dh = o.shape
    return o.reshape(b, s, h * dh) @ params["wo"]


def attn_full(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal self-attention over the whole sequence through the flash
    kernel.  Returns (output, k, v) — k/v post-rope, for the caller to
    cache."""
    q = apply_rope(_project_q(params, x, cfg), positions, cfg.rope_theta)
    k, v = _project_kv(params, x, cfg)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = ops.flash_attention(q, k, v, causal=True)
    return _output(params, o), k, v


# --------------------------------------------------------------------------
# Decode (one token against a cache)
# --------------------------------------------------------------------------


def cache_write(cache: torch.Tensor, new: torch.Tensor,
                slot: torch.Tensor) -> torch.Tensor:
    """Write (B, 1, K, Dh) into (B, C, K, Dh) at row ``slot`` (scalar or
    (B,)), in place.  The row is clamped to ``[0, C-1]`` exactly as JAX's
    ``dynamic_update_slice`` clamps its start: a free continuous slot keeps
    advancing its position past C and must land on the last row, never
    out of bounds."""
    b, c = cache.shape[:2]
    rows = torch.clamp(slot.long().expand(b), 0, c - 1)
    batch = torch.arange(b, device=cache.device)
    cache[batch, rows] = new[:, 0].to(cache.dtype)
    return cache


def attn_decode(params: dict, x: torch.Tensor, kc: torch.Tensor,
                vc: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token self-attention against (and updating, in place) the
    dense cache.  x: (B, 1, D); pos: scalar or (B,) absolute position of
    the new token.  Returns (output, kc, vc)."""
    b = x.shape[0]
    pos_b = pos.reshape(-1).expand(b)
    positions = pos_b[:, None]
    q = apply_rope(_project_q(params, x, cfg), positions, cfg.rope_theta)
    k, v = _project_kv(params, x, cfg)
    k = apply_rope(k, positions, cfg.rope_theta)
    cache_write(kc, k, pos_b)
    cache_write(vc, v, pos_b)
    cache_len = (pos_b + 1).to(torch.int32)
    o = ops.decode_attention(q, kc, vc, cache_len)
    return _output(params, o), kc, vc


def paged_cache_write(pages: torch.Tensor, new: torch.Tensor,
                      block_tables: torch.Tensor, pos: torch.Tensor,
                      active: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Write one token's (B, 1, K, Dh) K/V into (N, bs, K, Dh) pages, in
    place.  Row b lands in block ``tables[b, pos[b] // bs]`` at offset
    ``pos[b] % bs``.

    ``active`` ((B,), optional) is an explicit row mask where JAX used a
    ``mode="drop"`` out-of-range sentinel: an inactive row writes back the
    value its target already holds, so free slots change nothing (the null
    page stays as it is) and no host sync is needed to drop them.  Free
    slots all target the null block's row 0; live sequences own disjoint
    blocks, so no live write collides with another row."""
    n, bs = pages.shape[:2]
    idx = pos.long()
    blk = torch.gather(block_tables.long(), 1, (idx // bs)[:, None])[:, 0]
    flat = pages.view(n * bs, *pages.shape[2:])
    rows = blk * bs + idx % bs
    val = new[:, 0].to(pages.dtype)
    if active is not None:
        keep = active.bool()[:, None, None]
        val = torch.where(keep, val, flat[rows])
    flat[rows] = val
    return pages


def attn_decode_paged(params: dict, x: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_tables: torch.Tensor,
                      pos: torch.Tensor, cfg: ModelConfig,
                      active: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token self-attention against (and updating, in place) a paged
    cache.  pos: (B,) absolute position of each sequence's new token."""
    positions = pos[:, None]
    q = apply_rope(_project_q(params, x, cfg), positions, cfg.rope_theta)
    k, v = _project_kv(params, x, cfg)
    k = apply_rope(k, positions, cfg.rope_theta)
    paged_cache_write(k_pages, k, block_tables, pos, active)
    paged_cache_write(v_pages, v, block_tables, pos, active)
    cache_len = (pos + 1).to(torch.int32)
    o = ops.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                   cache_len)
    return _output(params, o), k_pages, v_pages

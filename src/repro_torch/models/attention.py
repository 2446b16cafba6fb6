"""GQA attention blocks: projections, prefill and decode paths, cache
writes, int8 KV quantization (counterpart of ``repro.models.attention``:
the self-attention paths of the dense and hybrid families).

Cache conventions: a full cache is (B, S_max, K, Dh) with write row =
position; a rolled (sliding-window) cache is (B, C, K, Dh) with write row
= position mod C; paged pools are (N, bs, K, Dh) physical blocks.  Rotary
embeddings are applied before caching; cross-attention (the encoder-decoder
and vision families) attends a projected context cache without rope or
mask.  Where JAX returns an updated
(donated) cache, the port writes the preallocated cache IN PLACE and
returns the same tensor — the counterpart of XLA donation.  An int8 cache
holds codes in the K/V pools beside (…, K, 1) bf16 scale pools.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.distributed.sharding import TPGroup, gather_cols
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import COL, ROW, PSpec, rope_tables, rotate


def attn_specs(cfg: ModelConfig, cross: bool = False) -> dict[str, PSpec]:
    """The projections; a cross layer takes no qkv bias
    (attention.py:74-86)."""
    d, hq, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s = {"wq": PSpec((d, hq), COL), "wk": PSpec((d, kv), COL),
         "wv": PSpec((d, kv), COL), "wo": PSpec((hq, d), ROW)}
    if cfg.qkv_bias and not cross:
        s["bq"] = PSpec((hq,), ("tp",), init="zeros")
        s["bk"] = PSpec((kv,), ("tp",), init="zeros")
        s["bv"] = PSpec((kv,), ("tp",), init="zeros")
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


def _rope_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projections with rotary embeddings on q and k (post-rope k is what
    the caches hold)."""
    q = _project_q(params, x, cfg)
    k, v = _project_kv(params, x, cfg)
    rope = rope_tables(positions, cfg.dh, cfg.rope_theta)
    return rotate(q, rope), rotate(k, rope), v


def _output(params: dict, o: torch.Tensor) -> torch.Tensor:
    b, s, h, dh = o.shape
    return o.reshape(b, s, h * dh) @ params["wo"]


def attn_full(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, window: Optional[int] = None,
              causal: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Self-attention over the whole sequence through the flash kernel:
    causal, optionally within a sliding ``window``, or bidirectional
    (``causal=False``, the encoder) (attention.py:131-146).  Returns
    (output, k, v) — k/v post-rope, for the caller to cache."""
    q, k, v = _rope_qkv(params, x, positions, cfg)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    return _output(params, o), k, v


def cross_attn_full(params: dict, x: torch.Tensor, ctx_kv: tuple,
                    cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention of every position of ``x`` to a projected context
    (k, v) (B, S_ctx, K, Dh): no rope, no mask, through the flash kernel
    with ``causal=False`` (attention.py:149-156)."""
    k, v = ctx_kv
    o = ops.flash_attention(_project_q(params, x, cfg), k, v, causal=False)
    return _output(params, o)


def context_kv(params: dict, ctx: torch.Tensor, cfg: ModelConfig
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """A layer's k/v of the encoder output or image context: what the
    cross caches hold (attention.py:159-162)."""
    return _project_kv(params, ctx, cfg)


# --------------------------------------------------------------------------
# int8 KV-cache quantization (attention.py:165-191)
# --------------------------------------------------------------------------


def kv_int8_enabled(cfg: ModelConfig) -> bool:
    """``REPRO_KV_INT8=1`` stores full (non-rolled) dense KV caches as int8
    codes with per-(position, kv-head) bf16 scales.  Read where a cache is
    made; the decode steps dispatch on what the cache holds."""
    return (os.environ.get("REPRO_KV_INT8", "") == "1"
            and cfg.family in ("dense", "moe")
            and cfg.sliding_window is None
            and cfg.local_global_ratio == 0)


def kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, D) -> (int8 codes, (…, 1) bf16 scales).  Codes are rounded
    (half to even, as ``jnp.round``) with the f32 scale; only then is the
    scale stored as bf16."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0,
                        min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale.float()).to(torch.bfloat16)


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


def _rolled_decode(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                   pos: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """Attention against a rolled cache (attention.py:219-236): slot s
    holds position ``pos - ((pos - s) mod C)``, invalid when that position
    is negative (or, for ``window < C``, outside the window).  Plain
    PyTorch, as the JAX package leaves it to XLA (no Pallas original)."""
    b, _, h, d = q.shape
    c, n_kv = kc.shape[1], kc.shape[2]
    qf = q.float().reshape(b, 1, n_kv, h // n_kv, d) * d ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, kc.float())
    slots = torch.arange(c, device=q.device)
    pos_b = pos.reshape(-1).expand(b).long()[:, None]
    slot_pos = pos_b - torch.remainder(pos_b - slots[None, :], c)
    valid = slot_pos >= 0
    if window is not None and window < c:
        valid &= slot_pos > pos_b - window
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, vc.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def attn_decode(params: dict, x: torch.Tensor, kc: torch.Tensor,
                vc: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig, *,
                rolled: bool = False, window: Optional[int] = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token self-attention against (and updating, in place) the
    cache.  x: (B, 1, D); pos: scalar or (B,) absolute position of the new
    token.  A full cache takes the new row at ``pos`` (clamped, see
    ``cache_write``) and attends through the decode kernel; a rolled cache
    takes it at ``pos mod C``, which a free slot's ever-advancing position
    wraps harmlessly (attention.py:239-265).  Returns (output, kc, vc)."""
    b = x.shape[0]
    pos_b = pos.reshape(-1).expand(b)
    q, k, v = _rope_qkv(params, x, pos_b[:, None], cfg)
    o = decode_attend(q, k, v, kc, vc, pos_b, rolled=rolled, window=window)
    return _output(params, o), kc, vc


def decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kc: torch.Tensor, vc: torch.Tensor, pos_b: torch.Tensor, *,
                  rolled: bool = False, window: Optional[int] = None,
                  plan_kv: Optional[int] = None) -> torch.Tensor:
    """``attn_decode`` past its projections: write the rope'd row k, v
    (B, 1, K, Dh) into the cache at ``pos_b`` (B,) (rolled: at ``pos_b
    mod C``) and attend it, (B, 1, H, Dh) -> (B, 1, H, Dh).  A sharded
    pod's member runs it on its own heads, with ``plan_kv`` the whole
    model's kv heads (the kernel's split of S, ``decode_plan``)."""
    row = torch.remainder(pos_b, kc.shape[1]) if rolled else pos_b
    cache_write(kc, k, row)
    cache_write(vc, v, row)
    if rolled:
        return _rolled_decode(q, kc, vc, pos_b, window)
    return ops.decode_attention(q, kc, vc, (pos_b + 1).to(torch.int32),
                                window=window, plan_kv=plan_kv)


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
    q, k, v = _rope_qkv(params, x, pos[:, None], cfg)
    o = paged_attend(q, k, v, k_pages, v_pages, block_tables, pos, active)
    return _output(params, o), k_pages, v_pages


def paged_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                 block_tables: torch.Tensor, pos: torch.Tensor,
                 active: Optional[torch.Tensor] = None,
                 plan_kv: Optional[int] = None) -> torch.Tensor:
    """``attn_decode_paged`` past its projections: write the new row into
    the pages and attend them through the block table (``plan_kv`` as
    ``decode_attend``'s)."""
    paged_cache_write(k_pages, k, block_tables, pos, active)
    paged_cache_write(v_pages, v, block_tables, pos, active)
    return ops.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                      (pos + 1).to(torch.int32),
                                      plan_kv=plan_kv)


# --------------------------------------------------------------------------
# Speculative verify (a W-token window against a cache, attention.py:327-389)
# --------------------------------------------------------------------------


def cache_write_window(cache: torch.Tensor, new: torch.Tensor,
                       start: torch.Tensor) -> torch.Tensor:
    """Write (B, W, K, Dh) into (B, C, K, Dh) at rows ``start ..
    start+W-1`` (``start`` (B,)), in place: the W-row ``cache_write``.  The
    start is clamped to ``[0, C - W]`` as XLA's ``dynamic_update_slice``
    clamps it: a live slot's window always fits (the engine reserves the
    ``+k`` margin at submit), but a free continuous slot's position runs
    ahead by up to ``k + 1`` a round and must land on the last W rows."""
    b, c = cache.shape[:2]
    w = new.shape[1]
    start = torch.clamp(start.long().expand(b), 0, c - w)
    rows = start[:, None] + torch.arange(w, device=cache.device)[None, :]
    batch = torch.arange(b, device=cache.device)[:, None]
    cache[batch, rows] = new.to(cache.dtype)
    return cache


def attn_verify(params: dict, x: torch.Tensor, kc: torch.Tensor,
                vc: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """W-token verify attention against (and updating, in place) a dense
    cache.  x: (B, W, D), the window [last emitted token, k draft tokens];
    pos: (B,) (or scalar) position of the window's first token.  Writes
    the window's K/V at rows pos..pos+W-1 and attends with the
    per-query-row causal mask.  Returns (output (B, W, D), kc, vc)."""
    b, w, _ = x.shape
    pos_b = pos.reshape(-1).expand(b)
    positions = pos_b[:, None] + torch.arange(w, device=x.device)[None, :]
    q, k, v = _rope_qkv(params, x, positions, cfg)
    cache_write_window(kc, k, pos_b)
    cache_write_window(vc, v, pos_b)
    o = ops.verify_attention(q, kc, vc, pos_b.to(torch.int32))
    return _output(params, o), kc, vc


def attn_verify_paged(params: dict, x: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_tables: torch.Tensor,
                      pos: torch.Tensor, cfg: ModelConfig,
                      active: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """W-token verify attention against (and updating, in place) a paged
    cache: the window's rows are scattered one position at a time through
    ``paged_cache_write`` (inactive slots write nothing new), then attended
    with the per-query-row causal mask."""
    w = x.shape[1]
    positions = pos[:, None] + torch.arange(w, device=x.device)[None, :]
    q, k, v = _rope_qkv(params, x, positions, cfg)
    for j in range(w):
        paged_cache_write(k_pages, k[:, j:j + 1], block_tables, pos + j,
                          active)
        paged_cache_write(v_pages, v[:, j:j + 1], block_tables, pos + j,
                          active)
    o = ops.paged_verify_attention(q, k_pages, v_pages, block_tables,
                                   pos.to(torch.int32))
    return _output(params, o), k_pages, v_pages


def attn_decode_quant(params: dict, x: torch.Tensor, kc: torch.Tensor,
                      vc: torch.Tensor, ksc: torch.Tensor, vsc: torch.Tensor,
                      pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``attn_decode`` against int8 caches (kc/vc int8 codes, ksc/vsc
    (B, C, K, 1) bf16 scales), all written in place: the new row is
    quantized, cached, and attended by the int8 decode kernel."""
    b = x.shape[0]
    pos_b = pos.reshape(-1).expand(b)
    q, k, v = _rope_qkv(params, x, pos_b[:, None], cfg)
    return _output(params, decode_attend_quant(q, k, v, kc, vc, ksc, vsc,
                                               pos_b))


def decode_attend_quant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kc: torch.Tensor, vc: torch.Tensor,
                        ksc: torch.Tensor, vsc: torch.Tensor,
                        pos_b: torch.Tensor,
                        plan_kv: Optional[int] = None) -> torch.Tensor:
    """``attn_decode_quant`` past its projections: quantize the new row
    (per head), write its codes and scales at ``pos_b`` and attend
    (``plan_kv`` as ``decode_attend``'s)."""
    k8, ks_new = kv_quantize(k)
    v8, vs_new = kv_quantize(v)
    for cache, new in ((kc, k8), (vc, v8), (ksc, ks_new), (vsc, vs_new)):
        cache_write(cache, new, pos_b)
    return ops.decode_attention_quant(q, kc, vc, ksc, vsc,
                                      (pos_b + 1).to(torch.int32),
                                      plan_kv=plan_kv)


def attn_decode_paged_quant(params: dict, x: torch.Tensor,
                            k_pages: torch.Tensor, v_pages: torch.Tensor,
                            ks_pages: torch.Tensor, vs_pages: torch.Tensor,
                            block_tables: torch.Tensor, pos: torch.Tensor,
                            cfg: ModelConfig,
                            active: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """``attn_decode_paged`` against int8 code + scale pages, written in
    place."""
    q, k, v = _rope_qkv(params, x, pos[:, None], cfg)
    return _output(params, paged_attend_quant(
        q, k, v, k_pages, v_pages, ks_pages, vs_pages, block_tables, pos,
        active))


def paged_attend_quant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       k_pages: torch.Tensor, v_pages: torch.Tensor,
                       ks_pages: torch.Tensor, vs_pages: torch.Tensor,
                       block_tables: torch.Tensor, pos: torch.Tensor,
                       active: Optional[torch.Tensor] = None,
                       plan_kv: Optional[int] = None) -> torch.Tensor:
    """``attn_decode_paged_quant`` past its projections: the new row's
    codes and scales into the four pools, then the int8 paged kernel
    (``plan_kv`` as ``decode_attend``'s)."""
    k8, ks_new = kv_quantize(k)
    v8, vs_new = kv_quantize(v)
    for pages, new in ((k_pages, k8), (v_pages, v8), (ks_pages, ks_new),
                       (vs_pages, vs_new)):
        paged_cache_write(pages, new, block_tables, pos, active)
    return ops.paged_decode_attention_quant(
        q, k_pages, v_pages, ks_pages, vs_pages, block_tables,
        (pos + 1).to(torch.int32), plan_kv=plan_kv)


def cross_attn_decode(params: dict, x: torch.Tensor, ck: torch.Tensor,
                      cv: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One-token cross-attention against a context cache (B, S_ctx, K,
    Dh): the decode kernel with ``cache_len = S_ctx`` for every row
    (attention.py:447-456)."""
    b = x.shape[0]
    cache_len = torch.full((b,), ck.shape[1], dtype=torch.int32,
                           device=x.device)
    o = ops.decode_attention(_project_q(params, x, cfg), ck, cv, cache_len)
    return _output(params, o)


# --------------------------------------------------------------------------
# Sharded pods: column-parallel q/k/v, heads gathered before wo
# (attention.py:111-123 under ``serve_pspec``)
# --------------------------------------------------------------------------


def attn_tp(lps: list, hs: list, cfg: ModelConfig, group: TPGroup,
            positions: list, split: bool, attend) -> list:
    """Self-attention of a sharded pod.  ``lps``: each member's attention
    leaves (its columns of ``wq``/``wk``/``wv`` and the biases, the whole
    ``wo``); ``hs``: each member's normed input (B, S, D); ``positions``:
    each member's rope positions; ``attend(m, q, k, v)``: member m's
    attention over its heads (rope'd q, k; it writes m's cache), (B, S,
    h, Dh).  ``split``: each member's pool holds its share of the kv
    heads, so it attends its own heads (the G q heads that read a kv head
    stay together: q head i reads kv head i // G).  Otherwise the pools
    are replicated: the q/k/v columns are gathered before the reshape
    into heads (a column split may fall mid-head) and every member
    attends every head.  The heads are gathered in member order before
    ``wo``, which every member runs whole; returns each member's (B, S,
    D)."""
    b, s, _ = hs[0].shape
    q, k, v = [], [], []
    for lp, h in zip(lps, hs):
        qm, km, vm = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
        if "bq" in lp:
            qm, km, vm = qm + lp["bq"], km + lp["bk"], vm + lp["bv"]
        q.append(qm)
        k.append(km)
        v.append(vm)
    if not split:
        q = gather_cols(q, group, cfg.q_dim)
        k = gather_cols(k, group, cfg.kv_dim)
        v = gather_cols(v, group, cfg.kv_dim)
    outs = []
    for m in range(group.n):
        heads = (b, s, -1, cfg.dh)
        rope = rope_tables(positions[m], cfg.dh, cfg.rope_theta)
        qm = rotate(q[m].reshape(heads), rope)
        km = rotate(k[m].reshape(heads), rope)
        outs.append(attend(m, qm, km, v[m].reshape(heads)).reshape(b, s, -1))
    if split:
        outs = gather_cols(outs, group, cfg.q_dim)
    return [o @ lp["wo"] for o, lp in zip(outs, lps)]

"""Decoder-only transformer, dense, MoE and vision families (counterpart
of ``repro.models.transformer``): SwiGLU, GeGLU and GELU MLPs or the
expert block of ``models/moe.py``, full caches, a rolled cache on every
layer (mixtral's window), gemma3's local:global interleave on dual
caches — rolled (L, B, C, K, Dh) ``k``/``v`` leaves for every layer plus
full-length ``global_k``/``global_v`` leaves for the global layers — and
llama-3.2-vision's cross-attention interleave: groups of
``cross_attn_every`` self layers, each followed by one gated
cross-attention layer over a context cache ``cross_k``/``cross_v``
(G, B, S_ctx, K, Dh) written once at prefill.

JAX scans over a stacked ``layers`` axis; the port keeps that layout and
loops over it in Python (PyTorch runs eagerly; on the card the serving
engine captures a whole decode round as a CUDA graph,
``serving/graphs.py``).
Decode steps update the preallocated KV pools in place — the counterpart
of the JAX package's donated caches.  A cache made under the int8 gate
holds int8 K/V codes beside ``k_scale``/``v_scale`` pools; the decode
steps dispatch on what the cache holds (``"k_scale" in cache``).
The fused steps sample greedily, or with a key buffer of
``kernels.keys`` advanced in place; ``verify_step(_paged)`` scores a
speculative window in one forward.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.distributed.sharding import TPGroup, on_members
from repro_torch.kernels import keys, ops
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (EMBED, HEAD, NORM, PSpec,
                                       checkpointed, mlp_apply, mlp_specs,
                                       mlp_tp, rms_norm, stack_tree, unstack)
from repro_torch.models.moe import moe_apply, moe_specs, moe_tp


def block_specs(cfg: ModelConfig) -> dict[str, Any]:
    d = cfg.d_model
    s = {"ln1": PSpec((d,), NORM, init="zeros"),
         "attn": attn.attn_specs(cfg),
         "ln2": PSpec((d,), NORM, init="zeros")}
    if cfg.family == "moe":
        s["moe"] = moe_specs(cfg)
    else:
        s["mlp"] = mlp_specs(d, cfg.d_ff, cfg.mlp)
    return s


def cross_block_specs(cfg: ModelConfig) -> dict[str, Any]:
    """A gated cross-attention layer (transformer.py:55-64): the gates are
    0-d and zero-initialised, so a fresh model ignores its context."""
    d = cfg.d_model
    return {"ln1": PSpec((d,), NORM, init="zeros"),
            "attn": attn.attn_specs(cfg, cross=True),
            "gate_attn": PSpec((), (), init="zeros"),
            "ln2": PSpec((d,), NORM, init="zeros"),
            "mlp": mlp_specs(d, cfg.d_ff, cfg.mlp),
            "gate_mlp": PSpec((), (), init="zeros")}


def n_cross_layers(cfg: ModelConfig) -> int:
    """The vision family's cross layers: one after every
    ``cross_attn_every`` self layers."""
    if cfg.n_layers % cfg.cross_attn_every:
        raise ValueError("n_layers must divide cross_attn_every groups")
    return cfg.n_layers // cfg.cross_attn_every


def decoder_specs(cfg: ModelConfig) -> dict[str, Any]:
    d, v, l = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    specs: dict[str, Any] = {
        "embed": PSpec((v, d), EMBED, init="small"),
        "ln_f": PSpec((d,), NORM, init="zeros"),
        "layers": stack_tree(block_specs(cfg), l),
    }
    if not cfg.tie_embeddings:
        specs["head"] = PSpec((d, v), HEAD)
    if cfg.family == "vlm":
        specs["cross_layers"] = stack_tree(cross_block_specs(cfg),
                                           n_cross_layers(cfg))
    return specs


def layer_params(params: dict, i: int, stack: str = "layers") -> dict:
    """Layer ``i`` of a stacked tree, ``layers`` or another (``enc_layers``,
    ``cross_layers``): views, no copy."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i]
    return pick(params[stack])


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------


def _ffn(lp: dict, x: torch.Tensor, cfg: ModelConfig, train: bool = False
         ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, aux): the MLP and no aux loss (None), or for the moe family
    the expert block and its f32 load-balancing loss, at the training
    capacity factor ``moe_cf_train`` (drops allowed) under ``train`` and
    at the serving one ``moe_cf_eval`` else (transformer.py:89-94)."""
    if cfg.family == "moe":
        cf = cfg.moe_cf_train if train else cfg.moe_cf_eval
        return moe_apply(lp["moe"], x, cfg, cf)
    return mlp_apply(lp["mlp"], x, cfg.mlp), None


def block_full(lp: dict, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor, window: Optional[int] = None,
               train: bool = False):
    """Full-sequence block, attending within ``window`` when one is given.
    Returns (x, k, v, aux) (``_ffn``'s aux: None but for the moe
    family)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, k, v = attn.attn_full(lp["attn"], h, cfg, positions=positions,
                             window=window)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    m, aux = _ffn(lp, h, cfg, train)
    return x + m, k, v, aux


def block_decode(lp: dict, x: torch.Tensor, kc: torch.Tensor,
                 vc: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig, *,
                 rolled: bool = False, window: Optional[int] = None
                 ) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, _, _ = attn.attn_decode(lp["attn"], h, kc, vc, pos, cfg,
                               rolled=rolled, window=window)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _ffn(lp, h, cfg)[0]


def block_decode_quant(lp: dict, x: torch.Tensor, kc, vc, ksc, vsc,
                       pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``block_decode`` against int8 caches (transformer.py:153)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + attn.attn_decode_quant(lp["attn"], h, kc, vc, ksc, vsc, pos, cfg)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _ffn(lp, h, cfg)[0]


def block_decode_paged_quant(lp: dict, x: torch.Tensor, kc, vc, ksc, vsc,
                             block_tables: torch.Tensor, pos: torch.Tensor,
                             cfg: ModelConfig,
                             active: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """``block_decode_paged`` against int8 pages (transformer.py:140)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + attn.attn_decode_paged_quant(lp["attn"], h, kc, vc, ksc, vsc,
                                         block_tables, pos, cfg, active)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _ffn(lp, h, cfg)[0]


def block_decode_paged(lp: dict, x: torch.Tensor, kc: torch.Tensor,
                       vc: torch.Tensor, block_tables: torch.Tensor,
                       pos: torch.Tensor, cfg: ModelConfig,
                       active: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, _, _ = attn.attn_decode_paged(lp["attn"], h, kc, vc, block_tables,
                                     pos, cfg, active)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _ffn(lp, h, cfg)[0]


def _gated(x: torch.Tensor, gate: torch.Tensor, y: torch.Tensor
           ) -> torch.Tensor:
    """``x + tanh(gate) * y``, the tanh in f32 and cast back to x's dtype
    (transformer.py:175)."""
    return x + torch.tanh(gate.float()).to(x.dtype) * y


def cross_block_full(lp: dict, x: torch.Tensor, ctx: torch.Tensor,
                     cfg: ModelConfig
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gated cross-attention block over the context (transformer.py:
    165-179).  Returns (x, ck, cv): the projected context, for the cross
    caches."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    ck, cv = attn.context_kv(lp["attn"], ctx, cfg)
    x = _gated(x, lp["gate_attn"], attn.cross_attn_full(lp["attn"], h,
                                                        (ck, cv), cfg))
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return _gated(x, lp["gate_mlp"], mlp_apply(lp["mlp"], h, cfg.mlp)), ck, cv


def cross_block_decode(lp: dict, x: torch.Tensor, ck: torch.Tensor,
                       cv: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``cross_block_full`` for one token against the layer's context
    cache (transformer.py:182-189)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = _gated(x, lp["gate_attn"],
               attn.cross_attn_decode(lp["attn"], h, ck, cv, cfg))
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return _gated(x, lp["gate_mlp"], mlp_apply(lp["mlp"], h, cfg.mlp))


# --------------------------------------------------------------------------
# Embedding / head
# --------------------------------------------------------------------------


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def lm_head(params: dict, x: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return (x @ w).float()


# --------------------------------------------------------------------------
# Layer pattern (transformer.py:217-242)
# --------------------------------------------------------------------------


def global_slots(cfg: ModelConfig) -> list[Optional[int]]:
    """Per layer, its index into the ``global_k``/``global_v`` leaves, or
    None for a local layer: the global layers of a dual-cache config in
    order (``_layer_flags``).  Without dual caches every layer is None."""
    out, g = [], 0
    for i in range(cfg.n_layers):
        glob = _dual(cfg) and cfg.is_global_layer(i)
        out.append(g if glob else None)
        g += glob
    return out


def n_global_layers(cfg: ModelConfig) -> int:
    return sum(cfg.is_global_layer(i) for i in range(cfg.n_layers))


def _dual(cfg: ModelConfig) -> bool:
    """Local:global interleave with windowed locals (gemma3)."""
    return cfg.local_global_ratio > 0 and cfg.sliding_window is not None


def local_cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Rows of a sliding-window layer's cache: the window, or fewer when
    the cache never holds that many (transformer.py:235-237)."""
    w = cfg.sliding_window
    return min(w, max_len) if w else max_len


# --------------------------------------------------------------------------
# Forward (training) — logits over the full sequence (transformer.py:245-313)
# --------------------------------------------------------------------------


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            ctx: Optional[torch.Tensor] = None, remat: bool = False,
            train: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(f32 logits (B, S, V_padded), f32 aux loss) over the whole of
    ``tokens`` (B, S).  Each self layer is ``block_full`` (moe at
    ``moe_cf_train`` under ``train``), windowed as prefill windows it
    (gemma3's global layers in full, its locals and mixtral's every layer
    within the window); the aux loss sums the moe layers'.  The vision
    family runs each group's self layers, then its gated cross layer on
    the raw context ``ctx``.  ``remat`` recomputes each self layer in the
    backward (``layers.checkpointed``), as JAX checkpoints ``self_body``
    alone."""
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    layers = unstack(params["layers"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def self_body(lp, x, aux, window):
        x, _, _, a = block_full(lp, x, cfg, positions=positions,
                                window=window, train=train)
        return x, aux if a is None else aux + a

    body = checkpointed(self_body, remat)
    w = cfg.sliding_window
    if cfg.family == "vlm":
        if ctx is None:
            raise ValueError(f"{cfg.name}: the vision forward needs a context")
        cross = unstack(params["cross_layers"])
        for g, idx in _groups(cfg):
            for i in idx:
                x, aux = body(layers[i], x, aux, w)
            x, _, _ = cross_block_full(cross[g], x, ctx, cfg)
    else:
        for i, g in enumerate(global_slots(cfg)):
            x, aux = body(layers[i], x, aux, w if g is None else None)
    return lm_head(params, x, cfg), aux


# --------------------------------------------------------------------------
# Prefill — forward + emit decode caches
# --------------------------------------------------------------------------


def _windowed_cache(k: torch.Tensor, w: int, max_len: int) -> torch.Tensor:
    """A rolled (B, C, K, Dh) cache from full-sequence k (B, S, K, Dh),
    C = min(w, max_len) (transformer.py:321-330): the slot of position p is
    p mod C, so a prompt that fits lands at rows [0, S) with zeros after
    it, and a longer one keeps its last C rows rolled by S mod C."""
    b, s, kv, dh = k.shape
    c = min(w, max_len)
    if s <= c:
        out = torch.zeros((b, c, kv, dh), dtype=k.dtype, device=k.device)
        out[:, :s] = k
        return out
    return torch.roll(k[:, s - c:], shifts=s % c, dims=1)


def _full_cache(k: torch.Tensor, max_len: int) -> torch.Tensor:
    """k (B, S, K, Dh) in front of a zeroed (B, max_len, K, Dh) cache
    (transformer.py:333-338)."""
    b, s, kv, dh = k.shape
    if s == max_len:
        return k
    out = torch.zeros((b, max_len, kv, dh), dtype=k.dtype, device=k.device)
    out[:, :s] = k
    return out


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: Optional[int] = None, length: Optional[int] = None,
            kv_int8: Optional[bool] = None,
            ctx: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, dict]:
    """Run the prompt; returns (last-position logits (B, V), cache dict).

    ``length`` enables length-masked prefill for bucketed padding:
    ``tokens`` may be right-padded beyond the true prompt length, logits
    are read at position ``length - 1`` and the cache position is set to
    ``length``.  Pad rows write garbage K/V beyond ``length``; decode masks
    the cache at ``pos + 1`` and overwrites those rows token by token, so
    they are never attended.  ``length`` is a host int, or a 0-d integer
    tensor on the tokens' device that is read there, never on the host
    (JAX traces it as an int32, engine.py:224-228): a captured CUDA graph
    of the prefill then serves every length of its bucket.

    The cache holds the K/V leaves the pools hold (``cache_specs``): bf16
    K/V, or under ``kv_int8`` (default: the ``REPRO_KV_INT8`` gate) int8
    codes and bf16 scales of the post-rope K/V (transformer.py:430-445),
    zero past the prompt.  Attention itself runs on the unquantized K/V.
    A sliding-window config attends within the window on its local
    layers and keeps every layer's K/V rolled (``_windowed_cache``); a
    dual-cache config's global layers attend in full and also write their
    full-length K/V into ``global_k``/``global_v``, bf16 whatever the
    params' dtype (transformer.py:341-463).  Windowed caches fold pad rows
    into real ones, so they refuse ``length``; so does the vision family,
    as JAX's does (transformer.py:356-359).  The vision family needs the
    context ``ctx`` (B, n_context_tokens, d_model) (``_prefill_vlm``).
    """
    b, s = tokens.shape
    max_len = max_len or s
    w = cfg.sliding_window
    if length is not None and (cfg.family == "vlm" or w is not None):
        raise NotImplementedError(
            "length-masked prefill requires full (non-windowed) caches")
    quant = attn.kv_int8_enabled(cfg) if kv_int8 is None else kv_int8
    if cfg.family == "vlm":
        return _prefill_vlm(params, tokens, cfg, max_len, ctx, quant)
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(s, device=tokens.device)
    cache = {key: torch.zeros(shape, dtype=dtype, device=x.device)
             for key, (shape, dtype) in cache_specs(cfg, b, max_len,
                                                    quant).items()}
    for i, g in enumerate(global_slots(cfg)):
        x, k, v, _ = block_full(layer_params(params, i), x, cfg,
                                positions=positions,
                                window=w if g is None else None)
        _write_prefill_kv(cache, i, g, k, v, cfg, max_len)
    if torch.is_tensor(length):
        cache["pos"] = length.to(torch.int32, copy=True)
        last = x.index_select(1, (length - 1).reshape(1).long())
    else:
        n = s if length is None else int(length)
        cache["pos"] = torch.tensor(n, dtype=torch.int32, device=x.device)
        last = x[:, n - 1:n]
    return lm_head(params, last, cfg)[:, 0], cache


def _write_prefill_kv(cache: dict, i: int, g: Optional[int],
                      k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                      max_len: int) -> None:
    """Layer i's post-rope K/V (B, S, K, Dh) into ``cache`` as the pools
    hold them: rolled on a windowed config (``_windowed_cache``), a
    global layer's (``g``, its ``global_slots`` entry) also into
    ``global_k``/``global_v``; int8 codes and scales where the cache holds
    ``k_scale``; else bf16 rows [0, S)."""
    s, w = k.shape[1], cfg.sliding_window
    for key, t in (("k", k), ("v", v)):
        if w is not None:
            cache[key][i] = _windowed_cache(t, local_cache_len(cfg, max_len),
                                            max_len)
            if g is not None:
                cache[f"global_{key}"][g, :, :s] = t
            continue
        if "k_scale" in cache:
            t, scale = attn.kv_quantize(t)
            cache[f"{key}_scale"][i, :, :s] = scale
        cache[key][i, :, :s] = t


def _groups(cfg: ModelConfig):
    """(group, [its self layers]) of the vision family: JAX reshapes the
    stacked (L, ...) leaves into (G, every, ...), so layer i is self layer
    i mod every of group i // every."""
    every = cfg.cross_attn_every
    return [(g, range(g * every, (g + 1) * every))
            for g in range(n_cross_layers(cfg))]


def _prefill_vlm(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                 max_len: int, ctx: torch.Tensor, kv_int8: bool
                 ) -> tuple[torch.Tensor, dict]:
    """The vision family's prefill (transformer.py:366-391): each group's
    causal self layers, then its cross layer over ``ctx``.  The self K/V go
    into full-length ``k``/``v`` leaves, each cross layer's projected
    context into ``cross_k``/``cross_v`` (G, B, S_ctx, K, Dh), bf16."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(s, device=tokens.device)
    cache = {key: torch.zeros(shape, dtype=dtype, device=x.device)
             for key, (shape, dtype) in cache_specs(cfg, b, max_len,
                                                    kv_int8).items()}
    for g, layers in _groups(cfg):
        for i in layers:
            x, k, v, _ = block_full(layer_params(params, i), x, cfg,
                                    positions=positions)
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        x, ck, cv = cross_block_full(layer_params(params, g, "cross_layers"),
                                     x, ctx, cfg)
        cache["cross_k"][g] = ck
        cache["cross_v"][g] = cv
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    return lm_head(params, x[:, -1:], cfg)[:, 0], cache


# --------------------------------------------------------------------------
# Decode — one token against the cache
# --------------------------------------------------------------------------


def decode_step(params: dict, token: torch.Tensor, cache: dict,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """token: (B,) int32. Returns (logits (B, V), cache).  The KV pools of
    ``cache`` are written in place; the returned dict holds the same pools
    and the advanced position ``pos + 1`` (every slot advances, as in
    transformer.py:560).  Windowed layers attend their rolled rows; a
    dual-cache config's global layers attend their slot of
    ``global_k``/``global_v`` through the decode kernel and leave their
    rolled rows as they are (transformer.py:526-568)."""
    pos = cache["pos"]
    x = embed_tokens(params, token[:, None], cfg)
    if cfg.family == "vlm":
        return _decode_vlm(params, x, cache, cfg)
    w = cfg.sliding_window
    rolled = w is not None and cache["k"].shape[2] <= w
    for i, g in enumerate(global_slots(cfg)):
        lp = layer_params(params, i)
        if g is not None:
            x = block_decode(lp, x, cache["global_k"][g],
                             cache["global_v"][g], pos, cfg)
        elif "k_scale" in cache:
            x = block_decode_quant(lp, x, cache["k"][i], cache["v"][i],
                                   cache["k_scale"][i], cache["v_scale"][i],
                                   pos, cfg)
        else:
            x = block_decode(lp, x, cache["k"][i], cache["v"][i], pos, cfg,
                             rolled=rolled, window=w)
    return lm_head(params, x, cfg)[:, 0], dict(cache, pos=pos + 1)


def _decode_vlm(params: dict, x: torch.Tensor, cache: dict,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """The vision family's step (transformer.py:477-506): each group's self
    layers against their full caches through the decode kernel, then its
    cross layer against its context cache at ``cache_len = S_ctx``."""
    pos = cache["pos"]
    for g, layers in _groups(cfg):
        for i in layers:
            x = block_decode(layer_params(params, i), x, cache["k"][i],
                             cache["v"][i], pos, cfg)
        x = cross_block_decode(layer_params(params, g, "cross_layers"), x,
                               cache["cross_k"][g], cache["cross_v"][g],
                               cfg)
    return lm_head(params, x, cfg)[:, 0], dict(cache, pos=pos + 1)


def supports_paged(cfg: ModelConfig) -> bool:
    """Full-cache dense and moe configs: every KV row is addressed by
    absolute position, so block tables substitute directly.  Rolled and
    dual caches fold positions (row = pos mod C) and would alias rows
    across blocks (transformer.py:571-578)."""
    return (cfg.family in ("dense", "moe") and cfg.sliding_window is None
            and cfg.local_global_ratio == 0)


def cache_specs(cfg: ModelConfig, batch: int, rows: int, kv_int8: bool
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """KV leaves of a cache of ``batch`` sequences (or pages) of ``rows``
    rows: bf16 K/V, or int8 codes plus (…, K, 1) bf16 scales
    (model.py:212-227, 329-342).  A windowed config's ``k``/``v`` hold
    ``local_cache_len`` rolled rows for every layer, and a dual-cache
    config adds bf16 ``global_k``/``global_v`` of ``rows`` rows for its
    global layers, as JAX's ``cache_shapes`` lays them out.  The vision
    family adds bf16 ``cross_k``/``cross_v`` (G, batch, S_ctx, K, Dh) for
    its cross layers (model.py:202-211)."""
    if kv_int8 and cfg.sliding_window is not None:
        raise ValueError(f"{cfg.name}: int8 KV needs full caches, not "
                         f"rolled ones (attention.py:90-97)")
    if kv_int8 and cfg.family == "vlm":
        raise ValueError(f"{cfg.name}: int8 KV covers the dense and moe "
                         f"families only (attention.py:170-177)")
    kv = (cfg.n_layers, batch, local_cache_len(cfg, rows), cfg.n_kv_heads,
          cfg.dh)
    if not kv_int8:
        specs = {"k": (kv, torch.bfloat16), "v": (kv, torch.bfloat16)}
        if _dual(cfg):
            gkv = (n_global_layers(cfg), batch, rows, cfg.n_kv_heads, cfg.dh)
            specs.update(global_k=(gkv, torch.bfloat16),
                         global_v=(gkv, torch.bfloat16))
        if cfg.family == "vlm":
            ckv = (n_cross_layers(cfg), batch, cfg.n_context_tokens,
                   cfg.n_kv_heads, cfg.dh)
            specs.update(cross_k=(ckv, torch.bfloat16),
                         cross_v=(ckv, torch.bfloat16))
        return specs
    sc = (*kv[:-1], 1)
    return {"k": (kv, torch.int8), "v": (kv, torch.int8),
            "k_scale": (sc, torch.bfloat16), "v_scale": (sc, torch.bfloat16)}


def decode_step_paged(params: dict, token: torch.Tensor, cache: dict,
                      block_tables: torch.Tensor, pos: torch.Tensor,
                      cfg: ModelConfig,
                      active: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, dict]:
    """One decode step against block-paged KV pools {"k", "v"} of
    (L, N, bs, K, Dh) (+ int8 scale pools), written in place.
    block_tables: (B, M) int32; pos: (B,) int32; ``active`` ((B,),
    optional) suppresses free slots' KV writes.  Returns (logits (B, V),
    cache)."""
    x = embed_tokens(params, token[:, None], cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if "k_scale" in cache:
            x = block_decode_paged_quant(
                lp, x, cache["k"][i], cache["v"][i], cache["k_scale"][i],
                cache["v_scale"][i], block_tables, pos, cfg, active)
        else:
            x = block_decode_paged(lp, x, cache["k"][i], cache["v"][i],
                                   block_tables, pos, cfg, active)
    return lm_head(params, x, cfg)[:, 0], cache


# --------------------------------------------------------------------------
# Fused decode — sample on the device, never ship logits to the host
# --------------------------------------------------------------------------


def greedy_tokens(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return ops.greedy_sample(logits, cfg.vocab_size)


def sampled_tokens(logits: torch.Tensor, cfg: ModelConfig, key, sampling
                   ) -> torch.Tensor:
    """The sampler every family's fused step funnels through
    (transformer.py:643-656): greedy without a key or a sampling config,
    else ``ops.sample_tokens`` with ``key``."""
    if key is None or sampling is None:
        return greedy_tokens(logits, cfg)
    return ops.sample_tokens(logits, key, cfg.vocab_size,
                             temperature=sampling.temperature,
                             top_k=sampling.top_k, top_p=sampling.top_p)


def decode_step_tokens(params: dict, token: torch.Tensor, cache: dict,
                       cfg: ModelConfig, key=None, sampling=None):
    """``decode_step`` with the sampler fused in: returns ((B,) int32 next
    tokens, cache) — the engine pulls B int32s per round instead of (B, V)
    logits.  With a ``key`` (a key buffer of ``kernels.keys``) the step
    advances it in place, samples with the split-off key, and returns the
    key as a third element (transformer.py:659-671)."""
    logits, cache = decode_step(params, token, cache, cfg)
    if key is None:
        return greedy_tokens(logits, cfg), cache
    sub = keys.advance(key)
    return sampled_tokens(logits, cfg, sub, sampling), cache, key


def decode_step_paged_tokens(params: dict, token: torch.Tensor, cache: dict,
                             block_tables: torch.Tensor, pos: torch.Tensor,
                             active: torch.Tensor, cfg: ModelConfig,
                             key=None, sampling=None):
    """Fused paged round: the sampled tokens, the cache, and the advanced
    per-slot positions ``pos + active`` (transformer.py:674-692), so the
    position vector stays on the device; free slots (``active == 0``)
    neither write KV nor advance.  A ``key`` is advanced in place and
    returned as a fourth element."""
    active = active.to(torch.int32)
    logits, cache = decode_step_paged(params, token, cache, block_tables,
                                      pos, cfg, active=active)
    if key is None:
        return greedy_tokens(logits, cfg), cache, pos + active
    sub = keys.advance(key)
    return (sampled_tokens(logits, cfg, sub, sampling), cache, pos + active,
            key)


# --------------------------------------------------------------------------
# Speculative verify — score a k+1 window in one forward
# (transformer.py:700-790)
# --------------------------------------------------------------------------


def block_verify(lp: dict, x: torch.Tensor, kc: torch.Tensor,
                 vc: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, _, _ = attn.attn_verify(lp["attn"], h, kc, vc, pos, cfg)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _ffn(lp, h, cfg)[0]


def block_verify_paged(lp: dict, x: torch.Tensor, kc: torch.Tensor,
                       vc: torch.Tensor, block_tables: torch.Tensor,
                       pos: torch.Tensor, cfg: ModelConfig,
                       active: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, _, _ = attn.attn_verify_paged(lp["attn"], h, kc, vc, block_tables,
                                     pos, cfg, active)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + _ffn(lp, h, cfg)[0]


def supports_speculative(cfg: ModelConfig, kv_int8: bool = False) -> bool:
    """The verify step addresses KV rows by absolute position and writes a
    W-row window a round: the full-cache dense and moe configs of the
    paged plane, without int8 KV, whose scale pools would need a windowed
    quantized writer (transformer.py:731-736)."""
    return supports_paged(cfg) and not kv_int8


def _refuse_verify(cfg: ModelConfig, cache: dict) -> None:
    if not supports_speculative(cfg, "k_scale" in cache):
        raise NotImplementedError(
            f"speculative verify requires a full-cache dense/moe config "
            f"with bf16 KV, got {cfg.name} ({cfg.family})")


def verify_step(params: dict, tokens: torch.Tensor, cache: dict,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """Score a speculative window in one forward against a dense cache.
    tokens: (B, W) int32, [last emitted token, k draft tokens].  Writes the
    window's KV rows at ``cache["pos"] .. pos+W-1`` in place and returns
    (f32 logits (B, W, V), cache); ``logits[:, j]`` scores the token after
    window position j.  ``cache["pos"]`` is left as it is: the caller
    folds in the accepted length, and the rejected rows past it are
    garbage the causal mask hides until they are overwritten."""
    _refuse_verify(cfg, cache)
    b = tokens.shape[0]
    pos = cache["pos"].reshape(-1).expand(b).to(torch.int32)
    x = embed_tokens(params, tokens, cfg)
    for i in range(cfg.n_layers):
        x = block_verify(layer_params(params, i), x, cache["k"][i],
                         cache["v"][i], pos, cfg)
    return lm_head(params, x, cfg), cache


def verify_step_paged(params: dict, tokens: torch.Tensor, cache: dict,
                      block_tables: torch.Tensor, pos: torch.Tensor,
                      cfg: ModelConfig,
                      active: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, dict]:
    """``verify_step`` against block-paged pools: the window's rows go
    through the per-position paged scatter (inactive slots write nothing
    new); positions stay with the caller."""
    _refuse_verify(cfg, cache)
    x = embed_tokens(params, tokens, cfg)
    for i in range(cfg.n_layers):
        x = block_verify_paged(layer_params(params, i), x, cache["k"][i],
                               cache["v"][i], block_tables, pos, cfg, active)
    return lm_head(params, x, cfg), cache


# --------------------------------------------------------------------------
# Sharded pods: column-only exact tensor parallelism over a member group
# (src/repro/distributed/README.md:37-85).  Every member runs the whole
# layer on its own copies of the replicated leaves; only the
# column-parallel results cross members, by exact gathers.
# --------------------------------------------------------------------------


def tp_refusal(cfg: ModelConfig) -> Optional[str]:
    """Why a sharded pod cannot serve ``cfg`` yet, or None: the port runs
    the dense and moe families on full, rolled and dual caches, bf16 or
    int8 KV; the rwkv and hybrid families, which JAX runs under a mesh
    through XLA, are ROADMAP.md Queue 1 item 11b."""
    if cfg.family not in ("rwkv", "hybrid"):
        return None
    return (f"{cfg.name}: sharded pods (shards > 1) of the {cfg.family} "
            f"family are not ported yet (ROADMAP.md, Queue 1 item 11b)")


def embed_tokens_tp(members: list, tokens: torch.Tensor, cfg: ModelConfig,
                    group: TPGroup) -> list:
    """Each member's embeddings of ``tokens``: every member looks the
    tokens up in its vocab rows, and each token's row is taken from the
    member that holds it (a masked gather: a selection, exact).  Members
    on one device share the result."""
    toks = on_members(tokens, group)
    rows = members[0]["embed"].shape[0]
    if rows == cfg.padded_vocab:  # the vocab did not divide: replicated
        return [embed_tokens(p, t, cfg) for p, t in zip(members, toks)]
    parts, owned = [], []
    for j, (p, t) in enumerate(zip(members, toks)):
        local = t.long() - j * rows
        owned.append((local >= 0) & (local < rows))
        parts.append(p["embed"][local.clamp(0, rows - 1)])
    by_dev: dict = {}
    for dev in group.devices:
        if dev in by_dev:
            continue
        x = parts[0].to(dev, non_blocking=True)
        for part, own in zip(parts[1:], owned[1:]):
            x = torch.where(own.to(dev, non_blocking=True)[..., None],
                            part.to(dev, non_blocking=True), x)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        by_dev[dev] = x
    return [by_dev[dev] for dev in group.devices]


def lm_head_tp(members: list, xs: list, cfg: ModelConfig, group: TPGroup
               ) -> torch.Tensor:
    """Full f32 logits on the primary: each member's vocab columns of the
    head (or of the tied embedding's transpose), gathered in member
    order."""
    if members[0]["embed"].shape[0] == cfg.padded_vocab:
        return lm_head(members[0], xs[0], cfg)
    return torch.cat([lm_head(p, x, cfg).to(group.primary, non_blocking=True)
                      for p, x in zip(members, xs)], dim=-1)


def _ffn_tp(lps: list, hs: list, cfg: ModelConfig, group: TPGroup
            ) -> list:
    """``_ffn`` of a sharded pod at serving: ``mlp_tp``, or for the moe
    family ``moe_tp`` at ``moe_cf_eval`` (its aux loss dropped)."""
    if cfg.family == "moe":
        return moe_tp([lp["moe"] for lp in lps], hs, cfg, group,
                      cfg.moe_cf_eval)[0]
    return mlp_tp([lp["mlp"] for lp in lps], hs, cfg.mlp, group, cfg.d_ff)


def _blocks_tp(members: list, xs: list, caches: list, cfg: ModelConfig,
               group: TPGroup, positions: list, attend_at) -> list:
    """Every layer over the members: ``attend_at(i, g)`` is layer i's
    ``attn_tp`` callback (``g``: its ``global_slots`` entry).  Whether a
    member attends only its own heads is read off the pool the layer
    attends (``caches``; ``global_k`` on a global layer): split by kv
    head, or replicated, as the pod's placement made it."""
    eps = cfg.norm_eps
    for i, g in enumerate(global_slots(cfg)):
        pool = caches[0]["k" if g is None else "global_k"]
        split = pool.shape[-2] < cfg.n_kv_heads
        lps = [layer_params(p, i) for p in members]
        hs = [rms_norm(x, lp["ln1"], eps) for x, lp in zip(xs, lps)]
        a = attn.attn_tp([lp["attn"] for lp in lps], hs, cfg, group,
                         positions, split, attend_at(i, g))
        xs = [x + y for x, y in zip(xs, a)]
        hs = [rms_norm(x, lp["ln2"], eps) for x, lp in zip(xs, lps)]
        f = _ffn_tp(lps, hs, cfg, group)
        xs = [x + y for x, y in zip(xs, f)]
    return xs


def prefill_tp(members: list, tokens: torch.Tensor, cfg: ModelConfig,
               group: TPGroup, caches: list, *, max_len: int, length=None
               ) -> tuple[torch.Tensor, list]:
    """``prefill`` of a sharded pod into ``caches``, each member's zeroed
    leaves of ``cache_specs`` (``PodModel`` makes them as it makes the
    pools): returns (the last position's logits on the primary, the
    caches, each with its own ``pos``).  Each member writes its heads:
    bf16 K/V, or under int8 (``"k_scale"`` in its cache) their codes and
    scales while it attends the unquantized K/V; a windowed config's
    layers rolled (``_windowed_cache``) and its global layers also into
    ``global_k``/``global_v``, as ``prefill`` writes them.  ``tokens``
    and a tensor ``length`` lie on the primary; a windowed config
    refuses ``length``, as ``prefill`` does."""
    s = tokens.shape[1]
    w = cfg.sliding_window
    if length is not None and w is not None:
        raise NotImplementedError(
            "length-masked prefill requires full (non-windowed) caches")
    xs = embed_tokens_tp(members, tokens, cfg, group)
    positions = on_members(torch.arange(s, device=tokens.device), group)

    def attend_at(i, g):
        def attend(m, q, k, v):
            _write_prefill_kv(caches[m], i, g, k, v, cfg, max_len)
            return ops.flash_attention(q, k, v, causal=True,
                                       window=w if g is None else None)
        return attend

    xs = _blocks_tp(members, xs, caches, cfg, group, positions, attend_at)
    lasts = []
    for c, x, dev in zip(caches, xs, group.devices):
        if torch.is_tensor(length):
            n = length.to(dev, torch.int32, non_blocking=True, copy=True)
            c["pos"] = n
            lasts.append(x.index_select(1, (n - 1).reshape(1).long()))
        else:
            n = s if length is None else int(length)
            c["pos"] = torch.tensor(n, dtype=torch.int32, device=dev)
            lasts.append(x[:, n - 1:n])
    return lm_head_tp(members, lasts, cfg, group)[:, 0], caches


def decode_step_tp(members: list, token: torch.Tensor, caches: list,
                   cfg: ModelConfig, group: TPGroup
                   ) -> tuple[torch.Tensor, list]:
    """``decode_step`` of a sharded pod: each member writes and attends
    its pool at its own ``pos`` with ``decode_step``'s branches (a global
    layer over its slot of ``global_k``/``global_v``, int8 codes, a
    rolled cache within the window, or the full cache), its decode
    kernels splitting S as one device's do (``plan_kv``), so a member's
    heads attend as one device's bit for bit; returns (logits on the
    primary, the caches with every member's ``pos + 1``)."""
    b = token.shape[0]
    kv = cfg.n_kv_heads
    pos_b = [c["pos"].reshape(-1).expand(b) for c in caches]
    xs = embed_tokens_tp(members, token[:, None], cfg, group)
    w = cfg.sliding_window
    rolled = w is not None and caches[0]["k"].shape[2] <= w

    def attend_at(i, g):
        def attend(m, q, k, v):
            c, p = caches[m], pos_b[m]
            if g is not None:
                return attn.decode_attend(q, k, v, c["global_k"][g],
                                          c["global_v"][g], p, plan_kv=kv)
            if "k_scale" in c:
                return attn.decode_attend_quant(
                    q, k, v, c["k"][i], c["v"][i], c["k_scale"][i],
                    c["v_scale"][i], p, plan_kv=kv)
            return attn.decode_attend(q, k, v, c["k"][i], c["v"][i], p,
                                      rolled=rolled, window=w, plan_kv=kv)
        return attend

    xs = _blocks_tp(members, xs, caches, cfg, group,
                    [p[:, None] for p in pos_b], attend_at)
    return (lm_head_tp(members, xs, cfg, group)[:, 0],
            [dict(c, pos=c["pos"] + 1) for c in caches])


def decode_step_paged_tp(members: list, token: torch.Tensor, caches: list,
                         block_tables: torch.Tensor, pos: torch.Tensor,
                         cfg: ModelConfig, group: TPGroup,
                         active: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, list]:
    """``decode_step_paged`` of a sharded pod: one page table (on the
    primary) addresses every member's pool, which holds the member's kv
    heads of every page (under int8 their codes and scales), attended
    with one device's split of S (``plan_kv``)."""
    kv = cfg.n_kv_heads
    tables = on_members(block_tables, group)
    poss = on_members(pos, group)
    acts = (on_members(active, group) if active is not None
            else [None] * group.n)
    xs = embed_tokens_tp(members, token[:, None], cfg, group)

    def attend_at(i, g):
        def attend(m, q, k, v):
            c = caches[m]
            if "k_scale" in c:
                return attn.paged_attend_quant(
                    q, k, v, c["k"][i], c["v"][i], c["k_scale"][i],
                    c["v_scale"][i], tables[m], poss[m], acts[m],
                    plan_kv=kv)
            return attn.paged_attend(q, k, v, c["k"][i], c["v"][i],
                                     tables[m], poss[m], acts[m],
                                     plan_kv=kv)
        return attend

    xs = _blocks_tp(members, xs, caches, cfg, group,
                    [p[:, None] for p in poss], attend_at)
    return lm_head_tp(members, xs, cfg, group)[:, 0], caches

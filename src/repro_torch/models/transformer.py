"""Decoder-only transformer, dense family (counterpart of the dense paths
of ``repro.models.transformer``).

JAX scans over a stacked ``layers`` axis; the port keeps that layout and
loops over it in Python (PyTorch runs eagerly; on the card the serving
engine captures a whole decode round as a CUDA graph,
``serving/graphs.py``).
Decode steps update the preallocated KV pools in place — the counterpart
of the JAX package's donated caches.  A cache made under the int8 gate
holds int8 K/V codes beside ``k_scale``/``v_scale`` pools; the decode
steps dispatch on what the cache holds (``"k_scale" in cache``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (PSpec, mlp_apply, mlp_specs, rms_norm,
                                       stack_tree)


def block_specs(cfg: ModelConfig) -> dict[str, Any]:
    d = cfg.d_model
    return {"ln1": PSpec((d,), init="zeros"), "attn": attn.attn_specs(cfg),
            "ln2": PSpec((d,), init="zeros"),
            "mlp": mlp_specs(d, cfg.d_ff)}


def decoder_specs(cfg: ModelConfig) -> dict[str, Any]:
    d, v, l = cfg.d_model, cfg.padded_vocab, cfg.n_layers
    specs: dict[str, Any] = {
        "embed": PSpec((v, d), init="small"),
        "ln_f": PSpec((d,), init="zeros"),
        "layers": stack_tree(block_specs(cfg), l),
    }
    if not cfg.tie_embeddings:
        specs["head"] = PSpec((d, v))
    return specs


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i`` of the stacked ``layers`` tree (views, no copy)."""
    def pick(tree):
        if isinstance(tree, dict):
            return {k: pick(v) for k, v in tree.items()}
        return tree[i]
    return pick(params["layers"])


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------


def block_full(lp: dict, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence block. Returns (x, k, v)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, k, v = attn.attn_full(lp["attn"], h, cfg, positions=positions)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h), k, v


def block_decode(lp: dict, x: torch.Tensor, kc: torch.Tensor,
                 vc: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, _, _ = attn.attn_decode(lp["attn"], h, kc, vc, pos, cfg)
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h)


def block_decode_quant(lp: dict, x: torch.Tensor, kc, vc, ksc, vsc,
                       pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``block_decode`` against int8 caches (transformer.py:153)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + attn.attn_decode_quant(lp["attn"], h, kc, vc, ksc, vsc, pos, cfg)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h)


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
    return x + mlp_apply(lp["mlp"], h)


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
    return x + mlp_apply(lp["mlp"], h)


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
# Prefill — forward + emit decode caches
# --------------------------------------------------------------------------


def local_cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Rows of a sliding-window layer's cache: the window, or fewer when
    the cache never holds that many (transformer.py:235-237)."""
    w = cfg.sliding_window
    return min(w, max_len) if w else max_len


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
            kv_int8: Optional[bool] = None) -> tuple[torch.Tensor, dict]:
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
    """
    b, s = tokens.shape
    max_len = max_len or s
    quant = attn.kv_int8_enabled(cfg) if kv_int8 is None else kv_int8
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(s, device=tokens.device)
    cache = {key: torch.zeros(shape, dtype=dtype, device=x.device)
             for key, (shape, dtype) in cache_specs(cfg, b, max_len,
                                                    quant).items()}
    for i in range(cfg.n_layers):
        x, k, v = block_full(layer_params(params, i), x, cfg,
                             positions=positions)
        for key, t in (("k", k), ("v", v)):
            if quant:
                t, scale = attn.kv_quantize(t)
                cache[f"{key}_scale"][i, :, :s] = scale
            cache[key][i, :, :s] = t
    if torch.is_tensor(length):
        cache["pos"] = length.to(torch.int32, copy=True)
        last = x.index_select(1, (length - 1).reshape(1).long())
    else:
        n = s if length is None else int(length)
        cache["pos"] = torch.tensor(n, dtype=torch.int32, device=x.device)
        last = x[:, n - 1:n]
    return lm_head(params, last, cfg)[:, 0], cache


# --------------------------------------------------------------------------
# Decode — one token against the cache
# --------------------------------------------------------------------------


def decode_step(params: dict, token: torch.Tensor, cache: dict,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """token: (B,) int32. Returns (logits (B, V), cache).  The KV pools of
    ``cache`` are written in place; the returned dict holds the same pools
    and the advanced position ``pos + 1`` (every slot advances, as in
    transformer.py:560)."""
    pos = cache["pos"]
    x = embed_tokens(params, token[:, None], cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if "k_scale" in cache:
            x = block_decode_quant(lp, x, cache["k"][i], cache["v"][i],
                                   cache["k_scale"][i], cache["v_scale"][i],
                                   pos, cfg)
        else:
            x = block_decode(lp, x, cache["k"][i], cache["v"][i], pos, cfg)
    return lm_head(params, x, cfg)[:, 0], dict(cache, pos=pos + 1)


def supports_paged(cfg: ModelConfig) -> bool:
    """The slice covers full-cache dense SwiGLU configs: every KV row is
    addressed by absolute position, so block tables substitute directly
    (``Model`` refuses any other config)."""
    return (cfg.family == "dense" and cfg.mlp == "swiglu"
            and cfg.sliding_window is None and cfg.local_global_ratio == 0)


def cache_specs(cfg: ModelConfig, batch: int, rows: int, kv_int8: bool
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """KV leaves of a cache of ``batch`` sequences (or pages) of ``rows``
    rows: bf16 K/V, or int8 codes plus (…, K, 1) bf16 scales
    (model.py:212-227, 329-342)."""
    kv = (cfg.n_layers, batch, rows, cfg.n_kv_heads, cfg.dh)
    if not kv_int8:
        return {"k": (kv, torch.bfloat16), "v": (kv, torch.bfloat16)}
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


def decode_step_tokens(params: dict, token: torch.Tensor, cache: dict,
                       cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """``decode_step`` with the greedy sampler fused in: returns ((B,)
    int32 next tokens, cache) — the engine pulls B int32s per round
    instead of (B, V) logits."""
    logits, cache = decode_step(params, token, cache, cfg)
    return greedy_tokens(logits, cfg), cache


def decode_step_paged_tokens(params: dict, token: torch.Tensor, cache: dict,
                             block_tables: torch.Tensor, pos: torch.Tensor,
                             active: torch.Tensor, cfg: ModelConfig
                             ) -> tuple[torch.Tensor, dict, torch.Tensor]:
    """Fused paged round: greedy tokens, the cache, and the advanced
    per-slot positions ``pos + active`` (transformer.py:674-692), so the
    position vector stays on the device.  Free slots (``active == 0``)
    neither write KV nor advance."""
    active = active.to(torch.int32)
    logits, cache = decode_step_paged(params, token, cache, block_tables,
                                      pos, cfg, active=active)
    return greedy_tokens(logits, cfg), cache, pos + active

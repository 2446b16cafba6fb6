"""Decoder-only transformer, dense family (counterpart of the dense paths
of ``repro.models.transformer``).

JAX scans over a stacked ``layers`` axis; the port keeps that layout and
loops over it in Python (PyTorch runs eagerly, there is no ``jit``).
Decode steps update the preallocated KV pools in place — the counterpart
of the JAX package's donated caches.
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


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: Optional[int] = None, length: Optional[int] = None
            ) -> tuple[torch.Tensor, dict]:
    """Run the prompt; returns (last-position logits (B, V), cache dict).

    ``length`` enables length-masked prefill for bucketed padding:
    ``tokens`` may be right-padded beyond the true prompt length, logits
    are read at position ``length - 1`` and the cache position is set to
    ``length``.  Pad rows write garbage K/V beyond ``length``; decode masks
    the cache at ``pos + 1`` and overwrites those rows token by token, so
    they are never attended.
    """
    b, s = tokens.shape
    max_len = max_len or s
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(s, device=tokens.device)
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, cfg.dh)
    kc = torch.zeros(shape, dtype=x.dtype, device=x.device)
    vc = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i in range(cfg.n_layers):
        x, k, v = block_full(layer_params(params, i), x, cfg,
                             positions=positions)
        kc[i, :, :s] = k
        vc[i, :, :s] = v
    n = s if length is None else int(length)
    cache = {"k": kc, "v": vc,
             "pos": torch.tensor(n, dtype=torch.int32, device=x.device)}
    logits = lm_head(params, x[:, n - 1:n], cfg)[:, 0]
    return logits, cache


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
        x = block_decode(layer_params(params, i), x, cache["k"][i],
                         cache["v"][i], pos, cfg)
    return lm_head(params, x, cfg)[:, 0], dict(cache, pos=pos + 1)


def supports_paged(cfg: ModelConfig) -> bool:
    """The slice covers full-cache dense SwiGLU configs: every KV row is
    addressed by absolute position, so block tables substitute directly
    (``Model`` refuses any other config)."""
    return (cfg.family == "dense" and cfg.mlp == "swiglu"
            and cfg.sliding_window is None and cfg.local_global_ratio == 0)


def decode_step_paged(params: dict, token: torch.Tensor, cache: dict,
                      block_tables: torch.Tensor, pos: torch.Tensor,
                      cfg: ModelConfig,
                      active: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, dict]:
    """One decode step against block-paged KV pools {"k", "v"} of
    (L, N, bs, K, Dh), written in place.  block_tables: (B, M) int32;
    pos: (B,) int32; ``active`` ((B,), optional) suppresses free slots'
    KV writes.  Returns (logits (B, V), cache)."""
    x = embed_tokens(params, token[:, None], cfg)
    for i in range(cfg.n_layers):
        x = block_decode_paged(layer_params(params, i), x, cache["k"][i],
                               cache["v"][i], block_tables, pos, cfg, active)
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

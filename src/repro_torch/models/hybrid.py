"""Hymba-style hybrid: parallel attention + SSM heads per layer (counterpart
of ``repro.models.hybrid``, serving paths).

Each layer normalizes the residual stream once, runs a GQA attention path
and a Mamba-style selective-scan path in parallel on the same input,
mean-fuses the per-path outputs after per-path RMS normalization (the
Hymba fusion), then a SwiGLU MLP.  Learnable meta tokens are prepended to
the sequence before the first layer and live at the start of the decode
cache: positions run over the meta tokens and the prompt, and ``pos``
starts at prompt + meta.

Attention is sliding-window (``cfg.sliding_window``), so the decode cache
holds C = min(window, max_len + meta) rows, which is never more than the
window: decode writes row ``pos mod C`` and attends through the rolled
path.  Prefill attention runs on the flash kernel with the window; the
selective scan runs through ``ops.ssm_scan`` (the hand-written kernel on
the card, the plain f32 scan on the CPU), in prefill and in every decode
round.

Decode cache per layer: rolled bf16 K/V (B, C, K, Dh) and the f32 SSM
state (B, H, Dh, N), written in place by the decode step.  ``forward``
(training) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (PSpec, mlp_apply, mlp_specs, rms_norm,
                                       stack_tree)
from repro_torch.models.transformer import (_full_cache, _windowed_cache,
                                            layer_params, lm_head,
                                            local_cache_len)

KV_DTYPE = torch.bfloat16  # the pools' K/V dtype, whatever the params'


def ssm_specs(cfg: ModelConfig) -> dict[str, PSpec]:
    d, n = cfg.d_model, cfg.ssm_state
    h, dh = cfg.n_heads, cfg.dh
    return {
        "w_in": PSpec((d, h * dh)),
        "w_dt": PSpec((d, h)),
        "dt_bias": PSpec((h,), init="small"),
        "a_log": PSpec((h, n), init="small"),
        "w_b": PSpec((d, h * n)),
        "w_c": PSpec((d, h * n)),
        "w_out": PSpec((h * dh, d)),
    }


def block_specs(cfg: ModelConfig) -> dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": PSpec((d,), init="zeros"),
        "attn": attn.attn_specs(cfg),
        "ln_attn": PSpec((d,), init="zeros"),
        "ssm": ssm_specs(cfg),
        "ln_ssm": PSpec((d,), init="zeros"),
        "ln2": PSpec((d,), init="zeros"),
        "mlp": mlp_specs(d, cfg.d_ff),
    }


def n_meta(cfg: ModelConfig) -> int:
    return cfg.n_context_tokens or 128


def hybrid_specs(cfg: ModelConfig) -> dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    return {
        "embed": PSpec((v, d), init="small"),
        "meta": PSpec((n_meta(cfg), d), init="small"),
        "layers": stack_tree(block_specs(cfg), cfg.n_layers),
        "ln_f": PSpec((d,), init="zeros"),
        "head": PSpec((d, v)),
    }


def cache_specs(cfg: ModelConfig, batch: int, max_len: int
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Decode-cache leaves of ``batch`` sequences of up to ``max_len``
    prompt + new tokens (model.py:184-192): rolled bf16 K/V over
    ``local_cache_len(cfg, max_len + meta)`` rows and the f32 SSM state."""
    l, kv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.dh
    c = local_cache_len(cfg, max_len + n_meta(cfg))
    return {"k": ((l, batch, c, kv, dh), KV_DTYPE),
            "v": ((l, batch, c, kv, dh), KV_DTYPE),
            "ssm": ((l, batch, cfg.n_heads, dh, cfg.ssm_state),
                    torch.float32)}


def _ssm_path(p: dict, x: torch.Tensor, state: torch.Tensor,
              cfg: ModelConfig, state_out: torch.Tensor) -> torch.Tensor:
    """The Mamba heads (hybrid.py:70-84): ``dt`` is formed in f32 and cast
    to the activation dtype before the scan, which exponentiates it in
    f32 with ``A = -exp(a_log)``.  The scan writes its final state into
    ``state_out`` (which may be ``state``)."""
    b, s, _ = x.shape
    h, dh, n = cfg.n_heads, cfg.dh, cfg.ssm_state
    xin = (x @ p["w_in"]).reshape(b, s, h, dh)
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"].float())
    bmat = (x @ p["w_b"]).reshape(b, s, h, n)
    cmat = (x @ p["w_c"]).reshape(b, s, h, n)
    y, _ = ops.ssm_scan(xin, dt.to(x.dtype), p["a_log"], bmat, cmat, state,
                        state_out=state_out)
    return y.reshape(b, s, h * dh) @ p["w_out"]


def _fuse(lp: dict, a: torch.Tensor, m: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """Hymba mean fusion of the per-path normalized outputs."""
    return 0.5 * (rms_norm(a, lp["ln_attn"], cfg.norm_eps)
                  + rms_norm(m, lp["ln_ssm"], cfg.norm_eps))


def _block_full(lp: dict, x: torch.Tensor, state0: torch.Tensor,
                cfg: ModelConfig, positions: torch.Tensor,
                state_out: torch.Tensor):
    """Full-sequence block; the final SSM state goes to ``state_out``.
    Returns (x, k, v)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, k, v = attn.attn_full(lp["attn"], h, cfg, positions=positions,
                             window=cfg.sliding_window)
    m = _ssm_path(lp["ssm"], h, state0, cfg, state_out)
    x = x + _fuse(lp, a, m, cfg)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h), k, v


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: Optional[int] = None) -> tuple[torch.Tensor, dict]:
    """Run the meta tokens and the prompt at its exact length; returns
    (last-position logits (B, V), cache).  The cache holds the pools'
    leaves (``cache_specs``): K/V cast to bf16 whatever the activation
    dtype (attention itself runs on the unrounded K/V), the SSM state in
    f32 (the scan writes each layer's final state into the cache from a
    zero state held apart), and ``pos`` = prompt + meta."""
    b, s = tokens.shape
    max_len = max_len or s
    meta = params["meta"]
    rows = max_len + meta.shape[0]  # meta + prompt + new tokens
    x = params["embed"][tokens.long()]
    x = torch.cat([meta[None].expand(b, *meta.shape).to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    state0 = torch.zeros((b, cfg.n_heads, cfg.dh, cfg.ssm_state),
                         dtype=torch.float32, device=x.device)
    w = cfg.sliding_window
    cache = {key: torch.empty(shape, dtype=dtype, device=x.device)
             for key, (shape, dtype) in cache_specs(cfg, b, max_len).items()}
    for i in range(cfg.n_layers):
        x, k, v = _block_full(layer_params(params, i), x, state0, cfg,
                              positions, cache["ssm"][i])
        for key, t in (("k", k), ("v", v)):
            t = t.to(KV_DTYPE)
            cache[key][i] = (_windowed_cache(t, w, rows) if w
                             else _full_cache(t, rows))
    cache["pos"] = torch.tensor(x.shape[1], dtype=torch.int32,
                                device=x.device)
    return lm_head(params, x[:, -1:], cfg)[:, 0], cache


def decode_step(params: dict, token: torch.Tensor, cache: dict,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """token: (B,) int32.  Returns (logits (B, V), cache) with the K/V and
    SSM pools written in place (the scan updates each layer's state view
    of the pool itself) and the position advanced (every slot advances; a
    rolled cache wraps, so nothing clamps)."""
    pos = cache["pos"]
    x = params["embed"][token[:, None].long()]
    w = cfg.sliding_window
    rolled = w is not None and cache["k"].shape[2] <= w
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _, _ = attn.attn_decode(lp["attn"], h, cache["k"][i],
                                   cache["v"][i], pos, cfg, rolled=rolled,
                                   window=w)
        state = cache["ssm"][i]
        m = _ssm_path(lp["ssm"], h, state, cfg, state)
        x = x + _fuse(lp, a, m, cfg)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp_apply(lp["mlp"], h)
    return lm_head(params, x, cfg)[:, 0], dict(cache, pos=pos + 1)

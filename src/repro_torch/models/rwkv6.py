"""RWKV-6 "Finch": attention-free LM with data-dependent decay
(counterpart of ``repro.models.rwkv6``, serving paths).

Per layer: a TimeMix block (token-shift ddlerp for r/k/v/w/g, low-rank
data-dependent decay, WKV recurrence with per-head state, per-head group
norm) and a ChannelMix block (token shift, squared-relu FFN).  The WKV
recurrence runs through ``ops.wkv6_scan`` (the hand-written kernel on the
card, the plain f32 scan on the CPU).

Decode state per layer: (tm_x (B, d), cm_x (B, d), wkv (B, H, 64, 64)
f32), O(1) in sequence length.  ``tm_x``/``cm_x`` are the last rows of the
normed inputs of time_mix / channel_mix.  The decode step writes the
state pools in place.  ``forward`` (training) runs every layer from a
zero WKV state and zero token shifts over the whole sequence.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (COL, EMBED, HEAD, NORM, ROW, PSpec,
                                       checkpointed, rms_norm, stack_tree,
                                       unstack)

DECAY_LORA = 64
HEAD_SIZE = 64


def _heads(cfg: ModelConfig) -> tuple[int, int]:
    """(heads, head size): the head size is fixed at 64, so H = d / 64
    (not ``cfg.n_heads``; the two agree at full width)."""
    return cfg.d_model // HEAD_SIZE, HEAD_SIZE


def time_mix_specs(cfg: ModelConfig) -> dict[str, PSpec]:
    d = cfg.d_model
    h, dh = _heads(cfg)
    return {
        "ln": PSpec((d,), NORM, init="zeros"),
        # token-shift interpolation vectors for r, k, v, w, g
        "mu": PSpec((5, d), (None, None), init="small"),
        "w_r": PSpec((d, d), COL), "w_k": PSpec((d, d), COL),
        "w_v": PSpec((d, d), COL), "w_g": PSpec((d, d), COL),
        "w_o": PSpec((d, d), ROW),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x@a)@b))
        "decay_w0": PSpec((d,), NORM, init="small"),
        "decay_a": PSpec((d, DECAY_LORA), ("fsdp", None)),
        "decay_b": PSpec((DECAY_LORA, d), (None, "fsdp")),
        "bonus_u": PSpec((h, dh), (None, None), init="small"),
        "gn": PSpec((d,), NORM, init="zeros"),  # per-head group norm scale
    }


def channel_mix_specs(cfg: ModelConfig) -> dict[str, PSpec]:
    d, f = cfg.d_model, cfg.d_ff
    return {"ln": PSpec((d,), NORM, init="zeros"),
            "mu": PSpec((2, d), (None, None), init="small"),
            "w_k": PSpec((d, f), COL), "w_v": PSpec((f, d), ROW),
            "w_r": PSpec((d, d), ("fsdp", None))}


def rwkv_specs(cfg: ModelConfig) -> dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    layer = {"tm": time_mix_specs(cfg), "cm": channel_mix_specs(cfg)}
    return {"embed": PSpec((v, d), EMBED, init="small"),
            "ln_in": PSpec((d,), NORM, init="zeros"),
            "layers": stack_tree(layer, cfg.n_layers),
            "ln_f": PSpec((d,), NORM, init="zeros"),
            "head": PSpec((d, v), HEAD)}


def cache_specs(cfg: ModelConfig, batch: int
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Recurrent state leaves (model.py:176-183)."""
    h, dh = _heads(cfg)
    l, d = cfg.n_layers, cfg.d_model
    return {"wkv": ((l, batch, h, dh, dh), torch.float32),
            "tm_x": ((l, batch, d), torch.bfloat16),
            "cm_x": ((l, batch, d), torch.bfloat16)}


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Token shift: the previous token's features (zeros at prefill, the
    carried row at decode)."""
    if last is None:
        return F.pad(x[:, :-1], (0, 0, 1, 0))
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _ddlerp(x: torch.Tensor, shifted: torch.Tensor, mu: torch.Tensor
            ) -> torch.Tensor:
    return x + (shifted - x) * mu.to(x.dtype)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, h: int, dh: int,
                eps: float) -> torch.Tensor:
    """Per-head norm in f32, scaled by ``1 + scale`` (rwkv6.py:87-94)."""
    b, s, d = x.shape
    xf = x.float().reshape(b, s, h, dh)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = ((xf - mu) * torch.rsqrt(var + eps)).reshape(b, s, d)
    return (out * (1.0 + scale.float())).to(x.dtype)


def time_mix(p: dict, x: torch.Tensor, state: torch.Tensor,
             last_x: Optional[torch.Tensor], cfg: ModelConfig
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out, new wkv state, new last_x)."""
    h, dh = _heads(cfg)
    b, s, d = x.shape
    xs = _shift(x, last_x)
    xr, xk, xv, xw, xg = (_ddlerp(x, xs, p["mu"][i]) for i in range(5))
    r = (xr @ p["w_r"]).reshape(b, s, h, dh)
    k = (xk @ p["w_k"]).reshape(b, s, h, dh)
    v = (xv @ p["w_v"]).reshape(b, s, h, dh)
    g = F.silu((xg @ p["w_g"]).float()).to(x.dtype)
    # Data-dependent decay in log space (w <= 0); cast to the activation
    # dtype before the scan, which exponentiates that value in f32.
    lora = torch.tanh(xw.float() @ p["decay_a"].float())
    w = -torch.exp(p["decay_w0"].float() + lora @ p["decay_b"].float())
    out, state = ops.wkv6_scan(r, k, v, w.reshape(b, s, h, dh).to(x.dtype),
                               p["bonus_u"], state)
    out = _group_norm(out.reshape(b, s, d), p["gn"], h, dh, cfg.norm_eps)
    return (out * g) @ p["w_o"], state, x[:, -1, :]


def channel_mix(p: dict, x: torch.Tensor, last_x: Optional[torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor]:
    xs = _shift(x, last_x)
    xk = _ddlerp(x, xs, p["mu"][0])
    xr = _ddlerp(x, xs, p["mu"][1])
    k = torch.square(torch.relu((xk @ p["w_k"]).float())).to(x.dtype)
    r = torch.sigmoid((xr @ p["w_r"]).float()).to(x.dtype)
    return r * (k @ p["w_v"]), x[:, -1, :]


def _block(lp: dict, x: torch.Tensor, wkv: torch.Tensor,
           tm_x: Optional[torch.Tensor], cm_x: Optional[torch.Tensor],
           cfg: ModelConfig
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    h = rms_norm(x, lp["tm"]["ln"], cfg.norm_eps)
    a, wkv, tm_x = time_mix(lp["tm"], h, wkv, tm_x, cfg)
    x = x + a
    h = rms_norm(x, lp["cm"]["ln"], cfg.norm_eps)
    m, cm_x = channel_mix(lp["cm"], h, cm_x)
    return x + m, wkv, tm_x, cm_x


def _layer(params: dict, i: int) -> dict:
    return {part: {k: v[i] for k, v in tree.items()}
            for part, tree in params["layers"].items()}


def _head(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return (x @ params["head"]).float()[:, 0]


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            ctx=None, remat: bool = False, train: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(f32 logits (B, S, V_padded), a zero f32 aux loss) over the whole of
    ``tokens``, every layer from a zero WKV state (rwkv6.py:147-167);
    ``remat`` recomputes each layer in the backward.  ``ctx`` and
    ``train`` are the family signature's, unused."""
    del ctx, train
    b, _ = tokens.shape
    h, dh = _heads(cfg)
    x = rms_norm(params["embed"][tokens.long()], params["ln_in"],
                 cfg.norm_eps)
    wkv0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)

    def body(lp, x):
        return _block(lp, x, wkv0, None, None, cfg)[0]

    body = checkpointed(body, remat)
    for lp in unstack(params["layers"]):
        x = body(lp, x)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return ((x @ params["head"]).float(),
            torch.zeros((), dtype=torch.float32, device=x.device))


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: Optional[int] = None
            ) -> tuple[torch.Tensor, dict]:
    """Run the prompt at its exact length (pad tokens would enter the
    recurrence, so there is no bucketed ``length``); returns
    (last-position logits (B, V), state cache).  ``max_len`` is accepted
    for the common signature and unused: the state is O(1) in length."""
    del max_len
    b, s = tokens.shape
    h, dh = _heads(cfg)
    x = rms_norm(params["embed"][tokens.long()], params["ln_in"],
                 cfg.norm_eps)
    cache = {key: torch.empty(shape, dtype=dtype, device=x.device)
             for key, (shape, dtype) in cache_specs(cfg, b).items()}
    wkv0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, wkv, tm_x, cm_x = _block(_layer(params, i), x, wkv0, None, None,
                                    cfg)
        cache["wkv"][i] = wkv
        cache["tm_x"][i] = tm_x
        cache["cm_x"][i] = cm_x
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    return _head(params, x[:, -1:], cfg), cache


def decode_step(params: dict, token: torch.Tensor, cache: dict,
                cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """token: (B,) int32.  Returns (logits (B, V), cache) with the state
    pools written in place and the position advanced."""
    x = rms_norm(params["embed"][token[:, None].long()], params["ln_in"],
                 cfg.norm_eps)
    for i in range(cfg.n_layers):
        x, wkv, tm_x, cm_x = _block(_layer(params, i), x, cache["wkv"][i],
                                    cache["tm_x"][i], cache["cm_x"][i], cfg)
        cache["wkv"][i] = wkv
        cache["tm_x"][i] = tm_x
        cache["cm_x"][i] = cm_x
    return _head(params, x, cfg), dict(cache, pos=cache["pos"] + 1)

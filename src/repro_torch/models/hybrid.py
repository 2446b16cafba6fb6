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
(training) runs the meta tokens and the sequence through every layer from
a zero SSM state, the scan returning its state (no ``state_out``).

A sharded pod (``prefill_tp``, ``decode_step_tp``) runs the same layers
column-parallel over its members: attention through ``attn.attn_tp``,
the MLP through ``mlp_tp``, and the SSM heads through ``ssm_path_tp``,
each member multiplying its columns of ``w_in``; whether a member holds
its own heads of the K/V and ``ssm`` pools is read off each pool.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (TPGroup, gather_cols,
                                              on_members)
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (COL, EMBED, HEAD, NORM, ROW, PSpec,
                                       checkpointed, mlp_apply, mlp_specs,
                                       mlp_tp, rms_norm, stack_tree, unstack)
from repro_torch.models.transformer import (_full_cache, _windowed_cache,
                                            embed_tokens_tp, layer_params,
                                            lm_head, lm_head_tp,
                                            local_cache_len)

KV_DTYPE = torch.bfloat16  # the pools' K/V dtype, whatever the params'


def ssm_specs(cfg: ModelConfig) -> dict[str, PSpec]:
    d, n = cfg.d_model, cfg.ssm_state
    h, dh = cfg.n_heads, cfg.dh
    return {
        "w_in": PSpec((d, h * dh), COL),
        "w_dt": PSpec((d, h), ("fsdp", None)),
        "dt_bias": PSpec((h,), NORM, init="small"),
        "a_log": PSpec((h, n), (None, None), init="small"),
        "w_b": PSpec((d, h * n), ("fsdp", None)),
        "w_c": PSpec((d, h * n), ("fsdp", None)),
        "w_out": PSpec((h * dh, d), ROW),
    }


def block_specs(cfg: ModelConfig) -> dict[str, Any]:
    d = cfg.d_model
    return {
        "ln1": PSpec((d,), NORM, init="zeros"),
        "attn": attn.attn_specs(cfg),
        "ln_attn": PSpec((d,), NORM, init="zeros"),
        "ssm": ssm_specs(cfg),
        "ln_ssm": PSpec((d,), NORM, init="zeros"),
        "ln2": PSpec((d,), NORM, init="zeros"),
        "mlp": mlp_specs(d, cfg.d_ff, cfg.mlp),
    }


def n_meta(cfg: ModelConfig) -> int:
    return cfg.n_context_tokens or 128


def hybrid_specs(cfg: ModelConfig) -> dict[str, Any]:
    d, v = cfg.d_model, cfg.padded_vocab
    return {
        "embed": PSpec((v, d), EMBED, init="small"),
        "meta": PSpec((n_meta(cfg), d), (None, None), init="small"),
        "layers": stack_tree(block_specs(cfg), cfg.n_layers),
        "ln_f": PSpec((d,), NORM, init="zeros"),
        "head": PSpec((d, v), HEAD),
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


def _ssm_gates(p: dict, x: torch.Tensor, cfg: ModelConfig
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan's ``dt`` (B, S, H), formed in f32 and cast to the
    activation dtype, and its ``B``, ``C`` (B, S, H, N): every head's,
    the products of replicated leaves."""
    b, s, _ = x.shape
    h, n = cfg.n_heads, cfg.ssm_state
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"].float())
    return (dt.to(x.dtype), (x @ p["w_b"]).reshape(b, s, h, n),
            (x @ p["w_c"]).reshape(b, s, h, n))


def _ssm_path(p: dict, x: torch.Tensor, state: torch.Tensor,
              cfg: ModelConfig, state_out: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """The Mamba heads (hybrid.py:70-84): the scan exponentiates ``dt`` in
    f32 with ``A = -exp(a_log)``.  The scan writes its final state into
    ``state_out`` (which may be ``state``); without one (training) the
    state is dropped."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.dh
    xin = (x @ p["w_in"]).reshape(b, s, h, dh)
    dt, bmat, cmat = _ssm_gates(p, x, cfg)
    y, _ = ops.ssm_scan(xin, dt, p["a_log"], bmat, cmat, state,
                        state_out=state_out)
    return y.reshape(b, s, h * dh) @ p["w_out"]


def _fuse(lp: dict, a: torch.Tensor, m: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """Hymba mean fusion of the per-path normalized outputs."""
    return 0.5 * (rms_norm(a, lp["ln_attn"], cfg.norm_eps)
                  + rms_norm(m, lp["ln_ssm"], cfg.norm_eps))


def _block_full(lp: dict, x: torch.Tensor, state0: torch.Tensor,
                cfg: ModelConfig, positions: torch.Tensor,
                state_out: Optional[torch.Tensor] = None):
    """Full-sequence block; the final SSM state goes to ``state_out``
    where one is given.  Returns (x, k, v)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, k, v = attn.attn_full(lp["attn"], h, cfg, positions=positions,
                             window=cfg.sliding_window)
    m = _ssm_path(lp["ssm"], h, state0, cfg, state_out)
    x = x + _fuse(lp, a, m, cfg)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_apply(lp["mlp"], h, cfg.mlp), k, v


def _prepend_meta(meta: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The meta tokens, then the embedded tokens x: (B, meta + S, d)."""
    return torch.cat([meta[None].expand(x.shape[0], *meta.shape).to(x.dtype),
                      x], dim=1)


def _with_meta(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The meta tokens, then the embedded tokens: (B, meta + S, d)."""
    return _prepend_meta(params["meta"], params["embed"][tokens.long()])


def _pool_kv(t: torch.Tensor, cfg: ModelConfig, rows: int) -> torch.Tensor:
    """A layer's K or V (B, S, K, Dh) as the pool holds it: bf16, rolled
    within the window over ``rows`` = meta + prompt + new tokens."""
    t = t.to(KV_DTYPE)
    w = cfg.sliding_window
    return _windowed_cache(t, w, rows) if w else _full_cache(t, rows)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            ctx=None, remat: bool = False, train: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(f32 logits (B, S, V_padded), a zero f32 aux loss): the meta tokens
    and ``tokens`` through every layer from a zero SSM state, the meta
    rows dropped from the logits (hybrid.py:104-125); ``remat`` recomputes
    each layer in the backward.  ``ctx`` and ``train`` are the family
    signature's, unused."""
    del ctx, train
    x = _with_meta(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    state0 = torch.zeros((tokens.shape[0], cfg.n_heads, cfg.dh,
                          cfg.ssm_state), dtype=torch.float32,
                         device=x.device)

    def body(lp, x):
        return _block_full(lp, x, state0, cfg, positions)[0]

    body = checkpointed(body, remat)
    for lp in unstack(params["layers"]):
        x = body(lp, x)
    logits = lm_head(params, x[:, params["meta"].shape[0]:], cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


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
    rows = max_len + params["meta"].shape[0]  # meta + prompt + new tokens
    x = _with_meta(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    state0 = torch.zeros((b, cfg.n_heads, cfg.dh, cfg.ssm_state),
                         dtype=torch.float32, device=x.device)
    cache = {key: torch.empty(shape, dtype=dtype, device=x.device)
             for key, (shape, dtype) in cache_specs(cfg, b, max_len).items()}
    for i in range(cfg.n_layers):
        x, k, v = _block_full(layer_params(params, i), x, state0, cfg,
                              positions, cache["ssm"][i])
        cache["k"][i] = _pool_kv(k, cfg, rows)
        cache["v"][i] = _pool_kv(v, cfg, rows)
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
        x = x + mlp_apply(lp["mlp"], h, cfg.mlp)
    return lm_head(params, x, cfg)[:, 0], dict(cache, pos=pos + 1)


# --------------------------------------------------------------------------
# Sharded pods: column-parallel q/k/v, w_in and the MLP's gate and up,
# gathered before the replicated wo, w_out and w_down (hybrid.py under
# ``serve_pspec``)
# --------------------------------------------------------------------------


def ssm_path_tp(lps: list, hs: list, cfg: ModelConfig, group: TPGroup,
                states: list, state_outs: list) -> list:
    """``_ssm_path`` of a sharded pod.  ``lps``: each member's SSM leaves
    (its columns of ``w_in``, every other leaf whole); ``hs``: each
    member's normed input; ``states``/``state_outs``: each member's scan
    state (B, H_m, Dh, N) and where its final state goes (its pool's
    layer view, which may be ``states``' own).  Where a member's state
    holds only its own heads (H_m < H: the pool split by head), it scans
    its ``w_in`` columns with its heads' slices of ``dt``, ``B``, ``C``
    (each the whole product of a replicated leaf) and ``a_log``, and the
    heads are gathered in member order before ``w_out``.  Otherwise the
    pool is replicated and the columns may end mid-head: ``x @ w_in`` is
    gathered first and every member scans every head on its own copy of
    the state.  Returns each member's (B, S, d)."""
    b, s, _ = hs[0].shape
    h, dh = cfg.n_heads, cfg.dh
    split = states[0].shape[1] < h
    xins = [x @ p["w_in"] for p, x in zip(lps, hs)]
    if not split:
        xins = gather_cols(xins, group, h * dh)
    ys = []
    for m, (p, x, xin, state, out) in enumerate(zip(lps, hs, xins, states,
                                                    state_outs)):
        hm = state.shape[1]
        lo = m * hm if split else 0
        dt, bmat, cmat = (t[:, :, lo:lo + hm].contiguous()
                          for t in _ssm_gates(p, x, cfg))
        y, _ = ops.ssm_scan(xin.reshape(b, s, hm, dh), dt,
                            p["a_log"][lo:lo + hm], bmat, cmat, state,
                            state_out=out)
        ys.append(y.reshape(b, s, hm * dh))
    if split:
        ys = gather_cols(ys, group, h * dh)
    return [y @ p["w_out"] for p, y in zip(lps, ys)]


def _blocks_tp(members: list, xs: list, caches: list, cfg: ModelConfig,
               group: TPGroup, positions: list, attend_at,
               states0: Optional[list] = None) -> list:
    """Every layer over the members: ``attend_at(i)`` is layer i's
    ``attn_tp`` callback; each member's scan writes its final state into
    its ``ssm`` pool's layer view, from ``states0`` (prefill's zero
    states) or from that view itself.  Whether a member attends only its
    own kv heads is read off its ``k`` pool, as the scan reads its heads
    off the ``ssm`` pool."""
    eps = cfg.norm_eps
    split = caches[0]["k"].shape[-2] < cfg.n_kv_heads
    for i in range(cfg.n_layers):
        lps = [layer_params(p, i) for p in members]
        hs = [rms_norm(x, lp["ln1"], eps) for x, lp in zip(xs, lps)]
        a = attn.attn_tp([lp["attn"] for lp in lps], hs, cfg, group,
                         positions, split, attend_at(i))
        pools = [c["ssm"][i] for c in caches]
        m = ssm_path_tp([lp["ssm"] for lp in lps], hs, cfg, group,
                        pools if states0 is None else states0, pools)
        xs = [x + _fuse(lp, y, z, cfg) for x, lp, y, z in zip(xs, lps, a, m)]
        hs = [rms_norm(x, lp["ln2"], eps) for x, lp in zip(xs, lps)]
        f = mlp_tp([lp["mlp"] for lp in lps], hs, cfg.mlp, group, cfg.d_ff)
        xs = [x + y for x, y in zip(xs, f)]
    return xs


def prefill_tp(members: list, tokens: torch.Tensor, cfg: ModelConfig,
               group: TPGroup, caches: list, *,
               max_len: Optional[int] = None) -> tuple[torch.Tensor, list]:
    """``prefill`` of a sharded pod into ``caches``, each member's zeroed
    leaves of ``cache_specs`` (``PodModel`` makes them as it makes the
    pools): every member prepends the replicated meta rows, writes its
    K/V heads rolled over ``max_len + meta`` rows and its scan states, as
    ``prefill`` writes them.  Returns (the last position's logits on the
    primary, the caches, each with its own ``pos`` = prompt + meta)."""
    b, s = tokens.shape
    rows = (max_len or s) + members[0]["meta"].shape[0]
    xs = [_prepend_meta(p["meta"], x) for p, x in
          zip(members, embed_tokens_tp(members, tokens, cfg, group))]
    n = xs[0].shape[1]
    positions = on_members(torch.arange(n, device=tokens.device), group)
    states0 = [torch.zeros(c["ssm"].shape[1:], dtype=torch.float32,
                           device=c["ssm"].device) for c in caches]

    def attend_at(i):
        def attend(m, q, k, v):
            caches[m]["k"][i] = _pool_kv(k, cfg, rows)
            caches[m]["v"][i] = _pool_kv(v, cfg, rows)
            return ops.flash_attention(q, k, v, causal=True,
                                       window=cfg.sliding_window)
        return attend

    xs = _blocks_tp(members, xs, caches, cfg, group, positions, attend_at,
                    states0)
    for c in caches:
        c["pos"] = torch.tensor(n, dtype=torch.int32, device=c["ssm"].device)
    return lm_head_tp(members, [x[:, -1:] for x in xs], cfg,
                      group)[:, 0], caches


def decode_step_tp(members: list, token: torch.Tensor, caches: list,
                   cfg: ModelConfig, group: TPGroup
                   ) -> tuple[torch.Tensor, list]:
    """``decode_step`` of a sharded pod: each member writes its K/V rows
    (rolled within the window) and its scan states in place at its own
    ``pos``; returns (logits on the primary, the caches with every
    member's ``pos + 1``)."""
    b = token.shape[0]
    pos_b = [c["pos"].reshape(-1).expand(b) for c in caches]
    w = cfg.sliding_window
    rolled = w is not None and caches[0]["k"].shape[2] <= w

    def attend_at(i):
        def attend(m, q, k, v):
            c = caches[m]
            return attn.decode_attend(q, k, v, c["k"][i], c["v"][i], pos_b[m],
                                      rolled=rolled, window=w,
                                      plan_kv=cfg.n_kv_heads)
        return attend

    xs = _blocks_tp(members, embed_tokens_tp(members, token[:, None], cfg,
                                             group),
                    caches, cfg, group, [p[:, None] for p in pos_b],
                    attend_at)
    return (lm_head_tp(members, xs, cfg, group)[:, 0],
            [dict(c, pos=c["pos"] + 1) for c in caches])

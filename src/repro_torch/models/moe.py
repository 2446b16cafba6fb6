"""Mixture-of-Experts block: top-k routing with capacity-bucketed dispatch
(counterpart of ``repro.models.moe``'s single-device path,
``_moe_apply_global``, moe.py:184-241).

Tokens pick their top-k experts; each (token, expert) pair takes the next
row of its expert's capacity bucket in token-major order, overflow past
the capacity is dropped to a trash row, the buckets go through a batched
(E, C, D) x (E, D, F) product, and the pair outputs come back weighted by
their gates.  The mesh path (``_moe_apply_shardmap``) needs a training
mesh.  A sharded pod (``shards > 1``) runs ``moe_tp``: JAX under a
serving mesh runs the single-device path on column-split experts, and
so does each member, on its copy of the tokens.

The body runs inside the captured decode round and admission graphs
(``serving/graphs.py``), so nothing in it syncs the host or takes a
data-dependent shape: a pair's rank within its expert is a cumulative
sum over the one-hot of the pair experts (JAX's stable argsort rank with
no sort), top-k is a stable descending sort (JAX's lower-index-first tie
order, which ``torch.topk`` does not promise), and the combine adds a
token's k pair outputs in ascending expert order in ``x.dtype`` — the
order JAX's scatter-add applies them in — with no float atomics, so a
replayed round equals its eager body bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import TPGroup, gather_cols
from repro_torch.kernels.grad import needs_grad
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import COL, ROW, PSpec


def moe_specs(cfg: ModelConfig) -> dict:
    """The block's leaves (moe.py:34-50): an f32 router, stacked expert
    matrices, and the shared experts with their sigmoid gate."""
    d, fe, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    s = {"router": PSpec((d, e), ("fsdp", None), dtype=torch.float32),
         "w_gate": PSpec((e, d, fe), (None, *COL)),
         "w_up": PSpec((e, d, fe), (None, *COL)),
         "w_down": PSpec((e, fe, d), (None, *ROW))}
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * fe
        s["shared"] = {"w_gate": PSpec((d, fs), COL),
                       "w_up": PSpec((d, fs), COL),
                       "w_down": PSpec((fs, d), ROW),
                       "gate": PSpec((d, 1), ("fsdp", None))}
    return s


def _capacity(n_tokens: int, cfg: ModelConfig, factor: float) -> int:
    """Rows of each expert's bucket (moe.py:53-60), clamped to
    ``n_tokens``: an expert takes at most one pair a token."""
    c = int(n_tokens * cfg.top_k * factor / cfg.n_experts) + 1
    return min(max(c, cfg.top_k, 8), max(n_tokens, 1))


def route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig,
          cap: int) -> dict:
    """Routing of the (T, D) tokens ``xt``, in token-major pair order
    (pair ``t * k + j`` is token t's j-th choice): ``gates`` (T, E) f32,
    ``top_w`` / ``top_e`` (T, k) renormalised gate weights and experts in
    descending gate order, ``keep`` (T * k,) whether the pair's rank in
    its expert (the earlier pairs with the same expert) is below ``cap``,
    ``dest`` its bucket row ``e * cap + rank`` or the trash row
    ``E * cap``, and ``counts`` (E,) pairs an expert."""
    gates = torch.softmax(xt.float() @ router.float(), dim=-1)
    top_e = torch.sort(gates, dim=-1, descending=True,
                       stable=True).indices[:, :cfg.top_k]
    return pairs(gates, top_e, cfg, cap)


def pairs(gates: torch.Tensor, top_e: torch.Tensor, cfg: ModelConfig,
          cap: int) -> dict:
    """``route``'s dict for tokens whose gates are ``gates`` (T, E) and
    whose experts are ``top_e`` (T, k): each token's weights over its
    experts renormalised, each pair's rank in its expert, ``keep``,
    ``dest`` and ``counts``."""
    e = cfg.n_experts
    top_w = gates.gather(1, top_e)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    pair_e = top_e.reshape(-1)
    # (E, T * k): the scan runs along the contiguous dim, one row an
    # expert (a scan down the T * k rows of the transpose is serial).
    onehot = (torch.arange(e, device=gates.device)[:, None] == pair_e).to(
        torch.int32)
    seen = onehot.cumsum(1, dtype=torch.int32)  # inclusive, per expert
    rank = seen.gather(0, pair_e[None])[0] - 1
    keep = rank < cap
    dest = torch.where(keep, pair_e * cap + rank,
                       torch.full_like(pair_e, e * cap))
    return dict(gates=gates, top_w=top_w, top_e=top_e, keep=keep, dest=dest,
                counts=seen[:, -1])


def _shared_act(sp: dict, xt: torch.Tensor) -> torch.Tensor:
    """The shared experts' column-parallel half: the SiLU-gated
    activation (T, fs), or a member's columns of it."""
    g = F.silu((xt @ sp["w_gate"]).float()).to(xt.dtype)
    return g * (xt @ sp["w_up"])


def _shared_down(sp: dict, h: torch.Tensor, xt: torch.Tensor
                 ) -> torch.Tensor:
    """The row-parallel half: the whole ``w_down`` times the sigmoid gate
    of ``xt``; the gate's logits in f32, as JAX promotes ``f32 @
    bf16``."""
    mix = torch.sigmoid(xt.float() @ sp["gate"].float())
    return (h @ sp["w_down"]) * mix.to(xt.dtype)


def _shared(sp: dict, xt: torch.Tensor) -> torch.Tensor:
    """The shared experts times their sigmoid gate (moe.py:233-239)."""
    return _shared_down(sp, _shared_act(sp, xt), xt)


def dispatch(xt: torch.Tensor, r: dict, cfg: ModelConfig,
             cap: int) -> torch.Tensor:
    """Each kept pair's token into its bucket row: (E, cap, D), zero where
    a bucket is not full.  Dropped pairs all write the trash row, which is
    cut off (moe.py:218-219)."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    buckets = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=xt.device)
    buckets.index_copy_(0, r["dest"], xt[:, None].expand(t, k, d)
                        .reshape(t * k, d))
    return buckets[:-1].view(e, cap, d)


def _expert_act(params: dict, expert_in: torch.Tensor) -> torch.Tensor:
    """The experts' column-parallel half: (E, cap, fe) SiLU-gated
    activations of the buckets, the SiLU in f32, or a member's columns."""
    h_gate = torch.bmm(expert_in, params["w_gate"])
    h_up = torch.bmm(expert_in, params["w_up"])
    return F.silu(h_gate.float()).to(expert_in.dtype) * h_up


def _expert_down(params: dict, h: torch.Tensor) -> torch.Tensor:
    """The row-parallel half: the whole ``w_down`` over (E, cap, fe), the
    (E * cap, D) outputs, then a zero row that dropped pairs read.
    Serving writes the product straight into the output; under autograd,
    which takes no ``out=``, the rows are concatenated (the same
    values)."""
    e, cap = h.shape[:2]
    d = params["w_down"].shape[-1]
    if needs_grad(h, params["w_down"]):
        out = torch.bmm(h, params["w_down"]).view(e * cap, d)
        return torch.cat([out, out.new_zeros((1, d))])
    flat = torch.empty((e * cap + 1, d), dtype=h.dtype, device=h.device)
    torch.bmm(h, params["w_down"], out=flat[:-1].view(e, cap, d))
    flat[-1].zero_()
    return flat


def experts(params: dict, expert_in: torch.Tensor) -> torch.Tensor:
    """Every expert's SiLU-gated FFN over its bucket (moe.py:222-225):
    ``_expert_down`` of ``_expert_act``."""
    return _expert_down(params, _expert_act(params, expert_in))


def combine(flat: torch.Tensor, r: dict) -> torch.Tensor:
    """(T, D): a token's pair outputs in ascending expert order, weighted by
    (gate * keep) in the outputs' dtype, added in turn, as JAX's
    scatter-add applies them (moe.py:226-231)."""
    t, k = r["top_e"].shape
    order = torch.argsort(r["top_e"], dim=-1)
    dest = r["dest"].view(t, k).gather(1, order)
    w = (r["top_w"] * r["keep"].view(t, k)).gather(1, order).to(flat.dtype)
    pair_out = flat.index_select(0, dest.reshape(-1)).view(t, k, -1) * \
        w[..., None]
    y = pair_out[:, 0]
    for j in range(1, k):
        y = y + pair_out[:, j]
    return y


def aux_loss(r: dict, cfg: ModelConfig) -> torch.Tensor:
    """The Switch load-balancing loss (f32 scalar, moe.py:199-202): E times
    the sum over experts of the mean gate and the share of pairs."""
    t = r["gates"].shape[0]
    ce = r["counts"].float() / (t * cfg.top_k)
    return cfg.n_experts * torch.sum(r["gates"].mean(0) * ce)


def moe_apply(params: dict, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 1.25
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) -> ((B, S, D), aux): the routed experts' combine plus the
    shared experts, and the Switch load-balancing loss (``aux_loss``;
    serving drops it, training adds it to the loss).  Every one of the
    B * S rows takes capacity: free decode slots, prompt padding and every
    row of a verify window (``_capacity`` of B * S)."""
    b, s, d = x.shape
    t = b * s
    cap = _capacity(t, cfg, capacity_factor)
    xt = x.reshape(t, d)
    r = route(params["router"], xt, cfg, cap)
    y = combine(experts(params, dispatch(xt, r, cfg, cap)), r)
    if "shared" in params:
        y = y + _shared(params["shared"], xt)
    return y.view(b, s, d), aux_loss(r, cfg)


def moe_tp(lps: list, hs: list, cfg: ModelConfig, group: TPGroup,
           capacity_factor: float = 1.25) -> tuple[list, torch.Tensor]:
    """``moe_apply`` of a sharded pod (moe.py:184-241 under
    ``serve_pspec``): each member routes and dispatches its own copy of
    the tokens, which every exact exchange keeps bitwise equal, so
    ``dest``/``keep`` agree on every member; it runs its columns of the
    experts' and the shared experts' ``w_gate``/``w_up``; the
    activations are gathered in member order before the whole ``w_down``
    each member holds.  lps, hs: each member's moe leaves and (B, S, D)
    input.  Returns (each member's output, the primary's aux loss)."""
    b, s, d = hs[0].shape
    t = b * s
    cap = _capacity(t, cfg, capacity_factor)
    xts = [h.reshape(t, d) for h in hs]
    routes = [route(lp["router"], xt, cfg, cap) for lp, xt in zip(lps, xts)]
    acts = gather_cols([_expert_act(lp, dispatch(xt, r, cfg, cap))
                        for lp, xt, r in zip(lps, xts, routes)],
                       group, cfg.expert_d_ff)
    ys = [combine(_expert_down(lp, a), r)
          for lp, a, r in zip(lps, acts, routes)]
    if "shared" in lps[0]:
        sps = [lp["shared"] for lp in lps]
        sh = gather_cols([_shared_act(sp, xt) for sp, xt in zip(sps, xts)],
                         group, cfg.n_shared_experts * cfg.expert_d_ff)
        ys = [y + _shared_down(sp, a, xt)
              for y, sp, a, xt in zip(ys, sps, sh, xts)]
    return [y.view(b, s, d) for y in ys], aux_loss(routes[0], cfg)

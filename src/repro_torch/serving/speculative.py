"""Speculative decoding and on-device sampling on the sync-free round
(counterpart of ``repro.serving.speculative``).

A draft model proposes ``k`` tokens; the target scores the whole window
``[t0, d_1..d_k]`` in one ``verify_step`` forward; on-device rejection
sampling (``ops.speculative_verify``) folds the accepted prefix plus one
corrected or bonus token back into the round.  The k draft steps, the
verify forward, the fold, the position advance and the key's advance are
one round body over the instance's fixed buffers, written in place, so
the instance's ``RoundGraph`` captures the whole draft-k / verify-1 round
as one CUDA graph, and a pump pass still spends one host sync (it pulls
the (B, k+1) window and the (B,) emitted counts).

Cache discipline (speculative.py:14-29 of the JAX package):

* **Target cache** — the verify step writes the window's KV rows at
  ``pos..pos+k``; the position advances by the emitted count only.
  Rejected rows past it are garbage the causal mask hides until the next
  round overwrites them, so a rollback is a position trim: no block is
  freed and no shared block written (the engine resolves copy-on-write
  for every block the window can touch before it dispatches).
* **Draft cache** — a dense slot pool beside the target's (even under a
  paged target).  Each round first sets its positions to the target's;
  then k+1 draft steps write rows ``pos..pos+k`` (the last step's logits
  are discarded: it only fills row ``pos+k``, which a fully accepted
  round moves past).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.scaling import expected_tokens_per_round  # noqa: F401
from repro_torch.kernels import keys, ops
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """On-device stochastic sampling for the fused round.
    ``temperature == 0`` is greedy, bit for bit.  ``seed`` makes the
    instance's key (``kernels.keys.new_key``); the ``fused=False``
    reference replays the same key stream, so fused and unfused sampled
    runs give the same tokens."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self) -> None:
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got "
                             f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0 < self.top_p <= 1 and not (self.top_p == 0
                                            and self.temperature == 0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingConfig(temperature=0.0)


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding for a ``FunctionInstance``: ``draft_cfg`` is
    the draft's ``ModelConfig`` (the target's real vocab; its padding may
    differ); ``k`` tokens are proposed a round, so a round emits 1 to
    ``k + 1`` tokens a slot."""

    draft_cfg: Any
    k: int = 4
    seed: int = 0

    def __post_init__(self) -> None:
        if self.k < 1:
            raise ValueError(f"speculation depth k must be >= 1, got "
                             f"{self.k}")
        if getattr(self.draft_cfg, "vocab_size", None) is None:
            raise ValueError("draft_cfg must be a ModelConfig-like object "
                             "with a vocab_size")


def _draft_propose(draft_model, dparams, tok: torch.Tensor, dcache: dict,
                   draft_keys: torch.Tensor, sampling: SamplingConfig,
                   k: int) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """k draft decode steps, then one more whose logits are discarded (it
    writes row ``pos+k``).  Returns (draft tokens (B, k) int32, draft
    logits (B, k, Vd), the draft cache with positions ``pos + k + 1``).
    With draft == target the chain is the plain decode computation."""
    dcfg = draft_model.cfg
    t = tok
    toks, logits_list = [], []
    for j in range(k):
        logits, dcache = draft_model.decode_step(dparams, t, dcache)
        t = transformer.sampled_tokens(logits, dcfg, draft_keys[j], sampling)
        toks.append(t)
        logits_list.append(logits)
    _, dcache = draft_model.decode_step(dparams, t, dcache)
    return torch.stack(toks, dim=1), torch.stack(logits_list, dim=1), dcache


def _verify_fold(cfg, tlogits: torch.Tensor, draft_logits: torch.Tensor,
                 draft_tokens: torch.Tensor, vkey: torch.Tensor,
                 sampling: SamplingConfig
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rejection-sample the window on the device: (out (B, k+1), n_emit
    (B,), the next input token (B,)), all int32."""
    out, n_accept = ops.speculative_verify(
        tlogits, draft_logits, draft_tokens, vkey, cfg.vocab_size,
        temperature=sampling.temperature, top_k=sampling.top_k,
        top_p=sampling.top_p, greedy=sampling.greedy)
    tok_new = torch.gather(out, 1, n_accept.long()[:, None])[:, 0]
    return out, n_accept + 1, tok_new


def _propose(draft_model, dparams, tok, dcache, key, pos, sampling, k):
    """The round's head: split the key (``k + 2`` keys: the next key, k
    draft keys, the verify key), point the draft's positions at the
    target's, propose.  Returns (window (B, k+1), draft logits, draft
    tokens, verify key, the next key)."""
    ks = keys.split(key, k + 2)
    dcache["pos"].copy_(pos)
    draft_tokens, draft_logits, advanced = _draft_propose(
        draft_model, dparams, tok, dict(dcache), ks[1:k + 1], sampling, k)
    dcache["pos"].copy_(advanced["pos"])
    window = torch.cat([tok[:, None], draft_tokens], dim=1)
    return window, draft_logits, draft_tokens, ks[k + 1], ks[0]


def spec_round_continuous(model, draft_model, k: int,
                          sampling: SamplingConfig):
    """The continuous speculative round body (speculative.py:122-149):

    ``round(params, dparams, tok, cache, dcache, key, out, n_emit)``

    writes, in place: the target pools and the draft pools (their rows
    ``pos..pos+k``), the slot positions ``cache["pos"] + n_emit`` (every
    slot advances, as in JAX), the draft positions, the key, ``out``
    (B, k+1), ``n_emit`` (B,) and the slot tokens ``tok`` (each slot's
    last emitted token).  Returns the verify logits (for checks)."""
    cfg = model.cfg

    def round_fn(params, dparams, tok, cache, dcache, key, out, n_emit):
        window, draft_logits, draft_tokens, vkey, next_key = _propose(
            draft_model, dparams, tok, dcache, key, cache["pos"], sampling,
            k)
        tlogits, _ = model.verify_step(params, window, cache)
        o, n, tok_new = _verify_fold(cfg, tlogits, draft_logits,
                                     draft_tokens, vkey, sampling)
        cache["pos"].copy_(cache["pos"] + n)
        key.copy_(next_key)
        out.copy_(o)
        n_emit.copy_(n)
        tok.copy_(tok_new)
        return tlogits

    return round_fn


def spec_round_paged(model, draft_model, k: int, sampling: SamplingConfig):
    """The paged speculative round body (speculative.py:152-180):

    ``round(params, dparams, tok, cache, dcache, tables, pos, active, key,
    out, n_emit)``

    as ``spec_round_continuous``, but the target writes through the
    per-position paged scatter (inactive slots write nothing new; the
    engine resolved copy-on-write for the whole window), and free slots
    neither emit nor advance: ``n_emit * active``, ``pos + n_emit``."""
    cfg = model.cfg

    def round_fn(params, dparams, tok, cache, dcache, tables, pos, active,
                 key, out, n_emit):
        active = active.to(torch.int32)
        window, draft_logits, draft_tokens, vkey, next_key = _propose(
            draft_model, dparams, tok, dcache, key, pos, sampling, k)
        tlogits, _ = model.verify_step_paged(params, window, cache, tables,
                                             pos, active)
        o, n, tok_new = _verify_fold(cfg, tlogits, draft_logits,
                                     draft_tokens, vkey, sampling)
        n = n * active
        pos.copy_(pos + n)
        key.copy_(next_key)
        out.copy_(o)
        n_emit.copy_(n)
        tok.copy_(tok_new)
        return tlogits

    return round_fn

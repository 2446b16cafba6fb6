"""How ``correct`` is decided for a served model: once the window has
closed, a sample (drawn from the seed) of the requests the program
finished, with the longest among them, is run through the plain
reference (``bench/reference``) over each prompt and its served tokens.
At each served token the reference's logits give the gap by which the
served token lies below the reference's best token (0 where they agree).
The numbers compared are read from the gaps:

* ``gap_max``: the widest gap over every served token of the sample;
* ``gap_mean``: the mean gap a served token.

A cell's limits (``bench/limits/<cell>.json``) name the numbers it
compares; each comes out beside its limit.  The control (``--control 1``)
puts the reference computed with fp8 products in the program's place:
at each of the same positions the token the control puts first, read in
the float32 reference's logits."""

from __future__ import annotations

import numpy as np
import torch

from bench.reference.decoder import Forward
from bench.weights import flatten

NUMBERS = ("gap_max", "gap_mean")
TIE = 1e-2  # a routing margin below this is a near-tie (info only)


def sample(finished: list, traffic: dict, seed: int) -> list:
    """Requests to check, from those finished: the longest (prompt and
    output), then others in an order drawn from ``seed``, until the
    sample holds ``check.served_tokens`` served tokens or the next one
    would take the reference past ``check.ref_tokens`` tokens."""
    if not finished:
        return []
    want, budget = traffic["check"]["served_tokens"], \
        traffic["check"]["ref_tokens"]
    size = [len(r.prompt) + len(r.tokens_out) for r in finished]
    first = int(np.argmax(size))
    rng = np.random.default_rng([seed, 3])
    order = [first] + [i for i in rng.permutation(len(finished))
                       if i != first]
    picked, served, total = [], 0, 0
    for i in order:
        if picked and (served >= want or total + size[i] > budget):
            break
        picked.append(finished[i])
        served += len(finished[i].tokens_out)
        total += size[i]
    return picked


def _gaps(ref: list[torch.Tensor], chosen: list[np.ndarray]) -> np.ndarray:
    out = []
    for lg, toks in zip(ref, chosen):
        t = torch.as_tensor(toks, dtype=torch.long, device=lg.device)
        best = lg.max(-1).values
        out.append((best - lg.gather(1, t[:, None])[:, 0]).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def numbers(gaps: np.ndarray) -> dict:
    if gaps.size == 0:
        return {k: float("inf") for k in NUMBERS}
    return {"gap_max": float(gaps.max()), "gap_mean": float(gaps.mean())}


def run_check(reqs: list, m: dict, weights: dict, device,
              control: bool = False) -> dict:
    """The gaps' numbers of the sampled requests ``reqs`` against the
    float32 reference (and, with ``control``, the control's own), with
    TF32 off for the reference's products."""
    flat = flatten(weights)
    seqs, first, served = [], [], []
    for r in reqs:
        toks = np.concatenate([np.asarray(r.prompt, np.int64),
                               np.asarray(r.tokens_out[:-1], np.int64)])
        seqs.append(torch.as_tensor(toks, device=device))
        first.append(len(r.prompt) - 1)
        served.append(np.asarray(r.tokens_out, np.int64))
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            fwd = Forward(m, flat)
            ref = fwd.logits(seqs, first)
            gaps = _gaps(ref, served)
            out = {"program": numbers(gaps),
                   "tokens": int(sum(len(s) for s in served)),
                   "requests": len(reqs)}
            if m["family"] == "moe" and reqs:  # the look: gaps where routing is clear
                clear = np.concatenate([
                    (mg[f:] >= TIE).cpu().numpy()
                    for mg, f in zip(fwd.margins, first)])
                out["untied"] = {"tokens": int(clear.sum()),
                                 "gap_max": float(gaps[clear].max())
                                 if clear.any() else 0.0}
            if control:
                low = Forward(m, flat, "fp8").logits(seqs, first)
                picks = [lg.argmax(-1).cpu().numpy() for lg in low]
                del low
                out["control"] = numbers(_gaps(ref, picks))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    return out


def verdict(program: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {value, limit}}) over the numbers the cell's
    limits name; a number at or above its limit fails."""
    shown = {k: {"value": program[k], "limit": lim["limit"]}
             for k, lim in limits.items() if k in NUMBERS}
    ok = bool(shown) and all(v["value"] < v["limit"] for v in shown.values())
    return ok, shown

"""The benchmark's traffic: one general generator that reads a traffic
file (``bench/traffic/<mix>.json``) and makes the requests of one run.

* ``poisson_arrivals`` is a frozen copy of the port's
  ``repro_torch.core.workload.poisson_arrivals`` (returning times, not
  request objects), kept here so that a change to the program cannot
  change the yardstick.
* Sizes and gaps come from the file's ``size_seed`` in one sequence, and
  the run's ``--seed`` only reorders them inside consecutive blocks of
  ``order_block`` requests, and draws the prompt tokens.  Every seed then
  sends the same work in each stretch of the run (a closed loop's window
  reaches only the head of its pool), and an open loop offers exactly
  its rate.
* An open loop (``"loop": "open"``) sends its requests at their due
  times whatever the system does; a closed loop (``"loop": "closed"``)
  keeps ``clients`` requests in flight, each client sending its next
  request when the previous one has finished.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Planned:
    """One request as the traffic plans it: when it is due (seconds from
    the window's start; None in a closed loop, where it is due when a
    client frees), its prompt length, its output length and its index
    (which draws its prompt tokens)."""

    index: int
    prompt_len: int
    max_new: int
    due: float | None = None


def poisson_arrivals(rps: float, duration: float, *, seed: int = 0,
                     start: float = 0.0) -> list[float]:
    """Open-loop Poisson arrival times at ``rps`` for ``duration``
    seconds (``core/workload.py:177``)."""
    rng = np.random.default_rng(seed)
    out: list[float] = []
    t = start
    while True:
        t += rng.exponential(1.0 / rps)
        if t >= start + duration:
            break
        out.append(t)
    return out


def draw_lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths from a length spec: ``lognormal`` (``median``,
    ``sigma``) clipped to [``min``, ``max``], or ``uniform`` over the
    whole numbers in [``min``, ``max``]."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        x = rng.lognormal(np.log(spec["median"]), spec["sigma"], n)
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, n).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def _sizes(traffic: dict, n: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(traffic["size_seed"])
    return (draw_lengths(traffic["prompt"], n, rng),
            draw_lengths(traffic["output"], n, rng))


def block_permutation(rng: np.random.Generator, n: int,
                      block: int) -> np.ndarray:
    """A permutation of ``range(n)`` that moves each index only inside its
    block of ``block`` consecutive indices."""
    return np.concatenate([a + rng.permutation(min(block, n - a))
                           for a in range(0, n, block)] or [[]]
                          ).astype(np.int64)


def plan(traffic: dict, seconds: float, seed: int) -> list[Planned]:
    """The run's requests in the order they are sent.  Open: ``rate_per_s
    * seconds`` requests (rounded), due at the first of ``n + 1`` gaps of
    one Poisson draw from ``size_seed``, reordered by ``seed`` (in blocks
    of ``order_block``) and stretched so that the ``n + 1`` gaps span
    ``seconds``: every request is due in ``[0, seconds)`` and the offered
    rate is the file's.  Closed: the pool of ``pool`` requests, reordered
    by ``seed`` in blocks of ``order_block``."""
    order = np.random.default_rng([seed, 1])
    block = int(traffic["order_block"])
    if traffic["loop"] == "open":
        rate = traffic["rate_per_s"]
        n = int(round(rate * seconds))
        times = poisson_arrivals(rate, 2.0 * seconds + 10.0 * (n + 1) / rate,
                                 seed=traffic["size_seed"])[:n + 1]
        gaps = np.diff(np.array([0.0, *times]))
        gaps = gaps[block_permutation(order, n + 1, block)]
        due = np.cumsum(gaps)[:n] * (seconds / gaps.sum())
        prompt, out = _sizes(traffic, n)
        perm = block_permutation(order, n, block)
        return [Planned(i, int(prompt[j]), int(out[j]), float(due[i]))
                for i, j in enumerate(perm)]
    if traffic["loop"] == "closed":
        n = int(traffic["pool"])
        prompt, out = _sizes(traffic, n)
        perm = block_permutation(order, n, block)
        return [Planned(i, int(prompt[j]), int(out[j]))
                for i, j in enumerate(perm)]
    raise ValueError(f"unknown loop {traffic['loop']!r}")


def prompt_tokens(p: Planned, vocab: int, seed: int) -> np.ndarray:
    """The prompt of request ``p``: ids drawn uniformly from the
    vocabulary by the run's seed and the request's index."""
    rng = np.random.default_rng([seed, 2, p.index])
    return rng.integers(0, vocab, p.prompt_len).astype(np.int32)


def all_prompt_lengths(traffic: dict, seconds: float) -> list[int]:
    """Every prompt length the mix can send in a run of ``seconds`` (the
    same for every seed), for the warm-up."""
    return sorted({p.prompt_len for p in plan(traffic, seconds, 0)})

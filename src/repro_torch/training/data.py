"""Synthetic LM data (counterpart of ``repro.training.data``): the same
deterministic, seekable numpy stream as the JAX package's, bit for bit.

A structured synthetic language (a Markov rule over ``structure`` tokens
with 10% noise) so a model shows a real, monotonic loss curve in a few
hundred steps: uniform tokens would pin the loss at log(V).  Batches are
host tensors; the train step moves them to the params' device.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch


def make_batch(vocab: int, batch: int, seq: int, step: int, *,
               seed: int = 0, structure: int = 64) -> dict:
    """The batch of ``step`` (seekable, hence restart-safe): int32
    ``tokens`` and ``labels`` (B, S), the labels the tokens shifted by
    one (data.py:16-37)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    a = 2 * rng.integers(1, structure // 2) + 1
    b = rng.integers(0, structure)
    toks = np.empty((batch, seq + 1), np.int64)
    toks[:, 0] = rng.integers(0, structure, batch)
    for t in range(seq):
        nxt = (a * toks[:, t] + b) % structure
        noise = rng.random(batch) < 0.1
        nxt = np.where(noise, rng.integers(0, structure, batch), nxt)
        toks[:, t + 1] = nxt
    toks = toks % vocab
    return {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
            "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}


def batch_iterator(vocab: int, batch: int, seq: int, *, seed: int = 0,
                   start_step: int = 0, ctx_shape: Optional[tuple] = None
                   ) -> Iterator[dict]:
    """``make_batch`` of ``start_step``, ``start_step + 1``, ...; with
    ``ctx_shape`` each batch also holds a bf16 ``ctx`` drawn as normal *
    0.02 in float64 and cast to bf16 as ``jnp.asarray(..., bfloat16)``
    casts it: torch's cast rounds through f32 as that one does, bit for
    bit (data.py:40-48)."""
    step = start_step
    rng = np.random.default_rng(seed + 1)
    while True:
        out = make_batch(vocab, batch, seq, step, seed=seed)
        if ctx_shape is not None:
            out["ctx"] = torch.from_numpy(
                rng.normal(size=ctx_shape) * 0.02).to(torch.bfloat16)
        yield out
        step += 1

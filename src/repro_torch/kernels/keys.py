"""The port's random key stream: an explicit key, split and turned into
noise by a counter-based integer hash (the counterpart of the
``jax.random`` keys the JAX package threads through its sampled paths:
one split per admitted prefill, engine.py:664-673; one per round,
transformer.py:667-671; ``k + 2`` per speculative round,
speculative.py:149-151; two inside the sampled verify, ops.py:274).

A key is a (2,) int64 tensor holding two 32-bit words, on the device of
the tensors it draws for.  Every draw is a pure function of the key and
an element counter: ``bits(key, c) = h(h(c ^ k0) ^ k1)`` with ``h`` the
32-bit integer hash ``lowbias32`` (a bijection of 32-bit words), computed
with torch integer ops on int64 and masked to 32 bits, products split in
16-bit halves so that no intermediate leaves int64's range.  The CPU and
the card therefore give the same bits, and a captured CUDA graph, which
reads the key from its buffer at every replay, draws what the eager round
would.  There is no ``torch.Generator``: a graph advances a generator's
Philox offset in its own way, while a key held in a device buffer and
advanced in place (``advance``) keeps the eager first round, the capture
and the replays on one stream by construction.

The bits are not ``jax.random``'s: sampled streams are compared with the
JAX package by distribution only, and exactly between the port's own
paths (fused against ``fused=False``) and devices.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROOT = (0x243F6A88, 0x85A308D3)  # the key words of seed 0's root, xored in


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``: each partial product stays below 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 of int64 words in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def bits(key: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """32-bit words (int64) of ``key`` at each int64 ``counter``."""
    return hash32(hash32(counter ^ key[0]) ^ key[1])


def new_key(seed: int, device=None) -> torch.Tensor:
    """The root key of ``seed`` (a fresh buffer; a serving instance keeps
    it for its life and advances it in place)."""
    root = torch.tensor([(seed & MASK32) ^ _ROOT[0],
                         ((seed >> 32) & MASK32) ^ _ROOT[1]],
                        dtype=torch.int64, device=device)
    return bits(root, torch.arange(2, device=device))


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``n`` new keys, (n, 2): row i is key i (``jax.random.split``)."""
    return bits(key, torch.arange(2 * n, device=key.device)).view(n, 2)


def advance(key: torch.Tensor) -> torch.Tensor:
    """``key, sub = split(key)`` with the key buffer written in place:
    returns ``sub``."""
    new = split(key, 2)
    key.copy_(new[0])
    return new[1]


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """f32 uniforms strictly inside (0, 1): the top 24 bits of each word
    times 2**-24 (exact in f32, at most 1 - 2**-24), the zero word raised
    to 2**-24."""
    n = 1
    for s in shape:
        n *= int(s)
    top = bits(key, torch.arange(n, device=key.device)) >> 8
    u = top.to(torch.float32) * 2.0 ** -24
    return torch.clamp(u, min=2.0 ** -24).view(tuple(shape))


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, f32."""
    return -torch.log(-torch.log(uniform(key, shape)))

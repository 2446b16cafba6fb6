"""Operations and bytes, and the card's peaks: the yardstick's arithmetic.

A frozen copy of the port's ``analysis/roofline.py`` (``model_flops``,
``_flash_flops``, ``_decode_flops``) and ``launch/mesh.py`` (the H100's
peaks), corrected in two places:

* a window is counted causally: query ``i`` of a call whose first query
  sits ``offset`` rows past the first key attends ``min(i + 1 + offset,
  w)`` keys, as the kernels' mask defines the window (key ``j`` is in it
  when ``i - w < j <= i``).  The program counts ``s * min(s, w)``, the
  full block, which is twice the causal work inside the window;
* each input byte is read once and each output byte written once,
  whatever the kernel reads again.

Everything here is a function of shapes; nothing reads the program.
"""

from __future__ import annotations

from typing import Optional

PEAK_FLOPS = 989e12   # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
BF16 = 2


def attn_pairs(n: int, window: Optional[int] = None, offset: int = 0) -> int:
    """(query, key) pairs of ``n`` causal queries whose first sits
    ``offset`` rows past the first key: sum over i of min(i + 1 + offset,
    window)."""
    if n <= 0:
        return 0
    lo, hi = offset + 1, offset + n  # keys of the first and last query
    if window is None or hi <= window:
        return (lo + hi) * n // 2
    if lo >= window:
        return window * n
    m = window - lo  # queries below the cap: lo .. window - 1 keys
    return (lo + window - 1) * m // 2 + window * (n - m)


def flash_cost(n: int, heads: int, kv_heads: int, dh: int,
               window: Optional[int] = None) -> tuple[float, float]:
    """(FLOPs, bytes) of one causal prefill attention call of ``n`` rows:
    QK^T and PV (4 H D FLOPs a pair), q, k, v read once and o written
    once in bf16."""
    flops = 4.0 * heads * dh * attn_pairs(n, window)
    nbytes = BF16 * n * dh * (2 * heads + 2 * kv_heads)
    return flops, float(nbytes)


def decode_cost(rows: list[int], heads: int, kv_heads: int,
                dh: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one decode attention call over the sequences
    whose key counts are ``rows``: each sequence's K and V rows read
    once, its q read and its output written once, in bf16."""
    keys = sum(rows)
    flops = 4.0 * heads * dh * keys
    nbytes = BF16 * dh * (2 * kv_heads * keys + 2 * heads * len(rows))
    return flops, float(nbytes)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the peak
    rate or bytes over the peak bandwidth, whichever is longer."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def matmul_params(m: dict) -> int:
    """Parameters a token multiplies through (``model_flops``' active
    params less the embedding gather): every layer's projections, the
    routed experts it reaches (top-k of them) and the router, and the
    output head.  ``m`` is the harness's model description
    (``bench.spec.model_dims``)."""
    d, hq, kv = m["d_model"], m["n_heads"] * m["dh"], m["n_kv_heads"] * m["dh"]
    attn = d * hq + 2 * d * kv + hq * d
    if m["family"] == "moe":
        ffn = d * m["n_experts"] + m["top_k"] * 3 * d * m["d_ff"]
    else:
        ffn = (3 if m["gated"] else 2) * d * m["d_ff"]
    return m["n_layers"] * (attn + ffn) + d * m["vocab"]


def prefill_flops(m: dict, n: int) -> float:
    """Model FLOPs of a prefill of ``n`` prompt tokens: 2 per matmul
    parameter a token, plus causal attention within the window on every
    layer."""
    attn = 4.0 * m["n_heads"] * m["dh"] * attn_pairs(n, m["window"])
    return 2.0 * matmul_params(m) * n + m["n_layers"] * attn


def decode_flops(m: dict, keys: int) -> float:
    """Model FLOPs of one decoded token that attends ``keys`` keys (capped
    by the window) on every layer."""
    w = m["window"]
    k = min(keys, w) if w else keys
    return (2.0 * matmul_params(m)
            + m["n_layers"] * 4.0 * m["n_heads"] * m["dh"] * k)

"""Decode attention, dense and paged: CUDA kernel wrappers, plain
versions, launch counters.

Kernels: ``csrc/decode_attention.cu`` (replace
``repro/kernels/decode_attention.py::decode_attention_pallas`` and
``::paged_decode_attention_pallas``; the source note there says what
bounds them and what their design does about it).  Plain versions: the
masked-softmax decode of ``repro/kernels/ops.py::decode_attention`` (xla
path) and, for pages, the gather-then-dense path of
``ops.paged_decode_attention``.

Each wrapper takes its plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor, or raises; ``<wrapper>.launches`` counts
kernel launches.  The dense kernel walks rows in tiles of ``DENSE_TILE``
and the paged one in tiles of the page size, through the same inner loop
and the same split of S across CTAs: with pages of ``DENSE_TILE`` rows
both give bit-identical outputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
MAX_GROUP = 8   # query heads per kv head the kernels hold (kMaxG)
MAX_TILE = 64   # rows per tile (kMaxT)
TARGET_CTAS = 4 * 132  # about four CTAs per SM of an H100
DENSE_TILE = 16  # rows per tile of the dense kernel = the engine's page size


def tiles_per_split(b: int, n_kv: int, n_tiles: int) -> int:
    """Tiles each CTA walks: S is split until about ``TARGET_CTAS`` CTAs
    run.  A function of the shapes only, and the same for the dense and
    the paged kernel (n_tiles = S / block_s = M), so both split alike."""
    n_tiles = max(n_tiles, 1)
    n_split = min(n_tiles, max(1, -(-TARGET_CTAS // (b * n_kv))))
    return -(-n_tiles // n_split)


def _scratch(b: int, n_kv: int, n_split: int, d: int, device):
    """Per-split partials the combine kernel merges: (acc, max, sum)."""
    return (torch.empty((b, n_kv, n_split, MAX_GROUP, d),
                        dtype=torch.float32, device=device),
            torch.empty((b, n_kv, n_split, MAX_GROUP, 2),
                        dtype=torch.float32, device=device))


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, cache_len: torch.Tensor,
                           *, window: Optional[int] = None) -> torch.Tensor:
    """q (B,1,H,D) against a padded (B,S,K,D) cache; rows
    ``pos < cache_len`` (and inside ``window``) are attended."""
    b, _, h, d = q.shape
    _, s, n_kv, _ = k_cache.shape
    qg = q.reshape(b, 1, n_kv, h // n_kv, d).float() * d ** -0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float())
    pos = torch.arange(s, device=q.device)
    cl = cache_len.long()
    valid = pos[None, :] < cl[:, None]
    if window is not None:
        valid &= pos[None, :] > cl[:, None] - 1 - window
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """(N, bs, K, D) pages + (B, M) table -> (B, M*bs, K, D) in logical
    order (the reference materialization)."""
    b, m = block_tables.shape
    g = pages[block_tables.long()]  # (B, M, bs, K, D)
    return g.reshape(b, m * pages.shape[1], *pages.shape[2:])


def paged_decode_attention_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 cache_len: torch.Tensor) -> torch.Tensor:
    """Gather the pages, then the dense plain decode.  Past-end table
    entries (the null block) are masked by ``cache_len``."""
    return decode_attention_plain(q, gather_pages(k_pages, block_tables),
                                  gather_pages(v_pages, block_tables),
                                  cache_len)


def _check_decode_shapes(name: str, q: torch.Tensor, kv: torch.Tensor,
                         tile: int) -> tuple[int, int, int]:
    b, one, h, d = q.shape
    n_kv, kd = kv.shape[2], kv.shape[3]
    if one != 1 or kd != d or h % n_kv or h // n_kv > MAX_GROUP:
        raise ValueError(f"{name}: bad shapes q{tuple(q.shape)} "
                         f"kv{tuple(kv.shape)}")
    if d not in (64, 128):
        raise ValueError(f"{name}: head dim {d} not in (64, 128)")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"{name}: tile of {tile} rows not in [1, "
                         f"{MAX_TILE}]")
    return b, h, d


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token GQA attention against a (B,S,K,D) cache; returns
    (B,1,H,D).  ``cache_len`` (B,) int32 may exceed S (a free continuous
    slot keeps advancing): the kernel clamps its row loop to S.  Rows are
    walked in tiles of ``DENSE_TILE``, the engine's page size, so dense
    and paged decode agree bit for bit."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    block_s = DENSE_TILE
    b, h, d = _check_decode_shapes("decode_attention", q, k_cache, block_s)
    _, s, n_kv, _ = k_cache.shape
    if (v_cache.shape != k_cache.shape or k_cache.shape[0] != b
            or tuple(cache_len.shape) != (b,)):
        raise ValueError("decode_attention: cache / cache_len shapes do "
                         "not match q")
    n_tiles = -(-s // block_s)
    per = tiles_per_split(b, n_kv, n_tiles)
    part_acc, part_ml = _scratch(b, n_kv, -(-n_tiles // per), d, q.device)
    o = torch.empty_like(q)
    bf16, f32 = torch.bfloat16, torch.float32
    ptrs = build.pointers(
        "decode_attention", q.device,
        {"q": (q, bf16), "k_cache": (k_cache, bf16),
         "v_cache": (v_cache, bf16), "cache_len": (cache_len, torch.int32),
         "part_acc": (part_acc, f32), "part_ml": (part_ml, f32),
         "o": (o, bf16)})
    with torch.cuda.device(q.device):
        err = build.library().repro_decode_attention_bf16(
            *ptrs, b, s, h, n_kv, d, block_s,
            -1 if window is None else int(window), per, d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           cache_len: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention against (N,bs,K,D) pages walked through
    a (B,M) int32 block table; returns (B,1,H,D).  Table entries must name
    blocks of the pool (entries outside [0, N) are skipped, never read)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages,
                                            block_tables, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    n, bs, n_kv, _ = k_pages.shape
    b, h, d = _check_decode_shapes("paged_decode_attention", q, k_pages, bs)
    if (v_pages.shape != k_pages.shape or block_tables.dim() != 2
            or block_tables.shape[0] != b
            or tuple(cache_len.shape) != (b,)):
        raise ValueError("paged_decode_attention: pages / tables / "
                         "cache_len shapes do not match q")
    m = block_tables.shape[1]
    per = tiles_per_split(b, n_kv, m)
    part_acc, part_ml = _scratch(b, n_kv, -(-m // per), d, q.device)
    o = torch.empty_like(q)
    bf16, i32, f32 = torch.bfloat16, torch.int32, torch.float32
    ptrs = build.pointers(
        "paged_decode_attention", q.device,
        {"q": (q, bf16), "k_pages": (k_pages, bf16),
         "v_pages": (v_pages, bf16), "block_tables": (block_tables, i32),
         "cache_len": (cache_len, i32), "part_acc": (part_acc, f32),
         "part_ml": (part_ml, f32), "o": (o, bf16)})
    with torch.cuda.device(q.device):
        err = build.library().repro_paged_decode_attention_bf16(
            *ptrs, b, n, bs, m, h, n_kv, d, per, d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return o


paged_decode_attention.launches = 0

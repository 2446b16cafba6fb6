"""Decode attention, dense and paged, over bf16 K/V or int8 codes with
bf16 scales: CUDA kernel wrappers, plain versions, launch counters.

Kernels: ``csrc/decode_attention.cu`` (replace
``repro/kernels/decode_attention.py::decode_attention_pallas``,
``::paged_decode_attention_pallas``, ``::decode_attention_quant_pallas``
and ``::paged_decode_attention_quant_pallas``; the source note there says
what bounds them and what their design does about it).  Plain versions:
the masked-softmax decode of ``repro/kernels/ops.py::decode_attention``
(xla path); for pages, the gather-then-dense path of
``ops.paged_decode_attention``; for int8, dequantize-to-bf16-then-decode
as ``ops.decode_attention_quant`` (ops.py:450-477).

Each wrapper takes its plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor, or raises; on a meta tensor it returns an
empty output and records the call (``kernels/meta.py``);
``<wrapper>.launches`` counts kernel launches.  All four kernels walk
tiles of ``DENSE_TILE`` logical rows, dense and paged alike and whatever
the page size, through one tensor-core tile loop and one split of S
across CTAs (``decode_plan``; the int8 kernels widen their codes to bf16
in shared memory first): on identical K/V, or codes and scales, with
``M * bs == S`` a dense and a paged kernel give bit-identical outputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, meta

NEG_INF = -1e30
MAX_GROUP = 16  # query heads per kv head the kernels hold (kMaxG)
MAX_TILE = 64   # rows per page of the paged kernels (kMaxT)
TARGET_CTAS = 4 * 132  # about four CTAs per SM of an H100
DENSE_TILE = 16  # rows per tile (kTile: one mma n16 step) = the engine's
#                  page size


def tiles_per_split(b: int, n_kv: int, n_tiles: int) -> int:
    """Tiles each CTA walks: S is split until about ``TARGET_CTAS`` CTAs
    run.  A function of the shapes only, and the same for the dense and
    the paged kernel (the same n_tiles), so both split alike."""
    n_tiles = max(n_tiles, 1)
    n_split = min(n_tiles, max(1, -(-TARGET_CTAS // (b * n_kv))))
    return -(-n_tiles // n_split)


def split_plan(b: int, n_kv: int, n_tiles: int) -> tuple[int, int]:
    """(tiles per CTA, number of splits) for ``n_tiles`` tiles of a
    sequence: the grid is (n_kv, b, n_split)."""
    per = tiles_per_split(b, n_kv, n_tiles)
    return per, -(-max(n_tiles, 1) // per)


def row_tiles(n_rows: int) -> int:
    """Tiles of ``DENSE_TILE`` logical rows the kernels walk over a
    sequence of ``n_rows`` rows (S dense, M * bs paged)."""
    return -(-n_rows // DENSE_TILE)


def decode_plan(kv: torch.Tensor,
                block_tables: Optional[torch.Tensor] = None,
                plan_kv: Optional[int] = None) -> tuple[int, int]:
    """``split_plan`` of a decode launch over a dense (B,S,K,D) cache or,
    given ``block_tables`` (B,M), over (N,bs,K,D) pages (bf16 or int8
    codes alike): tiles of the S or M * bs logical rows.  ``plan_kv``
    (default: the cache's K) is the kv-head count the split is planned
    for: each CTA walks one kv head and the combine merges a head's
    splits in split order, so two launches that plan alike give every
    head the same output bit for bit, whatever heads each holds."""
    if block_tables is None:
        b, s, n_kv = kv.shape[:3]
        return split_plan(b, plan_kv or n_kv, row_tiles(s))
    b, m = block_tables.shape
    bs, n_kv = kv.shape[1:3]
    return split_plan(b, plan_kv or n_kv, row_tiles(m * bs))


def scratch_shapes(b: int, n_kv: int, n_split: int, d: int
                   ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Shapes of the per-split partials the combine kernel merges: the
    unnormalised accumulator, and (max, sum), of every query head."""
    return ((b, n_kv, n_split, MAX_GROUP, d),
            (b, n_kv, n_split, MAX_GROUP, 2))


def _scratch(b: int, n_kv: int, n_split: int, d: int, device):
    return tuple(torch.empty(shape, dtype=torch.float32, device=device)
                 for shape in scratch_shapes(b, n_kv, n_split, d))


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
                         f"kv{tuple(kv.shape)} (at most {MAX_GROUP} query "
                         f"heads per kv head)")
    if d not in build.HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {build.HEAD_DIMS}")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"{name}: tile of {tile} rows not in [1, "
                         f"{MAX_TILE}]")
    return b, h, d


def _meta(name: str, q: torch.Tensor, operands: tuple, rows: int,
          window: Optional[int] = None) -> torch.Tensor:
    """A shape-only call on the meta device: the empty (B,1,H,D) output,
    the call recorded with the logical rows each sequence may attend."""
    o = torch.empty_like(q)
    meta.record(name, (q, *operands), (o,), rows=int(rows), window=window)
    return o


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: Optional[int] = None,
                     plan_kv: Optional[int] = None) -> torch.Tensor:
    """Single-token GQA attention against a (B,S,K,D) cache; returns
    (B,1,H,D).  ``plan_kv``: see ``decode_plan`` (a sharded pod's member
    passes the whole model's kv heads, so its heads' outputs are one
    device's).  ``cache_len`` (B,) int32 may exceed S (a free continuous
    slot keeps advancing): the kernel clamps its row loop to S.  Rows are
    walked in tiles of ``DENSE_TILE`` logical rows, as the paged kernel
    walks them, so dense and paged decode agree bit for bit.  The kernel
    rounds the softmax weights to bf16 for P . V (at most 2^-8 relative
    per weight)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, cache_len,
                                      window=window)
    if q.device.type == "meta":
        return _meta("decode_attention", q, (k_cache, v_cache, cache_len),
                     k_cache.shape[1], window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    block_s = DENSE_TILE
    b, h, d = _check_decode_shapes("decode_attention", q, k_cache, block_s)
    _, s, n_kv, _ = k_cache.shape
    if (v_cache.shape != k_cache.shape or k_cache.shape[0] != b
            or tuple(cache_len.shape) != (b,)):
        raise ValueError("decode_attention: cache / cache_len shapes do "
                         "not match q")
    per, n_split = decode_plan(k_cache, plan_kv=plan_kv)
    part_acc, part_ml = _scratch(b, n_kv, n_split, d, q.device)
    o = torch.empty_like(q)
    bf16, f32 = torch.bfloat16, torch.float32
    ptrs = build.pointers(
        "decode_attention", q.device,
        {"q": (q, bf16), "k_cache": (k_cache, bf16),
         "v_cache": (v_cache, bf16), "cache_len": (cache_len, torch.int32),
         "part_acc": (part_acc, f32), "part_ml": (part_ml, f32),
         "o": (o, bf16)}, align=16)
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
                           cache_len: torch.Tensor, *,
                           plan_kv: Optional[int] = None) -> torch.Tensor:
    """Single-token GQA attention against (N,bs,K,D) pages (bs of 1-64
    rows) walked through a (B,M) int32 block table; returns (B,1,H,D).
    Table entries must name blocks of the pool (rows on an entry outside
    [0, N) are masked, never read).  Bit-identical to ``decode_attention``
    on the same K/V gathered into a cache of S = M * bs rows."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pages, v_pages,
                                            block_tables, cache_len)
    if q.device.type == "meta":
        return _meta("paged_decode_attention", q,
                     (k_pages, v_pages, block_tables, cache_len),
                     block_tables.shape[1] * k_pages.shape[1])
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
    per, n_split = decode_plan(k_pages, block_tables, plan_kv)
    part_acc, part_ml = _scratch(b, n_kv, n_split, d, q.device)
    o = torch.empty_like(q)
    bf16, i32, f32 = torch.bfloat16, torch.int32, torch.float32
    ptrs = build.pointers(
        "paged_decode_attention", q.device,
        {"q": (q, bf16), "k_pages": (k_pages, bf16),
         "v_pages": (v_pages, bf16), "block_tables": (block_tables, i32),
         "cache_len": (cache_len, i32), "part_acc": (part_acc, f32),
         "part_ml": (part_ml, f32), "o": (o, bf16)}, align=16)
    with torch.cuda.device(q.device):
        err = build.library().repro_paged_decode_attention_bf16(
            *ptrs, b, n, bs, m, h, n_kv, d, per, d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return o


paged_decode_attention.launches = 0


# -- int8 KV ------------------------------------------------------------------


def _dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (codes.float() * scale.float()).to(torch.bfloat16)


def decode_attention_quant_plain(q: torch.Tensor, k_codes: torch.Tensor,
                                 v_codes: torch.Tensor, k_scale: torch.Tensor,
                                 v_scale: torch.Tensor,
                                 cache_len: torch.Tensor) -> torch.Tensor:
    """Dequantize to bf16, then the plain decode (ops.py:472-477).  The
    kernel widens its codes to the same bf16 rows, bf16(code * scale)
    computed in f32."""
    return decode_attention_plain(q, _dequantize(k_codes, k_scale),
                                  _dequantize(v_codes, v_scale), cache_len)


def paged_decode_attention_quant_plain(q: torch.Tensor,
                                       k_pages: torch.Tensor,
                                       v_pages: torch.Tensor,
                                       ks_pages: torch.Tensor,
                                       vs_pages: torch.Tensor,
                                       block_tables: torch.Tensor,
                                       cache_len: torch.Tensor
                                       ) -> torch.Tensor:
    """Gather codes and scales, then the dense int8 plain decode
    (ops.py:425-447)."""
    return decode_attention_quant_plain(
        q, gather_pages(k_pages, block_tables),
        gather_pages(v_pages, block_tables),
        gather_pages(ks_pages, block_tables),
        gather_pages(vs_pages, block_tables), cache_len)


def _check_scales(name: str, codes: torch.Tensor, *scales: torch.Tensor
                  ) -> None:
    want = (*codes.shape[:-1], 1)
    for sc in scales:
        if tuple(sc.shape) != want:
            raise ValueError(f"{name}: scales {tuple(sc.shape)} do not "
                             f"match codes {tuple(codes.shape)}")


def decode_attention_quant(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor,
                           cache_len: torch.Tensor, *,
                           plan_kv: Optional[int] = None) -> torch.Tensor:
    """``decode_attention`` over (B,S,K,D) int8 codes and (B,S,K,1) bf16
    scales; returns (B,1,H,D) bf16.  No window (the reference has none)."""
    if q.device.type == "cpu":
        return decode_attention_quant_plain(q, k_cache, v_cache, k_scale,
                                            v_scale, cache_len)
    if q.device.type == "meta":
        return _meta("decode_attention_quant", q,
                     (k_cache, v_cache, k_scale, v_scale, cache_len),
                     k_cache.shape[1])
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_quant: no kernel for "
                         f"{q.device}")
    name = "decode_attention_quant"
    block_s = DENSE_TILE
    b, h, d = _check_decode_shapes(name, q, k_cache, block_s)
    _, s, n_kv, _ = k_cache.shape
    if (v_cache.shape != k_cache.shape or k_cache.shape[0] != b
            or tuple(cache_len.shape) != (b,)):
        raise ValueError(f"{name}: cache / cache_len shapes do not match q")
    _check_scales(name, k_cache, k_scale, v_scale)
    per, n_split = decode_plan(k_cache, plan_kv=plan_kv)
    part_acc, part_ml = _scratch(b, n_kv, n_split, d, q.device)
    o = torch.empty_like(q)
    bf16, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    ptrs = build.pointers(
        name, q.device,
        {"q": (q, bf16), "k_cache": (k_cache, i8), "v_cache": (v_cache, i8),
         "k_scale": (k_scale, bf16, 2), "v_scale": (v_scale, bf16, 2),
         "cache_len": (cache_len, torch.int32), "part_acc": (part_acc, f32),
         "part_ml": (part_ml, f32), "o": (o, bf16)}, align=16)
    with torch.cuda.device(q.device):
        err = build.library().repro_decode_attention_q8(
            *ptrs, b, s, h, n_kv, d, block_s, per, d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    decode_attention_quant.launches += 1
    return o


decode_attention_quant.launches = 0


def paged_decode_attention_quant(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 ks_pages: torch.Tensor,
                                 vs_pages: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 cache_len: torch.Tensor, *,
                                 plan_kv: Optional[int] = None
                                 ) -> torch.Tensor:
    """``paged_decode_attention`` over (N,bs,K,D) int8 code pages and
    (N,bs,K,1) bf16 scale pages; returns (B,1,H,D) bf16."""
    if q.device.type == "cpu":
        return paged_decode_attention_quant_plain(
            q, k_pages, v_pages, ks_pages, vs_pages, block_tables, cache_len)
    if q.device.type == "meta":
        return _meta("paged_decode_attention_quant", q,
                     (k_pages, v_pages, ks_pages, vs_pages, block_tables,
                      cache_len), block_tables.shape[1] * k_pages.shape[1])
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_quant: no kernel for "
                         f"{q.device}")
    name = "paged_decode_attention_quant"
    n, bs, n_kv, _ = k_pages.shape
    b, h, d = _check_decode_shapes(name, q, k_pages, bs)
    if (v_pages.shape != k_pages.shape or block_tables.dim() != 2
            or block_tables.shape[0] != b
            or tuple(cache_len.shape) != (b,)):
        raise ValueError(f"{name}: pages / tables / cache_len shapes do not "
                         f"match q")
    _check_scales(name, k_pages, ks_pages, vs_pages)
    m = block_tables.shape[1]
    per, n_split = decode_plan(k_pages, block_tables, plan_kv)
    part_acc, part_ml = _scratch(b, n_kv, n_split, d, q.device)
    o = torch.empty_like(q)
    bf16, i8, i32, f32 = torch.bfloat16, torch.int8, torch.int32, \
        torch.float32
    ptrs = build.pointers(
        name, q.device,
        {"q": (q, bf16), "k_pages": (k_pages, i8), "v_pages": (v_pages, i8),
         "ks_pages": (ks_pages, bf16, 2), "vs_pages": (vs_pages, bf16, 2),
         "block_tables": (block_tables, i32), "cache_len": (cache_len, i32),
         "part_acc": (part_acc, f32), "part_ml": (part_ml, f32),
         "o": (o, bf16)}, align=16)
    with torch.cuda.device(q.device):
        err = build.library().repro_paged_decode_attention_q8(
            *ptrs, b, n, bs, m, h, n_kv, d, per, d ** -0.5,
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    paged_decode_attention_quant.launches += 1
    return o


paged_decode_attention_quant.launches = 0

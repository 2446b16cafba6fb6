// Single-token GQA decode attention: dense padded cache and block-paged
// cache, over bf16 K/V or int8 codes with per-(row, kv head) bf16 scales.
//
// Replaces repro/kernels/decode_attention.py::decode_attention_pallas
// (_kernel), ::paged_decode_attention_pallas (_paged_kernel),
// ::decode_attention_quant_pallas (_kernel_q8) and
// ::paged_decode_attention_quant_pallas (_paged_kernel_q8).
//
// Bound on the H100: bytes.  Each (sequence, kv head) streams its K and V
// rows once (2 * cache_len * D * 2 bytes in bf16, half that plus 4 bytes of
// scales per row in int8) for 2 * G * D flops per row, far below the ~295
// flop/byte ridge.  So the kernels must keep many bytes in flight and add
// little latency per row.  Shared by all four: a CTA per (kv head, b,
// split of S) holds all G query heads of its kv head, so every K/V row
// leaves HBM once for the whole group, and the split of S
// (flash-decoding) puts B * K * n_split CTAs in flight instead of B * K;
// a second kernel merges the splits' partial (acc, max, sum) in split
// order.  The dense kernels stop at min(cache_len, S) (a free continuous
// slot keeps advancing its position past S) and start at the window
// edge; the paged kernels read their own block-table row and only the
// sequence's own pages.
//
// All four kernels run one tile loop, decode_split.  The G heads (up to
// 16) are the rows of one mma.sync m16n8k16 A fragment (padded with zero
// rows to 16; the kernels are byte-bound, so the padded rows cost
// nothing), and each warp runs the shared tensor-core tile of
// attention_common.cuh on 16 K/V rows at a time: scores through ldmatrix,
// the online softmax on the C fragments (quad shuffles, no barrier per
// tile), P kept in registers for P . V through ldmatrix.trans.  Rows are
// walked in tiles of 16 logical rows whatever the page size: the CTA's
// tiles go round-robin to its 4 warps, each warp streams its own tiles
// through a private cp.async ring (16 bytes a lane; rows past the cache or
// on an out-of-pool page are zero-filled, noted by a ballot as the copies
// are issued, and masked) and keeps its own (m, l, acc), and the CTA
// merges its warps in warp order.  The merged partials go to the combine
// kernel, which forms the splits' weights once and sums with its loads in
// flight together.  A paged row's address comes from the block table row
// by row, so pages of 1-64 rows work and a page below 16 rows fills part
// of an mma tile.
//
// bf16 (decode_bf16_kernel, paged_decode_bf16_kernel): the ring holds the
// bf16 K/V tiles themselves, in 2 stages only when a warp has more than
// one tile to walk: with one, a second stage would only take shared memory
// from the SM's other CTAs.
//
// int8 (decode_q8_kernel, paged_decode_q8_kernel): the ring holds one tile
// of codes (8 copies a lane at D = 128); the rows' bf16 scales, strided by
// KV, come beside them by plain loads into registers.  Once its copies
// have landed, each lane widens the pieces it copied into the warp's bf16
// tile as bf16(code * scale), computed in f32: the dequantize of
// ops.decode_attention_quant and of the port's plain version, so the int8
// kernels differ from it only as the bf16 ones do.  Then the lane refills
// the same bytes with the next tile's codes, which are in flight while the
// widened tile is attended: since a lane reads back only what it copied,
// one stage suffices.  The codes wait in shared memory rather than in
// registers because a tile's codes are 8 int4 a lane at D = 128, 32
// registers the tile loop cannot spare.
//
// Built for D = 16, 32, 64 and 128.  At D = 16 each product is one k16
// step of the mma, and an int8 row is a single 16-byte piece, so a tile's
// codes are 16 pieces: lanes 0-15 copy and widen them, and lanes 16-31
// only take part in the ballot.
//
// Since tiles, their warps, the split and both merges depend on logical
// rows alone, a dense and a paged kernel give bit-identical outputs on
// identical K/V (or codes and scales) for every page size with M * bs = S.
// Scores are scaled in f32 after the dot; P is rounded to bf16 for P . V
// (at most 2^-8 relative per weight).
#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kMaxG = 16;  // query heads per kv head: the A fragment's rows
constexpr int kMaxT = 64;  // rows per page of the paged kernels
constexpr int kTile = 16;      // logical rows per tile: one mma n16 step
constexpr int kDecWarps = 4;   // warps per CTA, each with its own tiles
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecStages = 2;  // the deepest ring: one tile in flight ahead

// CTAs per SM asked of ptxas: left alone it holds the D = 32 paged bf16
// kernel to 64 registers and spills; asking for 3 (a 170-register cap)
// gives the small head dims the registers they need.  D = 64 and 128 ask
// for 0, which compiles as no bound at all (the same registers; 1 would
// not).
template <int D>
__host__ __device__ constexpr int dec_min_ctas() { return D <= 32 ? 3 : 0; }

// Merge the n_split partials of (b, kv head) in split order (a fixed
// order: the result does not depend on which CTA finished first).  One
// CTA per (kv head, b, query head): the splits' weights exp(m - m_all)
// are formed once in shared memory, then each thread sums its output
// dimension over the splits with the loads unrolled, so they are in
// flight together rather than one after another.
template <int D>
__global__ void __launch_bounds__(D) combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ o, int H, int KV, int n_split) {
  extern __shared__ float w_sm[];  // [n_split]: maxima, then weights
  const int kh = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, G = H / KV;
  const long base = ((long)b * KV + kh) * n_split;
  for (int sp = tid; sp < n_split; sp += D)
    w_sm[sp] = part_ml[((base + sp) * kMaxG + g) * 2];
  __syncthreads();
  float m_all = REPRO_NEG_INF;
  for (int sp = 0; sp < n_split; ++sp) m_all = fmaxf(m_all, w_sm[sp]);
  __syncthreads();  // every thread has read the maxima
  for (int sp = tid; sp < n_split; sp += D)
    w_sm[sp] = expf(w_sm[sp] - m_all);
  __syncthreads();
  float l_all = 0.f, acc = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < n_split; ++sp) {
    const long slot = (base + sp) * kMaxG + g;
    const float w = w_sm[sp];
    l_all += part_ml[slot * 2 + 1] * w;
    acc += part_acc[slot * D + tid] * w;
  }
  o[((long)b * H + kh * G + g) * D + tid] =
      __float2bfloat16(acc / fmaxf(l_all, 1e-30f));
}

// Row stride of the shared bf16 K/V tiles: D plus a 16-byte pad, so
// ldmatrix reads are free of bank conflicts.
template <int D>
__host__ __device__ constexpr int dec_ld() { return D + 8; }

// Bytes of one bf16 (K, V) tile pair as the tile loop reads it.
template <int D>
__host__ __device__ constexpr int dec_tile_bytes() {
  return 2 * kTile * dec_ld<D>() * (int)sizeof(__nv_bfloat16);
}

// Bytes of one stage of a warp's ring: a bf16 tile pair, or a pair of
// int8 code tiles (row stride D bytes).
template <int D, bool kQ8>
__host__ __device__ constexpr int dec_stage_bytes() {
  return kQ8 ? 2 * kTile * D : dec_tile_bytes<D>();
}

// One warp's shared memory: for int8 the bf16 tile pair its codes are
// widened into, then its ring.
template <int D, bool kQ8>
__host__ __device__ constexpr int dec_warp_bytes(int stages) {
  return (kQ8 ? dec_tile_bytes<D>() : 0) +
         stages * dec_stage_bytes<D, kQ8>();
}

// The CTA's shared memory: its warps' rings; after the loop the same
// bytes hold the warps' partials for the CTA's merge.
template <int D, bool kQ8>
int dec_smem_bytes(int stages) {
  const int rings = kDecWarps * dec_warp_bytes<D, kQ8>(stages);
  const int merge = kDecWarps * kMaxG * (D + 2) * (int)sizeof(float);
  return rings > merge ? rings : merge;
}

// The ring depth a split needs.  bf16: a warp with one tile has nothing
// to prefetch behind it, and a single stage leaves room for more CTAs per
// SM.  int8: one stage always, since each lane widens its own pieces of a
// tile before it refills the same bytes with the next tile's.
template <bool kQ8>
__host__ __device__ inline int dec_stages(int tiles_per_split) {
  return !kQ8 && tiles_per_split > kDecWarps ? kDecStages : 1;
}

// Logical rows of one (b, kv head) of a dense (B, S, KV, D) cache: live
// rows are [lo, hi), the window start to min(cache_len, S).  offset(r)
// is the row's element offset, or -1 for a row that is not stored.
struct DenseRows {
  long base;    // element offset of (b, row 0, kh)
  long stride;  // KV * D
  int S, lo, hi;
  __device__ __forceinline__ long offset(int r) const {
    return r < S ? base + r * stride : -1;
  }
};

// Logical rows of one (b, kv head) in (N, bs, KV, D) pages through its
// block-table row: live rows are [0, min(cache_len, M * bs)) on pages of
// the pool (an entry outside [0, N) is never read, its rows masked).
struct PagedRows {
  const int* table;
  int M, bs, N;
  long stride;  // KV * D
  long kh_off;  // kh * D
  int lo, hi;
  __device__ __forceinline__ long offset(int r) const {
    const int page = r / bs;
    if (page >= M) return -1;
    const int phys = table[page];
    if (phys < 0 || phys >= N) return -1;
    return ((long)phys * bs + r % bs) * stride + kh_off;
  }
};

// The cache a kernel reads: bf16 K/V rows ...
struct Bf16Cache {
  using T = __nv_bfloat16;
  static constexpr bool kQ8 = false;
  const T* k;
  const T* v;
};

// ... or int8 codes with one bf16 scale per (row, kv head), laid out as
// the codes with D = 1 (a row's scale index is its code offset / D).
struct Q8Cache {
  using T = int8_t;
  static constexpr bool kQ8 = true;
  const T* k;
  const T* v;
  const __nv_bfloat16* ks;
  const __nv_bfloat16* vs;
};

// The bf16 bits of a row's K scale (low half) and V scale (high half).
__device__ __forceinline__ unsigned scale_bits(const Q8Cache& c, long i) {
  const auto* ks = reinterpret_cast<const unsigned short*>(c.ks);
  const auto* vs = reinterpret_cast<const unsigned short*>(c.vs);
  return (unsigned)__ldg(ks + i) | ((unsigned)__ldg(vs + i) << 16);
}

// 16 int8 codes (a 16-byte piece in shared memory) to bf16(code * scale),
// computed in f32, stored as two 16-byte pieces.  A code c becomes a float
// without a conversion instruction: byte c + 128 under the exponent of
// 2^23 is the float 2^23 + c + 128, and subtracting 2^23 + 128 is exact.
__device__ __forceinline__ void widen_piece(const int8_t* src, float scale,
                                        __nv_bfloat16* dst) {
  const int4 w = *reinterpret_cast<const int4*>(src);
  const unsigned words[4] = {(unsigned)w.x, (unsigned)w.y, (unsigned)w.z,
                             (unsigned)w.w};
  unsigned out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned biased = words[i] ^ 0x80808080u;  // each byte c + 128
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = (__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + b)) -
              8388736.f) * scale;
    out[2 * i] = pack_bf16(f[0], f[1]);
    out[2 * i + 1] = pack_bf16(f[2], f[3]);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(out[0], out[1], out[2], out[3]);
  d[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

// One CTA's split: tiles [t_begin, t_end) of 16 logical rows, tile
// t_begin + w + 4 i to warp w; then the warps' partials merged in warp
// order and stored for combine_kernel (max in natural-log units).
template <int D, typename Cache, typename Rows>
__device__ __forceinline__ void decode_split(
    const __nv_bfloat16* __restrict__ q, const Cache& cache, const Rows& rows,
    int b, int kh, int H, int G, int t_begin, int t_end, int stages,
    float scale_log2, float* __restrict__ part_acc,
    float* __restrict__ part_ml, long slot) {
  using T = typename Cache::T;
  constexpr bool kQ8 = Cache::kQ8;
  constexpr int LD = dec_ld<D>();
  constexpr int NO = D / 8;
  constexpr int kElems = 16 / (int)sizeof(T);  // elements per 16-byte piece
  constexpr int kPieces = D / kElems;          // pieces per row
  // Lanes that copy: all 32, except where a tile is fewer than 32 pieces
  // (int8 at D = 16: one piece a row, 16 a tile), where lanes 16-31 idle.
  constexpr int kLanes = kTile * kPieces < 32 ? kTile * kPieces : 32;
  constexpr int kRowsPerIt = kLanes / kPieces;  // rows one copy step covers
  constexpr int kIts = kTile * kPieces / kLanes;  // copy steps per tile
  static_assert(kIts >= 1 && kIts * kRowsPerIt == kTile, "copy shape");
  constexpr int kStageLd = kQ8 ? D : LD;       // a stage's row stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  unsigned char* mine = smem_raw + warp * dec_warp_bytes<D, kQ8>(stages);
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(mine);  // int8
  unsigned char* ring = mine + (kQ8 ? dec_tile_bytes<D>() : 0);
  auto stage = [&](int i) {
    return reinterpret_cast<T*>(ring +
                                (i % stages) * dec_stage_bytes<D, kQ8>());
  };

  // Heads kh * G + gid and kh * G + gid + 8 are rows gid and gid + 8 of
  // the A fragment; the rows past G are zero.
  unsigned qa[D / 16][4];
  const __nv_bfloat16* q_row = q + ((long)b * H + kh * G + gid) * D + 2 * tig;
  const bool top = gid < G, bottom = gid + 8 < G;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = q_row + 16 * kk;
    qa[kk][0] = top ? *reinterpret_cast<const unsigned*>(p) : 0u;
    qa[kk][1] = bottom ? *reinterpret_cast<const unsigned*>(p + 8 * D) : 0u;
    qa[kk][2] = top ? *reinterpret_cast<const unsigned*>(p + 8) : 0u;
    qa[kk][3] = bottom ? *reinterpret_cast<const unsigned*>(p + 8 * D + 8)
                       : 0u;
  }

  // This warp's tiles, past those wholly before the window.
  int t0 = t_begin + warp;
  const int t_lo = rows.lo / kTile;
  if (t0 < t_lo) t0 += (t_lo - t0 + kDecWarps - 1) / kDecWarps * kDecWarps;
  const int n = t0 < t_end ? (t_end - t0 + kDecWarps - 1) / kDecWarps : 0;
  // int8: the bf16 bits of the scales of the lane's rows of the tile in
  // flight (K low, V high).
  unsigned sc[kIts] = {};
  // Copies tile i into its stage (int8: and its scales into sc); returns
  // the tile's stored rows as bits (a row not stored is zero-filled, and
  // masked below).
  auto issue = [&](int i) {
    const int base = (t0 + i * kDecWarps) * kTile;
    T* ks = stage(i);
    T* vs = ks + kTile * kStageLd;
    unsigned stored = 0u;
#pragma unroll
    for (int it = 0; it < kIts; ++it) {
      const int p = lane + kLanes * it;
      const int r = p / kPieces, c = (p % kPieces) * kElems;
      bool ok = false;
      if (lane < kLanes) {
        const long off = rows.offset(base + r);
        ok = off >= 0;
        cp_async16(ks + r * kStageLd + c, cache.k + (ok ? off : 0) + c, ok);
        cp_async16(vs + r * kStageLd + c, cache.v + (ok ? off : 0) + c, ok);
        if constexpr (kQ8) sc[it] = ok ? scale_bits(cache, off / D) : 0u;
      }
      const unsigned vote = __ballot_sync(0xffffffffu, ok);
#pragma unroll
      for (int j = 0; j < kRowsPerIt; ++j)
        stored |= ((vote >> (j * kPieces)) & 1u) << (it * kRowsPerIt + j);
    }
    return stored;
  };
  // int8: the lane widens the pieces it copied (so its own wait suffices).
  auto widen = [&](int i) {
    const int8_t* kc = reinterpret_cast<const int8_t*>(stage(i));
    const int8_t* vc = kc + kTile * D;
    if (lane >= kLanes) return;
#pragma unroll
    for (int it = 0; it < kIts; ++it) {
      const int p = lane + kLanes * it;
      const int r = p / kPieces, c = (p % kPieces) * kElems;
      widen_piece(kc + r * D + c, __uint_as_float(sc[it] << 16),
              wide + r * LD + c);
      widen_piece(vc + r * D + c, __uint_as_float(sc[it] & 0xffff0000u),
              wide + (kTile + r) * LD + c);
    }
  };

  float acc[NO][4] = {};
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
  unsigned stored = n > 0 ? issue(0) : 0u;
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    unsigned stored_next;
    if constexpr (kQ8) {
      // Tile i has landed (this lane's copies); the lane widens them and
      // refills the same bytes with tile i + 1, in flight while tile i is
      // attended.
      cp_async_wait<0>();
      widen(i);
      stored_next = i + 1 < n ? issue(i + 1) : 0u;
      cp_async_commit();
    } else {
      // With one stage a warp has one tile (dec_stages): nothing follows.
      stored_next = i + 1 < n ? issue(i + 1) : 0u;
      cp_async_commit();
      cp_async_wait<1>();  // tile i has landed (this lane's copies)
    }
    __syncwarp();  // every lane's copies (int8: widened pieces) are in
    const int base = (t0 + i * kDecWarps) * kTile;
    const __nv_bfloat16* kt =
        kQ8 ? wide : reinterpret_cast<const __nv_bfloat16*>(stage(i));
    float s[2][4];
    warp_scores<D, 2>(qa, kt, LD, s);
    warp_scale_mask<2>(s, scale_log2, [&](int, int c) {
      const int r = base + c;
      return ((stored >> c) & 1u) && r >= rows.lo && r < rows.hi;
    });
    warp_softmax<2, NO>(s, m, l, acc);
    warp_pv<D, 2>(s, kt + kTile * LD, LD, acc);
    __syncwarp();  // the stage (and the widened tile) is refilled later
    stored = stored_next;
  }
  cp_async_wait<0>();
  warp_row_sum(l);

  // Merge the warps (rows 0..G-1 of each: the heads) through shared
  // memory.
  __syncthreads();  // every warp is done with its ring
  float* acc_sm = reinterpret_cast<float*>(smem_raw);  // [warp][kMaxG][D]
  float* ml_sm = acc_sm + kDecWarps * kMaxG * D;       // [warp][kMaxG][2]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (gid + 8 * h >= G) continue;
    const int row = warp * kMaxG + gid + 8 * h;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc_sm[row * D + 8 * j + 2 * tig] = acc[j][2 * h];
      acc_sm[row * D + 8 * j + 2 * tig + 1] = acc[j][2 * h + 1];
    }
    if (tig == 0) {
      ml_sm[row * 2] = m[h];
      ml_sm[row * 2 + 1] = l[h];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += kDecThreads) {
    const int g = e / D, d = e % D;
    float m_all = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      m_all = fmaxf(m_all, ml_sm[(w * kMaxG + g) * 2]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      a += acc_sm[(w * kMaxG + g) * D + d] *
           exp2f(ml_sm[(w * kMaxG + g) * 2] - m_all);
    part_acc[(slot * kMaxG + g) * D + d] = a;
  }
  if ((int)threadIdx.x < G) {
    const int g = threadIdx.x;
    float m_all = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      m_all = fmaxf(m_all, ml_sm[(w * kMaxG + g) * 2]);
    float l_all = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      l_all += ml_sm[(w * kMaxG + g) * 2 + 1] *
               exp2f(ml_sm[(w * kMaxG + g) * 2] - m_all);
    part_ml[(slot * kMaxG + g) * 2] = m_all * REPRO_LN2;
    part_ml[(slot * kMaxG + g) * 2 + 1] = l_all;
  }
}

// CTA (kh, b, sp) of a dense (B, S, KV, D) cache.
template <int D, typename Cache>
__device__ __forceinline__ void dense_split(
    const __nv_bfloat16* __restrict__ q, const Cache& cache,
    const int* __restrict__ cache_len, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int S, int H, int KV, int window,
    int tiles_per_split, float scale_log2) {
  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int len = cache_len[b];
  const DenseRows rows{((long)b * S * KV + kh) * D, (long)KV * D, S,
                       window >= 0 ? max(0, len - window) : 0, min(len, S)};
  const int t_end =
      min((sp + 1) * tiles_per_split, (rows.hi + kTile - 1) / kTile);
  decode_split<D>(q, cache, rows, b, kh, H, H / KV, sp * tiles_per_split,
                  t_end, dec_stages<Cache::kQ8>(tiles_per_split), scale_log2,
                  part_acc, part_ml, ((long)b * KV + kh) * gridDim.z + sp);
}

// CTA (kh, b, sp) of (N, bs, KV, D) pages through a (B, M) block table.
template <int D, typename Cache>
__device__ __forceinline__ void paged_split(
    const __nv_bfloat16* __restrict__ q, const Cache& cache,
    const int* __restrict__ tables, const int* __restrict__ cache_len,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int N,
    int bs, int M, int H, int KV, int tiles_per_split, float scale_log2) {
  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int len = cache_len[b];
  const PagedRows rows{tables + (long)b * M, M, bs, N, (long)KV * D,
                       (long)kh * D, 0, min(len, M * bs)};
  const int t_end =
      min((sp + 1) * tiles_per_split, (rows.hi + kTile - 1) / kTile);
  decode_split<D>(q, cache, rows, b, kh, H, H / KV, sp * tiles_per_split,
                  t_end, dec_stages<Cache::kQ8>(tiles_per_split), scale_log2,
                  part_acc, part_ml, ((long)b * KV + kh) * gridDim.z + sp);
}

template <int D>
__global__ void __launch_bounds__(kDecThreads, dec_min_ctas<D>())
    decode_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ cache_len,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int S, int H,
    int KV, int window, int tiles_per_split, float scale_log2) {
  dense_split<D>(q, Bf16Cache{k, v}, cache_len, part_acc, part_ml, S, H, KV,
                 window, tiles_per_split, scale_log2);
}

template <int D>
__global__ void __launch_bounds__(kDecThreads, dec_min_ctas<D>())
    paged_decode_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ cache_len, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int N, int bs, int M, int H, int KV,
    int tiles_per_split, float scale_log2) {
  paged_split<D>(q, Bf16Cache{kp, vp}, tables, cache_len, part_acc, part_ml,
                 N, bs, M, H, KV, tiles_per_split, scale_log2);
}

template <int D>
__global__ void __launch_bounds__(kDecThreads, dec_min_ctas<D>())
    decode_q8_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
    const int8_t* __restrict__ v, const __nv_bfloat16* __restrict__ ks,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ cache_len,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int S, int H,
    int KV, int tiles_per_split, float scale_log2) {
  dense_split<D>(q, Q8Cache{k, v, ks, vs}, cache_len, part_acc, part_ml, S,
                 H, KV, -1, tiles_per_split, scale_log2);
}

template <int D>
__global__ void __launch_bounds__(kDecThreads, dec_min_ctas<D>())
    paged_decode_q8_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kp,
    const int8_t* __restrict__ vp, const __nv_bfloat16* __restrict__ ksp,
    const __nv_bfloat16* __restrict__ vsp, const int* __restrict__ tables,
    const int* __restrict__ cache_len, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int N, int bs, int M, int H, int KV,
    int tiles_per_split, float scale_log2) {
  paged_split<D>(q, Q8Cache{kp, vp, ksp, vsp}, tables, cache_len, part_acc,
                 part_ml, N, bs, M, H, KV, tiles_per_split, scale_log2);
}

// Launches one of the four kernels on its (KV, B, n_split) grid, n_split
// = ceil(n_tiles / tiles_per_split), with its ring sized to the plan, then
// the combine.
template <int D, bool kQ8, typename... Params, typename... Args>
int launch_split(void (*kernel)(Params...), int n_tiles, int B, int H,
                 int KV, int tiles_per_split, void* part_acc, void* part_ml,
                 void* o, cudaStream_t st, Args... args) {
  const int smem = dec_smem_bytes<D, kQ8>(dec_stages<kQ8>(tiles_per_split));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_split = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  kernel<<<dim3(KV, B, n_split), kDecThreads, smem, st>>>(args...);
  combine_kernel<D><<<dim3(KV, B, H / KV), D, n_split * sizeof(float), st>>>(
      (const float*)part_acc, (const float*)part_ml, (__nv_bfloat16*)o, H,
      KV, n_split);
  return (int)cudaGetLastError();
}

// Calls f with std::integral_constant<int, D> for a head dim the kernels
// are built for.
template <typename F>
int by_head_dim(int D, F&& f) {
  switch (D) {
    case 128: return f(std::integral_constant<int, 128>());
    case 64: return f(std::integral_constant<int, 64>());
    case 32: return f(std::integral_constant<int, 32>());
    case 16: return f(std::integral_constant<int, 16>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shapes every kernel takes: G = H / KV whole and at most kMaxG, a
// positive split.
bool bad_split(int H, int KV, int tiles_per_split) {
  return KV < 1 || H % KV || H / KV > kMaxG || tiles_per_split < 1;
}

using bf16_t = __nv_bfloat16;

}  // namespace

// Every entry point: part_acc (B, KV, n_split, 16, D) f32 and part_ml
// (B, KV, n_split, 16, 2) f32 scratch, allocated by the caller; n_split =
// ceil(n_tiles / tiles_per_split) with n_tiles = ceil(rows / 16), rows = S
// dense and M * bs paged (pages of 1-64 rows).  q (B, H, D) bf16, H / KV
// up to 16; o (B, H, D) bf16.

// bf16 cache k, v (B, S, KV, D); `block` must be 16.
extern "C" int repro_decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* part_acc, void* part_ml, void* o, int B, int S, int H, int KV,
    int D, int block, int window, int tiles_per_split, float scale,
    void* stream) {
  if (bad_split(H, KV, tiles_per_split) || block != kTile)
    return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return launch_split<kD, false>(
        decode_bf16_kernel<kD>, (S + kTile - 1) / kTile, B, H, KV,
        tiles_per_split, part_acc, part_ml, o, (cudaStream_t)stream,
        (const bf16_t*)q, (const bf16_t*)k, (const bf16_t*)v,
        (const int*)cache_len, (float*)part_acc, (float*)part_ml, S, H, KV,
        window, tiles_per_split, scale * REPRO_LOG2E);
  });
}

// int8 codes k, v (B, S, KV, D) with bf16 scales ks, vs (B, S, KV, 1);
// `block` must be 16.  No window (the reference has none).
extern "C" int repro_decode_attention_q8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* cache_len, void* part_acc, void* part_ml,
    void* o, int B, int S, int H, int KV, int D, int block,
    int tiles_per_split, float scale, void* stream) {
  if (bad_split(H, KV, tiles_per_split) || block != kTile)
    return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return launch_split<kD, true>(
        decode_q8_kernel<kD>, (S + kTile - 1) / kTile, B, H, KV,
        tiles_per_split, part_acc, part_ml, o, (cudaStream_t)stream,
        (const bf16_t*)q, (const int8_t*)k, (const int8_t*)v,
        (const bf16_t*)ks, (const bf16_t*)vs, (const int*)cache_len,
        (float*)part_acc, (float*)part_ml, S, H, KV, tiles_per_split,
        scale * REPRO_LOG2E);
  });
}

// bf16 pages (N, bs, KV, D) through int32 tables (B, M).
extern "C" int repro_paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* cache_len, void* part_acc,
    void* part_ml, void* o, int B, int N, int bs, int M, int H, int KV,
    int D, int tiles_per_split, float scale, void* stream) {
  if (bad_split(H, KV, tiles_per_split) || bs < 1 || bs > kMaxT)
    return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return launch_split<kD, false>(
        paged_decode_bf16_kernel<kD>, (M * bs + kTile - 1) / kTile, B, H,
        KV, tiles_per_split, part_acc, part_ml, o, (cudaStream_t)stream,
        (const bf16_t*)q, (const bf16_t*)k_pages, (const bf16_t*)v_pages,
        (const int*)tables, (const int*)cache_len, (float*)part_acc,
        (float*)part_ml, N, bs, M, H, KV, tiles_per_split,
        scale * REPRO_LOG2E);
  });
}

// int8 code pages (N, bs, KV, D) with bf16 scale pages (N, bs, KV, 1)
// through int32 tables (B, M).
extern "C" int repro_paged_decode_attention_q8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* ks_pages, const void* vs_pages, const void* tables,
    const void* cache_len, void* part_acc, void* part_ml, void* o, int B,
    int N, int bs, int M, int H, int KV, int D, int tiles_per_split,
    float scale, void* stream) {
  if (bad_split(H, KV, tiles_per_split) || bs < 1 || bs > kMaxT)
    return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return launch_split<kD, true>(
        paged_decode_q8_kernel<kD>, (M * bs + kTile - 1) / kTile, B, H, KV,
        tiles_per_split, part_acc, part_ml, o, (cudaStream_t)stream,
        (const bf16_t*)q, (const int8_t*)k_pages, (const int8_t*)v_pages,
        (const bf16_t*)ks_pages, (const bf16_t*)vs_pages,
        (const int*)tables, (const int*)cache_len, (float*)part_acc,
        (float*)part_ml, N, bs, M, H, KV, tiles_per_split,
        scale * REPRO_LOG2E);
  });
}

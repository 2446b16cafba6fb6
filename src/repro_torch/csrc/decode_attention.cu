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
// bf16 (decode_bf16_kernel, paged_decode_bf16_kernel): the G heads are
// the rows of one mma.sync m16n8k16 A fragment (padded with zero rows to
// 16; the kernel is byte-bound, so the padded half costs nothing), and
// each warp runs the shared tensor-core tile of attention_common.cuh on
// 16 K/V rows at a time: scores through ldmatrix, the online softmax on
// the C fragments (no per-row warp_sum, no serial softmax, no barrier per
// tile), P kept in registers for P . V through ldmatrix.trans.  Rows are
// walked in tiles of 16 logical rows whatever the page size: the CTA's
// tiles go round-robin to its 4 warps, each warp streams its own tiles
// through a private cp.async ring (16 bytes a lane; rows past the cache
// or on an out-of-pool page are zero-filled, noted by a ballot as the
// copies are issued, and masked) and keeps its own (m, l, acc), and the
// CTA merges its warps in warp order.  The ring has 2 stages only when a
// warp has more than one tile to walk: with one, 70 KB of shared memory
// would hold three CTAs per SM and qwen2-7b's 512-CTA decode would run in
// two waves; with 35 KB it runs in one.  The merged partials go to the
// combine kernel, which forms the splits' weights once and sums with its
// loads in flight together.  A paged row's address comes from the block
// table row by row, so pages of 1-64 rows work and a page below 16 rows
// fills part of an mma tile.  Since
// tiles, their warps, the split and both merges depend on logical rows
// alone, the dense and the paged kernel give bit-identical outputs on
// identical K/V for every page size with M * bs = S.  Scores are scaled
// in f32 after the dot; P is rounded to bf16 for P . V (at most 2^-8
// relative per weight).
//
// int8 (decode_kernel, paged_decode_kernel with T = int8_t): tiles of
// `block` rows (16 dense, the page size paged) are staged first: each
// thread loads 16 codes (16 bytes) of K and of V, widens them to f32 in
// registers, multiplies by the row's scale and stores them in shared
// memory (the dequantize happens after the load, in f32, as in
// _kernel_q8); attend_tile then walks the rows on the CUDA cores, one
// output dimension per thread.  Both int8 kernels call attend_tile on the
// same tiles, split the same tile indices and merge in the same order, so
// they too are bit-identical on identical codes and scales.  Not yet
// done for int8: tensor cores and cp.async prefetch.
#include <cstdint>

#include "attention_common.cuh"

namespace {

constexpr int kMaxG = 8;    // query heads per kv head held by one CTA
constexpr int kMaxT = 64;   // attend_tile's score rows; the largest page
constexpr int kMaxTQ8 = 32; // rows per int8 tile (staged as f32 in smem)

// int8 tiles as attend_tile reads them: the f32 rows a tile was
// dequantized into in shared memory.
struct SmemRows {
  const float* k;
  const float* v;
  int stride;
  __device__ __forceinline__ float key(int r, int i) const {
    return k[r * stride + i];
  }
  __device__ __forceinline__ float val(int r, int i) const {
    return v[r * stride + i];
  }
};

// One tile of rows: scores, online-softmax update, and the P.V update.
// Thread `tid` owns output dimension tid of every query head (acc[g]);
// threads 0..G-1 own the running max/sum of head tid.  Rows outside
// [lo, hi) (tile-relative) are masked.
template <int D, typename Rows>
__device__ __forceinline__ void attend_tile(
    const Rows& rows, int n_rows, int lo, int hi, int G,
    const float (&qreg)[kMaxG][D / 32], float (&acc)[kMaxG], float& m,
    float& l, float* s_sm, float* alpha_sm) {
  constexpr int kWarps = D / 32;
  constexpr int kPerLane = D / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // 1. scores: warp w takes rows w, w + kWarps, ...; each lane kPerLane dims.
  for (int r = warp; r < n_rows; r += kWarps) {
    float kf[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      kf[j] = rows.key(r, lane * kPerLane + j);
    const bool valid = r >= lo && r < hi;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) part += qreg[g][j] * kf[j];
        part = warp_sum(part);
        if (lane == 0) s_sm[g * kMaxT + r] = valid ? part : REPRO_NEG_INF;
      }
    }
  }
  __syncthreads();
  // 2. online softmax of head tid over the tile's rows (probabilities
  //    overwrite the scores in place).
  if (tid < G) {
    float* s = s_sm + tid * kMaxT;
    float mx = m;
    for (int r = 0; r < n_rows; ++r) mx = fmaxf(mx, s[r]);
    const float alpha = expf(m - mx);
    float sum = 0.f;
    for (int r = 0; r < n_rows; ++r) {
      const float p = expf(s[r] - mx);
      s[r] = p;
      sum += p;
    }
    l = l * alpha + sum;
    m = mx;
    alpha_sm[tid] = alpha;
  }
  __syncthreads();
  // 3. acc = acc * alpha + P . V for dimension tid.
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G) acc[g] *= alpha_sm[g];
  for (int r = 0; r < n_rows; ++r) {
    const float vv = rows.val(r, tid);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) acc[g] += s_sm[g * kMaxT + r] * vv;
  }
  __syncthreads();  // s_sm is rewritten by the next tile
}

// 16 int8 codes (one 16-byte load) widened to f32 and scaled.
__device__ __forceinline__ void widen16(const int4 w, float scale,
                                        float* __restrict__ dst) {
  const int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      dst[4 * i + b] = (float)(signed char)(words[i] >> (8 * b)) * scale;
}

// One tile of int8 rows: every thread stages 16-code chunks of K and V
// (scaled to f32) in shared memory, then the tile is attended from there.
// attend_tile's closing barrier keeps the next tile's staging from
// overwriting rows still being read.
template <int D>
__device__ __forceinline__ void load_attend(
    const int8_t* __restrict__ k_rows, const int8_t* __restrict__ v_rows,
    const __nv_bfloat16* __restrict__ ks_rows,
    const __nv_bfloat16* __restrict__ vs_rows, long row_stride,
    long scale_stride, int n_rows, int lo, int hi, int G,
    const float (&qreg)[kMaxG][D / 32], float (&acc)[kMaxG], float& m,
    float& l, float* s_sm, float* alpha_sm) {
  __shared__ __align__(16) float k_sm[kMaxTQ8 * D];
  __shared__ __align__(16) float v_sm[kMaxTQ8 * D];
  constexpr int kChunks = D / 16;
  for (int c = threadIdx.x; c < n_rows * kChunks; c += D) {
    const int r = c / kChunks, off = (c % kChunks) * 16;
    const int4 kw = *reinterpret_cast<const int4*>(k_rows + r * row_stride +
                                                   off);
    const int4 vw = *reinterpret_cast<const int4*>(v_rows + r * row_stride +
                                                   off);
    widen16(kw, bf2f(ks_rows[r * scale_stride]), k_sm + r * D + off);
    widen16(vw, bf2f(vs_rows[r * scale_stride]), v_sm + r * D + off);
  }
  __syncthreads();
  attend_tile<D>(SmemRows{k_sm, v_sm, D}, n_rows, lo, hi, G, qreg, acc, m,
                 l, s_sm, alpha_sm);
}

template <int D>
__device__ __forceinline__ void load_q(const __nv_bfloat16* __restrict__ q,
                                       int b, int kh, int H, int G,
                                       float scale,
                                       float (&qreg)[kMaxG][D / 32]) {
  constexpr int kPerLane = D / 32;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      qreg[g][j] = g < G ? bf2f(q[((long)b * H + kh * G + g) * D +
                                  lane * kPerLane + j]) * scale
                         : 0.f;
    }
  }
}

// Partial result of one split: the unnormalised accumulator, running max
// and running sum of every query head, for combine_kernel.
template <int D>
__device__ __forceinline__ void store_partial(
    float* __restrict__ part_acc, float* __restrict__ part_ml, long slot,
    int G, const float (&acc)[kMaxG], float m, float l) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
    if (g < G) part_acc[(slot * kMaxG + g) * D + tid] = acc[g];
  if (tid < G) {
    part_ml[(slot * kMaxG + tid) * 2] = m;
    part_ml[(slot * kMaxG + tid) * 2 + 1] = l;
  }
}

// Split S (flash-decoding): CTA (kh, b, sp) walks tiles
// [sp * tiles_per_split, (sp + 1) * tiles_per_split) of its sequence, so
// B * K * n_split CTAs stream the cache instead of B * K.  The dense and
// the paged kernel split the same tile indices, so they stay bit-identical.
// T is the cache element: __nv_bfloat16, or int8_t codes with the scales
// ks / vs (laid out as the codes with D = 1; unused for bf16).
template <int D, typename T>
__global__ void __launch_bounds__(D) decode_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const __nv_bfloat16* __restrict__ ks,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ cache_len,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int S, int H,
    int KV, int block, int window, int tiles_per_split, float scale) {
  __shared__ float s_sm[kMaxG * kMaxT];
  __shared__ float alpha_sm[kMaxG];
  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int G = H / KV;
  float qreg[kMaxG][D / 32];
  load_q<D>(q, b, kh, H, G, scale, qreg);
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  float m = REPRO_NEG_INF, l = 0.f;
  const int len = cache_len[b];
  const int hi = min(len, S);  // never read past the cache's S rows
  const int lo = window >= 0 ? max(0, len - window) : 0;
  const long row_stride = (long)KV * D;
  const long row0 = (long)b * S * KV + kh;  // (b, row 0, kh) in rows of D
  const int t_end = (sp + 1) * tiles_per_split;
  for (int t = max(sp * tiles_per_split, lo / block);
       t < t_end && t * block < hi; ++t) {
    const int base = t * block;
    const long r = row0 + (long)base * KV;
    load_attend<D>(k + r * D, v + r * D, ks + r, vs + r, row_stride, KV,
                   min(block, S - base), lo - base, hi - base, G, qreg, acc,
                   m, l, s_sm, alpha_sm);
  }
  store_partial<D>(part_acc, part_ml, ((long)b * KV + kh) * gridDim.z + sp,
                   G, acc, m, l);
}

template <int D, typename T>
__global__ void __launch_bounds__(D) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const __nv_bfloat16* __restrict__ ksp,
    const __nv_bfloat16* __restrict__ vsp, const int* __restrict__ tables,
    const int* __restrict__ cache_len, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int N, int bs, int M, int H, int KV,
    int tiles_per_split, float scale) {
  __shared__ float s_sm[kMaxG * kMaxT];
  __shared__ float alpha_sm[kMaxG];
  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int G = H / KV;
  float qreg[kMaxG][D / 32];
  load_q<D>(q, b, kh, H, G, scale, qreg);
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  float m = REPRO_NEG_INF, l = 0.f;
  const int len = cache_len[b];
  const int n_tiles = min((len + bs - 1) / bs, M);
  const long row_stride = (long)KV * D;
  const int t_end = min((sp + 1) * tiles_per_split, n_tiles);
  for (int t = sp * tiles_per_split; t < t_end; ++t) {
    const int phys = tables[(long)b * M + t];
    if (phys < 0 || phys >= N) continue;  // out-of-pool entry: never read
    const long r = (long)phys * bs * KV + kh;  // (phys, row 0, kh)
    const int base = t * bs;
    load_attend<D>(kp + r * D, vp + r * D, ksp + r, vsp + r, row_stride, KV,
                   bs, 0, len - base, G, qreg, acc, m, l, s_sm, alpha_sm);
  }
  store_partial<D>(part_acc, part_ml, ((long)b * KV + kh) * gridDim.z + sp,
                   G, acc, m, l);
}

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

template <int D>
void combine(const float* part_acc, const float* part_ml, void* o, int B,
             int H, int KV, int n_split, cudaStream_t st) {
  combine_kernel<D><<<dim3(KV, B, H / KV), D, n_split * sizeof(float),
                      st>>>(part_acc, part_ml, (__nv_bfloat16*)o, H, KV,
                            n_split);
}

// -- bf16: the G heads as the rows of a tensor-core tile ---------------------

constexpr int kTile = 16;      // logical rows per tile: one mma n16 step
constexpr int kDecWarps = 4;   // warps per CTA, each with its own tiles
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecStages = 2;  // the deepest ring: one tile in flight ahead

// Row stride of the shared K/V tiles: D plus a 16-byte pad, so ldmatrix
// reads are free of bank conflicts.
template <int D>
__host__ __device__ constexpr int dec_ld() { return D + 8; }

// Each warp's ring of `stages` (K, V) tiles; after the loop the same
// bytes hold the warps' partials for the CTA's merge.
template <int D>
int dec_smem_bytes(int stages) {
  const int ring = kDecWarps * stages * 2 * kTile * dec_ld<D>() *
                   (int)sizeof(__nv_bfloat16);
  const int merge = kDecWarps * kMaxG * (D + 2) * (int)sizeof(float);
  return ring > merge ? ring : merge;
}

// The ring depth a split needs: a warp with one tile has nothing to
// prefetch behind it, and a single stage leaves room for twice the CTAs
// per SM.
__host__ __device__ inline int dec_stages(int tiles_per_split) {
  return tiles_per_split > kDecWarps ? kDecStages : 1;
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

// One CTA's split: tiles [t_begin, t_end) of 16 logical rows, tile
// t_begin + w + 4 i to warp w; then the warps' partials merged in warp
// order and stored for combine_kernel (max in natural-log units, as the
// int8 kernels store it).
template <int D, typename Rows>
__device__ __forceinline__ void decode_split(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const Rows& rows, int b, int kh,
    int H, int G, int t_begin, int t_end, int stages, float scale_log2,
    float* __restrict__ part_acc, float* __restrict__ part_ml, long slot) {
  constexpr int LD = dec_ld<D>();
  constexpr int NO = D / 8;
  constexpr int kPieces = D / 8;            // 16-byte pieces per row
  constexpr int kRowsPerIt = 32 / kPieces;  // rows one copy step covers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw) +
                        warp * stages * 2 * kTile * LD;
  auto stage = [&](int i) { return ring + (i % stages) * 2 * kTile * LD; };

  // Head kh * G + gid is row gid of the A fragment; rows 8..15 and the
  // rows past G are zero.
  unsigned qa[D / 16][4];
  const __nv_bfloat16* q_row = q + ((long)b * H + kh * G + gid) * D + 2 * tig;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = gid < G ? *reinterpret_cast<const unsigned*>(q_row + 16 * kk)
                        : 0u;
    qa[kk][2] = gid < G ? *reinterpret_cast<const unsigned*>(
                              q_row + 16 * kk + 8)
                        : 0u;
    qa[kk][1] = qa[kk][3] = 0u;
  }

  // This warp's tiles, past those wholly before the window.
  int t0 = t_begin + warp;
  const int t_lo = rows.lo / kTile;
  if (t0 < t_lo) t0 += (t_lo - t0 + kDecWarps - 1) / kDecWarps * kDecWarps;
  const int n = t0 < t_end ? (t_end - t0 + kDecWarps - 1) / kDecWarps : 0;
  // Copies tile i into its stage; returns the tile's stored rows as bits
  // (a row not stored is zero-filled, and masked below).
  auto issue = [&](int i) {
    const int base = (t0 + i * kDecWarps) * kTile;
    __nv_bfloat16* ks = stage(i);
    __nv_bfloat16* vs = ks + kTile * LD;
    unsigned stored = 0u;
#pragma unroll
    for (int it = 0; it < kTile * kPieces / 32; ++it) {
      const int p = lane + 32 * it;
      const int r = p / kPieces, c = (p % kPieces) * 8;
      const long off = rows.offset(base + r);
      const bool ok = off >= 0;
      cp_async16(ks + r * LD + c, k + (ok ? off : 0) + c, ok);
      cp_async16(vs + r * LD + c, v + (ok ? off : 0) + c, ok);
      const unsigned vote = __ballot_sync(0xffffffffu, ok);
#pragma unroll
      for (int j = 0; j < kRowsPerIt; ++j)
        stored |= ((vote >> (j * kPieces)) & 1u) << (it * kRowsPerIt + j);
    }
    return stored;
  };

  float acc[NO][4] = {};
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
  unsigned stored = n > 0 ? issue(0) : 0u;
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    // With one stage a warp has one tile (dec_stages): nothing follows.
    const unsigned stored_next = i + 1 < n ? issue(i + 1) : 0u;
    cp_async_commit();
    cp_async_wait<1>();  // tile i has landed (this lane's copies) ...
    __syncwarp();        // ... and every lane's
    const int base = (t0 + i * kDecWarps) * kTile;
    const __nv_bfloat16* ks = stage(i);
    float s[2][4];
    warp_scores<D, 2>(qa, ks, LD, s);
    warp_scale_mask<2>(s, scale_log2, [&](int, int c) {
      const int r = base + c;
      return ((stored >> c) & 1u) && r >= rows.lo && r < rows.hi;
    });
    warp_softmax<2, NO>(s, m, l, acc);
    warp_pv<D, 2>(s, ks + kTile * LD, LD, acc);
    __syncwarp();  // the stage is refilled `stages` tiles on
    stored = stored_next;
  }
  cp_async_wait<0>();
  warp_row_sum(l);

  // Merge the warps (rows 0..7 of each: the heads) through shared memory.
  __syncthreads();  // every warp is done with its ring
  float* acc_sm = reinterpret_cast<float*>(smem_raw);  // [warp][kMaxG][D]
  float* ml_sm = acc_sm + kDecWarps * kMaxG * D;       // [warp][kMaxG][2]
  const int row = warp * kMaxG + gid;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    acc_sm[row * D + 8 * j + 2 * tig] = acc[j][0];
    acc_sm[row * D + 8 * j + 2 * tig + 1] = acc[j][1];
  }
  if (tig == 0) {
    ml_sm[row * 2] = m[0];
    ml_sm[row * 2 + 1] = l[0];
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

template <int D>
__global__ void __launch_bounds__(kDecThreads) decode_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ cache_len,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int S, int H,
    int KV, int window, int tiles_per_split, float scale_log2) {
  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int len = cache_len[b];
  const DenseRows rows{((long)b * S * KV + kh) * D, (long)KV * D, S,
                       window >= 0 ? max(0, len - window) : 0, min(len, S)};
  const int t_end =
      min((sp + 1) * tiles_per_split, (rows.hi + kTile - 1) / kTile);
  decode_split<D>(q, k, v, rows, b, kh, H, H / KV, sp * tiles_per_split,
                  t_end, dec_stages(tiles_per_split), scale_log2, part_acc,
                  part_ml, ((long)b * KV + kh) * gridDim.z + sp);
}

template <int D>
__global__ void __launch_bounds__(kDecThreads) paged_decode_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ tables,
    const int* __restrict__ cache_len, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int N, int bs, int M, int H, int KV,
    int tiles_per_split, float scale_log2) {
  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int len = cache_len[b];
  const PagedRows rows{tables + (long)b * M, M, bs, N, (long)KV * D,
                       (long)kh * D, 0, min(len, M * bs)};
  const int t_end =
      min((sp + 1) * tiles_per_split, (rows.hi + kTile - 1) / kTile);
  decode_split<D>(q, kp, vp, rows, b, kh, H, H / KV, sp * tiles_per_split,
                  t_end, dec_stages(tiles_per_split), scale_log2, part_acc,
                  part_ml, ((long)b * KV + kh) * gridDim.z + sp);
}

// The bf16 kernels' launches: n_tiles = ceil(rows / 16) tiles of logical
// rows (rows = S dense, M * bs paged) split tiles_per_split to a CTA.
template <int D>
int launch_decode_bf16(const void* q, const void* k, const void* v,
                       const void* cache_len, void* part_acc, void* part_ml,
                       void* o, int B, int S, int H, int KV, int window,
                       int tiles_per_split, float scale, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dec_smem_bytes<D>(kDecStages));
  if (err != cudaSuccess) return (int)err;
  const int smem = dec_smem_bytes<D>(dec_stages(tiles_per_split));
  const int n_split =
      ((S + kTile - 1) / kTile + tiles_per_split - 1) / tiles_per_split;
  decode_bf16_kernel<D><<<dim3(KV, B, n_split), kDecThreads, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)cache_len, (float*)part_acc,
      (float*)part_ml, S, H, KV, window, tiles_per_split,
      scale * REPRO_LOG2E);
  combine<D>((const float*)part_acc, (const float*)part_ml, o, B, H, KV,
             n_split, st);
  return (int)cudaGetLastError();
}

template <int D>
int launch_paged_bf16(const void* q, const void* k_pages,
                      const void* v_pages, const void* tables,
                      const void* cache_len, void* part_acc, void* part_ml,
                      void* o, int B, int N, int bs, int M, int H, int KV,
                      int tiles_per_split, float scale, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      dec_smem_bytes<D>(kDecStages));
  if (err != cudaSuccess) return (int)err;
  const int smem = dec_smem_bytes<D>(dec_stages(tiles_per_split));
  const int n_split =
      ((M * bs + kTile - 1) / kTile + tiles_per_split - 1) / tiles_per_split;
  paged_decode_bf16_kernel<D><<<dim3(KV, B, n_split), kDecThreads, smem,
                                 st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pages,
      (const __nv_bfloat16*)v_pages, (const int*)tables,
      (const int*)cache_len, (float*)part_acc, (float*)part_ml, N, bs, M, H,
      KV, tiles_per_split, scale * REPRO_LOG2E);
  combine<D>((const float*)part_acc, (const float*)part_ml, o, B, H, KV,
             n_split, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, const void* cache_len,
                  void* part_acc, void* part_ml, void* o, int B, int S,
                  int H, int KV, int D, int block, int window,
                  int tiles_per_split, float scale, int max_block,
                  cudaStream_t st) {
  if (H % KV || H / KV > kMaxG || block < 1 || block > max_block ||
      tiles_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const int n_split = ((S + block - 1) / block + tiles_per_split - 1) /
                      tiles_per_split;
  const dim3 grid(KV, B, n_split);
  const auto* qq = (const __nv_bfloat16*)q;
  const auto* kk = (const T*)k;
  const auto* vv = (const T*)v;
  const auto* kss = (const __nv_bfloat16*)ks;
  const auto* vss = (const __nv_bfloat16*)vs;
  const auto* ll = (const int*)cache_len;
  auto* pa = (float*)part_acc;
  auto* pm = (float*)part_ml;
  if (D == 128) {
    decode_kernel<128, T><<<grid, 128, 0, st>>>(
        qq, kk, vv, kss, vss, ll, pa, pm, S, H, KV, block, window,
        tiles_per_split, scale);
    combine<128>(pa, pm, o, B, H, KV, n_split, st);
  } else if (D == 64) {
    decode_kernel<64, T><<<grid, 64, 0, st>>>(
        qq, kk, vv, kss, vss, ll, pa, pm, S, H, KV, block, window,
        tiles_per_split, scale);
    combine<64>(pa, pm, o, B, H, KV, n_split, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_paged(const void* q, const void* k_pages, const void* v_pages,
                 const void* ks_pages, const void* vs_pages,
                 const void* tables, const void* cache_len, void* part_acc,
                 void* part_ml, void* o, int B, int N, int bs, int M, int H,
                 int KV, int D, int tiles_per_split, float scale,
                 int max_block, cudaStream_t st) {
  if (H % KV || H / KV > kMaxG || bs < 1 || bs > max_block ||
      tiles_per_split < 1)
    return (int)cudaErrorInvalidValue;
  const int n_split = (M + tiles_per_split - 1) / tiles_per_split;
  const dim3 grid(KV, B, n_split);
  const auto* qq = (const __nv_bfloat16*)q;
  const auto* kk = (const T*)k_pages;
  const auto* vv = (const T*)v_pages;
  const auto* kss = (const __nv_bfloat16*)ks_pages;
  const auto* vss = (const __nv_bfloat16*)vs_pages;
  const auto* tt = (const int*)tables;
  const auto* ll = (const int*)cache_len;
  auto* pa = (float*)part_acc;
  auto* pm = (float*)part_ml;
  if (D == 128) {
    paged_decode_kernel<128, T><<<grid, 128, 0, st>>>(
        qq, kk, vv, kss, vss, tt, ll, pa, pm, N, bs, M, H, KV,
        tiles_per_split, scale);
    combine<128>(pa, pm, o, B, H, KV, n_split, st);
  } else if (D == 64) {
    paged_decode_kernel<64, T><<<grid, 64, 0, st>>>(
        qq, kk, vv, kss, vss, tt, ll, pa, pm, N, bs, M, H, KV,
        tiles_per_split, scale);
    combine<64>(pa, pm, o, B, H, KV, n_split, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// part_acc: (B, KV, n_split, 8, D) f32 and part_ml: (B, KV, n_split, 8, 2)
// f32 scratch, allocated by the caller; n_split = ceil(tiles /
// tiles_per_split).  bf16: tiles of 16 rows (`block` must be 16).
extern "C" int repro_decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* part_acc, void* part_ml, void* o, int B, int S, int H, int KV,
    int D, int block, int window, int tiles_per_split, float scale,
    void* stream) {
  if (H % KV || H / KV > kMaxG || block != kTile || tiles_per_split < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return launch_decode_bf16<128>(q, k, v, cache_len, part_acc, part_ml, o,
                                   B, S, H, KV, window, tiles_per_split,
                                   scale, st);
  if (D == 64)
    return launch_decode_bf16<64>(q, k, v, cache_len, part_acc, part_ml, o,
                                  B, S, H, KV, window, tiles_per_split,
                                  scale, st);
  return (int)cudaErrorInvalidValue;
}

// int8 codes k, v (B, S, KV, D) with bf16 scales ks, vs (B, S, KV, 1);
// scratch as above.  No window (the reference has none).
extern "C" int repro_decode_attention_q8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* cache_len, void* part_acc, void* part_ml,
    void* o, int B, int S, int H, int KV, int D, int block,
    int tiles_per_split, float scale, void* stream) {
  return launch_decode<int8_t>(q, k, v, ks, vs, cache_len, part_acc,
                               part_ml, o, B, S, H, KV, D, block, -1,
                               tiles_per_split, scale, kMaxTQ8,
                               (cudaStream_t)stream);
}

// Scratch as above with n_split = ceil(ceil(M * bs / 16) /
// tiles_per_split): tiles of 16 logical rows, whatever the page size bs
// (1-64 rows).
extern "C" int repro_paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* cache_len, void* part_acc,
    void* part_ml, void* o, int B, int N, int bs, int M, int H, int KV,
    int D, int tiles_per_split, float scale, void* stream) {
  if (H % KV || H / KV > kMaxG || bs < 1 || bs > kMaxT ||
      tiles_per_split < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return launch_paged_bf16<128>(q, k_pages, v_pages, tables, cache_len,
                                  part_acc, part_ml, o, B, N, bs, M, H, KV,
                                  tiles_per_split, scale, st);
  if (D == 64)
    return launch_paged_bf16<64>(q, k_pages, v_pages, tables, cache_len,
                                 part_acc, part_ml, o, B, N, bs, M, H, KV,
                                 tiles_per_split, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Scratch as above with n_split = ceil(M / tiles_per_split).
// int8 code pages (N, bs, KV, D) with bf16 scale pages (N, bs, KV, 1).
extern "C" int repro_paged_decode_attention_q8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* ks_pages, const void* vs_pages, const void* tables,
    const void* cache_len, void* part_acc, void* part_ml, void* o, int B,
    int N, int bs, int M, int H, int KV, int D, int tiles_per_split,
    float scale, void* stream) {
  return launch_paged<int8_t>(q, k_pages, v_pages, ks_pages, vs_pages,
                              tables, cache_len, part_acc, part_ml, o, B, N,
                              bs, M, H, KV, D, tiles_per_split, scale,
                              kMaxTQ8, (cudaStream_t)stream);
}

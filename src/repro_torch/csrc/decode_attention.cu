// Single-token GQA decode attention: dense padded cache and block-paged
// cache, over bf16 K/V or int8 codes with per-(row, kv head) bf16 scales,
// all sharing one inner tile loop.
//
// Replaces repro/kernels/decode_attention.py::decode_attention_pallas
// (_kernel), ::paged_decode_attention_pallas (_paged_kernel),
// ::decode_attention_quant_pallas (_kernel_q8) and
// ::paged_decode_attention_quant_pallas (_paged_kernel_q8).
//
// Bound on the H100: bytes.  Each (sequence, kv head) streams its K and V
// rows once (2 * cache_len * D * 2 bytes in bf16, half that plus 4 bytes of
// scales per row in int8) for 2 * G * D flops per row, far below the ~295
// flop/byte ridge.  Design: a CTA per (b, kv head, split of S) holds all G
// query heads (G = 7 for qwen2-7b, looped, not padded to 8), so every K/V
// row leaves HBM once for the whole group, and the split of S
// (flash-decoding) puts B * K * n_split CTAs in flight instead of B * K,
// enough to keep HBM busy at decode batch sizes.  Rows are walked in tiles
// of `block` rows with an online softmax in f32; a second kernel merges the
// splits' partial (acc, max, sum) in split order.  The dense kernel stops
// at min(cache_len, S) (a free continuous slot keeps advancing its position
// past S) and starts at the window edge; the paged kernel reads its own
// block-table row and walks only ceil(cache_len / bs) entries, so only the
// sequence's own pages are read.  An int8 tile is staged first: each thread
// loads 16 codes (16 bytes) of K and of V, widens them to f32 in registers,
// multiplies by the row's scale and stores them in shared memory (the
// dequantize happens after the load, in f32, as in _kernel_q8); the tile
// loop then reads those rows.  Both kernels of a type call attend_tile on
// the same tiles, split the same tile indices and merge in the same order,
// so on identical K/V (or codes and scales) the dense and the paged decode
// give bit-identical outputs.  Not yet done: tensor cores (the G x block
// score tile is small), cp.async / TMA prefetch of the next tile.
#include <cstdint>

#include "attention_common.cuh"

namespace {

constexpr int kMaxG = 8;    // query heads per kv head held by one CTA
constexpr int kMaxT = 64;   // rows per tile
constexpr int kMaxTQ8 = 32; // rows per int8 tile (staged as f32 in smem)

// K/V rows as attend_tile reads them: bf16 straight from HBM, or the f32
// rows an int8 tile was dequantized into in shared memory.
struct Bf16Rows {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long stride;
  __device__ __forceinline__ float key(int r, int i) const {
    return bf2f(k[r * stride + i]);
  }
  __device__ __forceinline__ float val(int r, int i) const {
    return bf2f(v[r * stride + i]);
  }
};

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

// One tile of bf16 rows: attended where they lie.
template <int D>
__device__ __forceinline__ void load_attend(
    const __nv_bfloat16* k_rows, const __nv_bfloat16* v_rows,
    const __nv_bfloat16*, const __nv_bfloat16*, long row_stride, long,
    int n_rows, int lo, int hi, int G, const float (&qreg)[kMaxG][D / 32],
    float (&acc)[kMaxG], float& m, float& l, float* s_sm, float* alpha_sm) {
  attend_tile<D>(Bf16Rows{k_rows, v_rows, row_stride}, n_rows, lo, hi, G,
                 qreg, acc, m, l, s_sm, alpha_sm);
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
// order: the result does not depend on which CTA finished first).
template <int D>
__global__ void __launch_bounds__(D) combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ o, int H, int KV, int n_split) {
  const int kh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = H / KV;
  const long base = ((long)b * KV + kh) * n_split;
  for (int g = 0; g < G; ++g) {
    float m_all = REPRO_NEG_INF;
    for (int sp = 0; sp < n_split; ++sp)
      m_all = fmaxf(m_all, part_ml[((base + sp) * kMaxG + g) * 2]);
    float l_all = 0.f, acc = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const long slot = (base + sp) * kMaxG + g;
      const float w = expf(part_ml[slot * 2] - m_all);
      l_all += part_ml[slot * 2 + 1] * w;
      acc += part_acc[slot * D + tid] * w;
    }
    o[((long)b * H + kh * G + g) * D + tid] =
        __float2bfloat16(acc / fmaxf(l_all, 1e-30f));
  }
}

template <int D>
void combine(const float* part_acc, const float* part_ml, void* o, int B,
             int H, int KV, int n_split, cudaStream_t st) {
  combine_kernel<D><<<dim3(KV, B), D, 0, st>>>(
      part_acc, part_ml, (__nv_bfloat16*)o, H, KV, n_split);
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
// tiles_per_split).
extern "C" int repro_decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* part_acc, void* part_ml, void* o, int B, int S, int H, int KV,
    int D, int block, int window, int tiles_per_split, float scale,
    void* stream) {
  return launch_decode<__nv_bfloat16>(
      q, k, v, nullptr, nullptr, cache_len, part_acc, part_ml, o, B, S, H,
      KV, D, block, window, tiles_per_split, scale, kMaxT,
      (cudaStream_t)stream);
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

// Scratch as above with n_split = ceil(M / tiles_per_split).
extern "C" int repro_paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* cache_len, void* part_acc,
    void* part_ml, void* o, int B, int N, int bs, int M, int H, int KV,
    int D, int tiles_per_split, float scale, void* stream) {
  return launch_paged<__nv_bfloat16>(
      q, k_pages, v_pages, nullptr, nullptr, tables, cache_len, part_acc,
      part_ml, o, B, N, bs, M, H, KV, D, tiles_per_split, scale, kMaxT,
      (cudaStream_t)stream);
}

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

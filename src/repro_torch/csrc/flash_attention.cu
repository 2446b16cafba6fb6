// GQA flash attention for prefill: causal or not, optional sliding window
// and q_offset, ragged Sq / Sk edges masked in the kernel.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas
// (_kernel), with the semantics of repro/kernels/ops.py::_xla_flash (which
// pads ragged tails; here the kernel masks them itself, since bucketed
// prefill hands it Sq in {1, 2, 4, ..., 512}, often less than one tile,
// and the hybrid prefills at exact lengths Sq = prompt + 128).
//
// Bound on the H100: the two products are 4 * Sq * Sk * D flops per head
// (halved by the causal mask) against (Sq * 2H + 2 * Sk * K) * D * 2 bytes
// moved: at qwen2-7b's 512-token prefill about 1.9 GFLOP against 4.2 MB,
// so the bytes bound the ideal kernel (2.5 us) only just above the bf16
// tensor-core time (1.9 us), and both products must run on the tensor
// cores.  Design: one CTA of 4 warps per (b, q head, 64-row q tile); each
// warp holds its 16 q rows as mma.sync A fragments for the whole loop and
// runs the shared warp tile of attention_common.cuh (scores through
// ldmatrix, online softmax on the f32 C fragments, P kept in registers as
// the A fragment of P . V, V through ldmatrix.trans).  K/V tiles of 64
// rows stream through a 2-stage cp.async ring (16 bytes a thread,
// neighbouring threads on neighbouring addresses, rows past Sk
// zero-filled), so the next tile's load overlaps this tile's math; rows
// are padded by 16 bytes so ldmatrix reads are free of bank conflicts
// (85 KB of shared memory per CTA at D = 128, two CTAs per SM).  k tiles
// that the causal mask or the window hide from the whole CTA are never
// loaded, tiles hidden from one warp are skipped by it, and only tiles
// that straddle the diagonal, the window edge or Sk evaluate the mask.
// The grid walks q tiles heaviest first (reversed), so the last wave is
// the shortest.  Built for D = 16, 32, 64 and 128: every copy loop moves
// whole 16-byte pieces (two a row at D = 16), and at D = 16 each product
// is a single k16 step of the mma.
// Scores are scaled in f32 after the dot (q is not rounded after
// scaling, as ops.py:94 scales it in f32); P is rounded to bf16 for the
// second product (at most 2^-8 relative per weight).  The output goes
// through the warp's own Q rows in shared memory to 16-byte stores; q
// rows past Sq are never written.
#include <cstdint>

#include "attention_common.cuh"

namespace {

constexpr int kBQ = 64;     // query rows per CTA: 4 warps x 16
constexpr int kBK = 64;     // key rows per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;  // depth of the K/V cp.async ring

// Row stride of every shared tile: D plus a 16-byte pad, so the 8 rows
// one ldmatrix phase reads fall in 8 distinct 16-byte bank groups.
template <int D>
__host__ __device__ constexpr int ld() { return D + 8; }

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (kBQ + 2 * kStages * kBK) * ld<D>() * (int)sizeof(__nv_bfloat16);
}

// ROWS rows of D bf16 (row r at src + r * stride) into a shared tile with
// 16-byte cp.async; rows at or past `valid` are zero-filled, not read.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long stride, int valid) {
  constexpr int kPieces = D / 8;  // 16-byte pieces per row
#pragma unroll
  for (int i = 0; i < ROWS * kPieces / kThreads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int r = p / kPieces, c = (p % kPieces) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * ld<D>() + c, src + (ok ? r * stride : 0) + c, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int Sq, int Sk, int H, int KV, int causal, int window, int q_offset,
    float scale_log2) {
  constexpr int LD = ld<D>();
  constexpr int NT = kBK / 8;  // n8 score tiles per warp and k tile
  constexpr int NO = D / 8;    // n8 output tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * LD;               // [kStages][kBK][LD]
  __nv_bfloat16* Vs = Ks + kStages * kBK * LD;     // [kStages][kBK][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qbase = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / KV);
  const int q_rows = min(kBQ, Sq - qbase);
  const long kv_stride = (long)KV * D;
  const __nv_bfloat16* k_seq = k + ((long)b * Sk * KV + kh) * D;
  const __nv_bfloat16* v_seq = v + ((long)b * Sk * KV + kh) * D;

  // Live k range: tiles hidden from the whole CTA by the causal mask or
  // the window are never loaded.
  const int q_lo = q_offset + qbase, q_hi = q_lo + q_rows - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = window >= 0 ? max(0, q_lo - window + 1) : 0;
  const int kt0 = k_begin / kBK;
  const int n_kt = max(0, (k_end + kBK - 1) / kBK - kt0);

  load_rows<D, kBQ>(Qs, q + (((long)b * Sq + qbase) * H + h) * D,
                    (long)H * D, q_rows);
  cp_async_commit();
  auto load_kv = [&](int i) {
    const int kbase = (kt0 + i) * kBK, st = i % kStages;
    load_rows<D, kBK>(Ks + st * kBK * LD, k_seq + kbase * kv_stride,
                      kv_stride, Sk - kbase);
    load_rows<D, kBK>(Vs + st * kBK * LD, v_seq + kbase * kv_stride,
                      kv_stride, Sk - kbase);
  };
  if (n_kt > 0) load_kv(0);
  cp_async_commit();
  cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();
  unsigned qa[D / 16][4];
  warp_load_a<D>(Qs + warp * 16 * LD, LD, qa);

  float acc[NO][4] = {};
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
  const int wq_lo = q_lo + warp * 16, wq_hi = wq_lo + 15;  // warp's rows
  for (int i = 0; i < n_kt; ++i) {
    if (i + 1 < n_kt) load_kv(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile i has landed
    __syncthreads();
    const int kbase = (kt0 + i) * kBK, st = i % kStages;
    const bool visible =
        warp * 16 < q_rows && (!causal || kbase <= wq_hi) &&
        (window < 0 || kbase + kBK - 1 > wq_lo - window);
    if (visible) {
      float s[NT][4];
      warp_scores<D, NT>(qa, Ks + st * kBK * LD, LD, s);
      const bool edge = kbase + kBK > Sk ||
                        (causal && kbase + kBK - 1 > wq_lo) ||
                        (window >= 0 && kbase <= wq_hi - window);
      if (edge) {
        warp_scale_mask<NT>(s, scale_log2, [&](int r, int c) {
          const int qp = wq_lo + r, kp = kbase + c;
          return kp < Sk && (!causal || kp <= qp) &&
                 (window < 0 || kp > qp - window);
        });
      } else {
        warp_scale<NT>(s, scale_log2);
      }
      warp_softmax<NT, NO>(s, m, l, acc);
      warp_pv<D, NT>(s, Vs + st * kBK * LD, LD, acc);
    }
    __syncthreads();  // stage st is refilled by the next iteration
  }
  cp_async_wait<0>();

  // Normalise, stage the warp's 16 rows in its own (no longer read) Q
  // rows, and store them with 16-byte writes; rows past Sq are dropped.
  warp_row_sum(l);
  const int gid = lane >> 2, tig = lane & 3;
  __nv_bfloat16* Os = Qs + warp * 16 * LD;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const float inv = 1.f / fmaxf(l[hr], 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<unsigned*>(Os + (gid + 8 * hr) * LD + 8 * j +
                                   2 * tig) =
          pack_bf16(acc[j][2 * hr] * inv, acc[j][2 * hr + 1] * inv);
  }
  __syncwarp();
  constexpr int kPieces = D / 8;
#pragma unroll
  for (int i = 0; i < 16 * kPieces / 32; ++i) {
    const int p = lane + 32 * i;
    const int r = p / kPieces, c = (p % kPieces) * 8;
    if (warp * 16 + r < q_rows)
      *reinterpret_cast<uint4*>(
          o + (((long)b * Sq + qbase + warp * 16 + r) * H + h) * D + c) =
          *reinterpret_cast<const uint4*>(Os + r * LD + c);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int causal, int window,
           int q_offset, float scale, cudaStream_t st) {
  const int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<D><<<grid, kThreads, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Sq, Sk, H, KV, causal,
      window, q_offset, scale * REPRO_LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, KV, D), o (B, Sq, H, D): bf16,
// contiguous, 16-byte aligned.
extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int KV, int D, int causal, int window, int q_offset,
    float scale, void* stream) {
  if (H % KV || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                         q_offset, scale, st);
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                        q_offset, scale, st);
    case 32:
      return launch<32>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                        q_offset, scale, st);
    case 16:
      return launch<16>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                        q_offset, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

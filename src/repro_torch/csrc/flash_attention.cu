// GQA flash attention for prefill: causal or not, optional sliding window
// and q_offset, ragged Sq / Sk edges masked in the kernel.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas
// (_kernel), with the semantics of repro/kernels/ops.py::_xla_flash (which
// pads ragged tails; here the kernel masks them itself, since bucketed
// prefill hands it Sq in {1, 2, 4, ...}, often less than one tile).
//
// Bound on the H100: at prefill lengths the work is dominated by the two
// products (4 * Sq * Sk * D flops per head, halved by the causal mask)
// against (Sq * (2H) + 2 * Sk * K) * D * 2 bytes moved, so it is
// operation-bound for long prompts and byte-bound for short ones.  Design:
// one CTA per (b, q head, 64-row q tile) loops over 64-row k tiles with an
// online softmax in f32; the S x S score matrix never reaches HBM (only a
// 64 x 64 tile in shared memory), and k tiles that the causal mask or the
// window hide entirely are never loaded.  q is scaled in f32 before the dot
// (ops.py:94).  This first version computes on the f32 CUDA cores, not the
// tensor cores; wgmma and TMA are later work.
#include "attention_common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 64;       // key rows per tile
constexpr int kThreads = 256; // 16 x 16 threads; each owns 4 q rows

template <int D>
constexpr int smem_floats() {
  // Qs[BQ][D+1] + Kt[D][BK+1] + Vs[BK][D] + Ps[BQ][BK+1]
  return kBQ * (D + 1) + D * (kBK + 1) + kBK * D + kBQ * (kBK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int Sq, int Sk, int H, int KV, int causal, int window, int q_offset,
    float scale) {
  constexpr int QS = D + 1;    // padded row strides: conflict-free reads
  constexpr int KS = kBK + 1;
  constexpr int NO = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Kt = Qs + kBQ * QS;
  float* Vs = Kt + D * KS;
  float* Ps = Vs + kBK * D;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qbase = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KV);
  const int q_rows = min(kBQ, Sq - qbase);

  // Load and scale this CTA's q tile (rows past Sq are zero).
  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    float x = 0.f;
    if (r < q_rows) x = bf2f(q[(((long)b * Sq + qbase + r) * H + h) * D + c]);
    Qs[r * QS + c] = x * scale;
  }

  float acc[4][NO];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = REPRO_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[i][j] = 0.f;
  }

  // Live k range: tiles entirely hidden by the causal mask or the window
  // are skipped.
  const int q_lo = q_offset + qbase;
  const int q_hi = q_offset + qbase + q_rows - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = window >= 0 ? max(0, q_lo - window + 1) : 0;

  for (int kt = k_begin / kBK; kt * kBK < k_end; ++kt) {
    const int kbase = kt * kBK;
    __syncthreads();  // previous tile's Kt / Vs / Ps reads are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      float kx = 0.f, vx = 0.f;
      if (kbase + r < Sk) {
        const long idx = (((long)b * Sk + kbase + r) * KV + kh) * D + c;
        kx = bf2f(k[idx]);
        vx = bf2f(v[idx]);
      }
      Kt[c * KS + r] = kx;
      Vs[r * D + c] = vx;
    }
    __syncthreads();

    // S = Q K^T for rows ty + 16 i, cols tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Kt[d * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qa[i] * kb[j];
    }

    // Mask, online softmax (row reductions over the 16 threads of a row).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_offset + qbase + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kbase + tx + 16 * j;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window >= 0) ok = ok && kp > qp - window;
        if (!ok) s[i][j] = REPRO_NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mx);
        Ps[(ty + 16 * i) * KS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < NO; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V.
#pragma unroll 4
    for (int r = 0; r < kBK; ++r) {
      float pa[4], vb[NO];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * KS + r];
#pragma unroll
      for (int j = 0; j < NO; ++j) vb[j] = Vs[r * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NO; ++j) acc[i][j] += pa[i] * vb[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = o + (((long)b * Sq + qbase + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      orow[tx + 16 * j] = __float2bfloat16(acc[i][j] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int causal, int window,
           int q_offset, float scale, cudaStream_t st) {
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<D><<<grid, kThreads, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Sq, Sk, H, KV, causal,
      window, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int H, int KV, int D, int causal, int window, int q_offset,
    float scale, void* stream) {
  if (H % KV || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return launch<128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                       q_offset, scale, st);
  if (D == 64)
    return launch<64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                      q_offset, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Mamba-style selective scan (the Hymba SSM heads): per (batch, head), over
// time t, with A = -exp(a_log) and the D x N state S in f32,
//   S[d][n] <- S[d][n] * exp(dt_t * A[n]) + x_t[d] * (dt_t * b_t[n])
//   y_t[d]   = sum_n S[d][n] * c_t[n]      (from the updated state)
// with S taken from `state_in` and left in `state_out`.
//
// Replaces repro/kernels/ssm_scan.py::ssm_scan_pallas (_kernel).
//
// Bound on the H100: the bytes are x read and y written once (B*S*H*D
// bf16 each), b, c (B*S*H*N bf16) and dt read once, and the state read
// and written once (f32); the f32 work is about 5 operations per (t, h, d,
// n).  At hymba's D = 64, N = 16 the two bounds are close and the bytes
// win (a 640-step batch-1 prefill: 5.4 MB, 1.6 us).  But the time axis is
// a sequential dependence, so latency, not bandwidth, bounds a simple
// kernel.  Design: row d of the state depends only on x_t[d], dt_t, b_t,
// c_t and A, so rows are independent.  A CTA takes kRows rows of one
// (b, h) (grid D / kRows x H x B: a batch-1 prefill of 25 heads of 64 runs
// 100 CTAs rather than 25), and each row is held by kGroup threads with
// kPer of its N state values in registers for the whole sequence; y_t[d]
// is the sum of their partial dots (two shuffles).  kT steps of
// exp(dt * A), dt * b, c and the CTA's x rows are staged in shared memory
// per barrier -- the exponentials and products formed once per CTA, not
// once per row -- and the chunk's steps then run without a barrier, its y
// rows leaving through shared memory.  Any S >= 1 runs (prefill at the
// exact prompt length, decode at S = 1).  Built for N = 16 (hymba) and
// N = 8 (its reduced config: two threads a row).  Not yet done: a chunked
// matrix form on the tensor cores, double-buffered staging.
#include "attention_common.cuh"

namespace {

constexpr int kRows = 16;  // state rows per CTA
constexpr int kPer = 4;    // state values per thread (a float4 slice)
constexpr int kT = 64;     // time steps staged per barrier

// kN: the state size, 8 or 16; kN / kPer threads hold a row.
template <int kN>
__global__ void __launch_bounds__(kRows * kN / kPer) ssm_scan_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dt,
    const __nv_bfloat16* __restrict__ a_log,
    const __nv_bfloat16* __restrict__ bm, const __nv_bfloat16* __restrict__ cm,
    const float* __restrict__ state_in, __nv_bfloat16* __restrict__ y,
    float* __restrict__ state_out, int S, int H, int D) {
  constexpr int kGroup = kN / kPer;         // threads per row
  constexpr int kThreads = kRows * kGroup;  // 64 at N = 16, 32 at N = 8
  __shared__ __align__(16) float da_sm[kT][kN];  // exp(dt_t * A)
  __shared__ __align__(16) float db_sm[kT][kN];  // dt_t * b_t
  __shared__ __align__(16) float c_sm[kT][kN];
  __shared__ float x_sm[kT][kRows];
  __shared__ float y_sm[kT][kRows];
  __shared__ float a_sm[kN];
  const int d0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid / kGroup, g = tid % kGroup;
  if (tid < kN) a_sm[tid] = -expf(bf2f(a_log[h * kN + tid]));
  const long srow = (((long)b * H + h) * D + d0 + r) * kN + g * kPer;
  float st[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) st[i] = state_in[srow + i];
  const long bsh = (long)b * S * H + h;  // (b, t = 0, h)
  const long x_base = bsh * D + d0;      // x[b, 0, h, d0]; y alike
  const long n_base = bsh * kN;          // b[b, 0, h, 0]; c alike
  const long x_step = (long)H * D, n_step = (long)H * kN;
  __syncthreads();  // a_sm
  for (int t0 = 0; t0 < S; t0 += kT) {
    const int n = min(kT, S - t0);
#pragma unroll 4
    for (int e = tid; e < n * kN; e += kThreads) {
      const int t = e / kN, j = e % kN;
      const long off = n_base + (t0 + t) * n_step + j;
      const float dtt = bf2f(dt[bsh + (long)(t0 + t) * H]);
      da_sm[t][j] = expf(dtt * a_sm[j]);
      db_sm[t][j] = dtt * bf2f(bm[off]);
      c_sm[t][j] = bf2f(cm[off]);
    }
#pragma unroll 4
    for (int e = tid; e < n * kRows; e += kThreads) {
      const int t = e / kRows, j = e % kRows;
      x_sm[t][j] = bf2f(x[x_base + (t0 + t) * x_step + j]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float xv = x_sm[t][r];
      const float4 da = reinterpret_cast<const float4*>(da_sm[t])[g];
      const float4 db = reinterpret_cast<const float4*>(db_sm[t])[g];
      const float4 cc = reinterpret_cast<const float4*>(c_sm[t])[g];
      st[0] = fmaf(st[0], da.x, xv * db.x);
      st[1] = fmaf(st[1], da.y, xv * db.y);
      st[2] = fmaf(st[2], da.z, xv * db.z);
      st[3] = fmaf(st[3], da.w, xv * db.w);
      float part = fmaf(st[0], cc.x, st[1] * cc.y) +
                   fmaf(st[2], cc.z, st[3] * cc.w);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if constexpr (kGroup == 4) part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (g == 0) y_sm[t][r] = part;
    }
    __syncthreads();
    for (int e = tid; e < n * kRows; e += kThreads) {
      const int t = e / kRows, j = e % kRows;
      y[x_base + (t0 + t) * x_step + j] = __float2bfloat16(y_sm[t][j]);
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) state_out[srow + i] = st[i];
}

}  // namespace

// x: (B, S, H, D) bf16; dt: (B, S, H) bf16; a_log: (H, N) bf16; b, c:
// (B, S, H, N) bf16; state_in, state_out: two (B, H, D, N) f32 buffers;
// y: (B, S, H, D) bf16.  N must be 8 or 16 and D a multiple of 16.
extern "C" int repro_ssm_scan_bf16(const void* x, const void* dt,
                                   const void* a_log, const void* b,
                                   const void* c, const void* state_in,
                                   void* y, void* state_out, int B, int S,
                                   int H, int D, int N, void* stream) {
  if ((N != 8 && N != 16) || D % kRows || D < kRows || S < 1 || B < 1 ||
      H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  auto kernel = N == 16 ? ssm_scan_kernel<16> : ssm_scan_kernel<8>;
  kernel<<<dim3(D / kRows, H, B), kRows * N / kPer, 0,
           (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)dt,
      (const __nv_bfloat16*)a_log, (const __nv_bfloat16*)b,
      (const __nv_bfloat16*)c, (const float*)state_in, (__nv_bfloat16*)y,
      (float*)state_out, S, H, D);
  return (int)cudaGetLastError();
}

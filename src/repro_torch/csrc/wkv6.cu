// RWKV-6 WKV recurrence: per (batch, head), over time t,
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- exp(w_t[i]) * S[i][j] + k_t[i] * v_t[j]
// with the D x D state S in f32, taken from `state_in` and left in
// `state_out`.
//
// Replaces repro/kernels/wkv6.py::wkv6_pallas (_kernel).
//
// Bound on the H100: the bytes are r, k, v, w read and out written once
// (bf16) plus the state read and written once (f32); the 5 * D * D flops
// per step and head are far below the ridge.  But the time axis is a
// sequential dependence, so at B * H = 32 heads (a batch-1 prefill) only 32
// CTAs run and latency, not bandwidth, bounds the kernel.  Design: the
// Pallas kernel's sequential grid axis becomes a loop inside one CTA per
// (b, h) with D = 64 threads; thread j keeps column j of the state in
// registers for the whole sequence, so the state never leaves the SM
// between steps.  Inputs are staged kChunk steps at a time into shared
// memory (one coalesced 128-byte row per array and step, all loads of a
// chunk in flight together), with exp(w) and u * k formed at staging, and
// the chunk's steps then run without a barrier.  The output sum is split
// over four accumulators to shorten its dependence chain.  Any S >= 1 runs
// (prefill at the exact prompt length, decode at S = 1).  Not yet done: a
// chunked (matrix) form on the tensor cores, more CTAs per head.
#include "attention_common.cuh"

namespace {

constexpr int kD = 64;      // head size (rwkv6: fixed at 64)
constexpr int kChunk = 32;  // time steps staged per barrier

__global__ void __launch_bounds__(kD) wkv6_kernel(
    const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ u, const float* __restrict__ state_in,
    __nv_bfloat16* __restrict__ out, float* __restrict__ state_out, int S,
    int H) {
  __shared__ __align__(16) float r_sm[kChunk][kD];
  __shared__ __align__(16) float k_sm[kChunk][kD];
  __shared__ __align__(16) float ew_sm[kChunk][kD];  // exp(w)
  __shared__ __align__(16) float uk_sm[kChunk][kD];  // u * k
  __shared__ __align__(16) float v_sm[kChunk][kD];
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const float uj = bf2f(u[h * kD + j]);
  const long s_off = ((long)b * H + h) * kD * kD;
  float st[kD];  // column j of the state: st[i] = S[i][j]
#pragma unroll
  for (int i = 0; i < kD; ++i) st[i] = state_in[s_off + i * kD + j];
  const long step = (long)H * kD;  // elements between time steps
  const long base = ((long)b * S * H + h) * kD + j;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
#pragma unroll 8
    for (int c = 0; c < n; ++c) {
      const long x = base + (t0 + c) * step;
      const float kk = bf2f(k[x]);
      r_sm[c][j] = bf2f(r[x]);
      k_sm[c][j] = kk;
      ew_sm[c][j] = expf(bf2f(w[x]));
      uk_sm[c][j] = uj * kk;
      v_sm[c][j] = bf2f(v[x]);
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = v_sm[c][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kD; ++i) {
        const float s = st[i];
        acc[i & 3] = fmaf(r_sm[c][i], fmaf(uk_sm[c][i], vj, s), acc[i & 3]);
        st[i] = fmaf(ew_sm[c][i], s, k_sm[c][i] * vj);
      }
      out[base + (t0 + c) * step] =
          __float2bfloat16((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
    __syncthreads();  // the next chunk overwrites the staged rows
  }
#pragma unroll
  for (int i = 0; i < kD; ++i) state_out[s_off + i * kD + j] = st[i];
}

}  // namespace

// r, k, v, w: (B, S, H, D) bf16; u: (H, D) bf16; state_in, state_out:
// two (B, H, D, D) f32 buffers; out: (B, S, H, D) bf16.  D must be 64.
extern "C" int repro_wkv6_bf16(const void* r, const void* k, const void* v,
                               const void* w, const void* u,
                               const void* state_in, void* out,
                               void* state_out, int B, int S, int H, int D,
                               void* stream) {
  if (D != kD || S < 1 || B < 1 || H < 1) return (int)cudaErrorInvalidValue;
  wkv6_kernel<<<dim3(H, B), kD, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)r, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)u, (const float*)state_in, (__nv_bfloat16*)out,
      (float*)state_out, S, H);
  return (int)cudaGetLastError();
}

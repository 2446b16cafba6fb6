// Shared helpers of the port's kernels (sm_90a, plain C interface): PTX
// wrappers, bf16 hi + lo splits for the chunked recurrences (WKV-6, the
// selective scan), and the attention kernels' softmax on mma fragments.
//
// The last part serves one warp's attention tile on the tensor cores.
// The four decode kernels hold 16 "query rows" (the G query heads of one
// kv head) as the A fragment of mma.sync m16n8k16 and attend them to
// bf16 K/V rows in shared memory (int8 decode widens its codes to such
// rows; decode_attention.cu):
//   scores  S (16 x n) = Q (16 x D) . K^T   K through ldmatrix (B, "col")
//   softmax online, on the f32 C fragments: a row's values sit in one quad
//           of lanes, so a row reduction is two __shfl_xor_sync
//   P -> A  P rounded to bf16; two adjacent n8 C tiles are the k16 A
//           fragment of P . V, so P never touches shared memory
//   values  O (16 x D) += P . V         V through ldmatrix.trans
// The flash kernel runs the scale and mask steps and the row sum on
// wgmma accumulators, which hold each warp's 16 rows in the same C
// layout (hopper.cuh).  Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): lane =
// 4 * gid + tig; C element e of n8 tile j is row gid + 8 * (e >> 1),
// column 8 j + 2 tig + (e & 1).  Scores are scaled in f32 after the dot
// (q is never rounded after scaling) and carried in log2 units, so the
// softmax uses exp2f.  Rounding P to bf16 is the one rounding step the
// plain versions do not have: at most 2^-8 relative per weight.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Masked-score sentinel: the same finite -1e30 the JAX reference and the
// plain PyTorch versions use, so a fully masked tile behaves identically
// (its garbage is wiped by alpha = exp(-1e30 - m) = 0 at the first live
// tile).
#define REPRO_NEG_INF (-1e30f)
#define REPRO_LOG2E 1.4426950408889634f

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// -- PTX wrappers ------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !fill (the
// source is then not read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (both 4-byte aligned); zero-filled when
// !fill, the source then not read.
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(fill ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, `lo` in the low half (the lower k index).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// -- bf16 hi + lo splits (the chunked recurrences) -------------------------

// x as bf16 hi + lo halves: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_store(float x, __nv_bfloat16* hi,
                                            __nv_bfloat16* lo) {
  const __nv_bfloat16 h = __float2bfloat16(x);
  *hi = h;
  *lo = __float2bfloat16(x - __bfloat162float(h));
}

// (x0, x1) as packed bf16 pairs: hi halves, then the lo halves.
__device__ __forceinline__ void split_pack(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
}

// 2^x without the subnormal range (the factors here are at most 1, and one
// below 2^-126 is as good as 0).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 8 bf16 (16 bytes) to floats.
__device__ __forceinline__ void unpack8(uint4 bits, float* f) {
  const unsigned words[4] = {bits.x, bits.y, bits.z, bits.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(words[e] << 16);
    f[2 * e + 1] = __uint_as_float(words[e] & 0xffff0000u);
  }
}

// -- one warp's attention tile -----------------------------------------------

// Scale the scores to log2 units and mask them: live(r, c) for warp row
// r (0..15) and tile column c (0..8 NT-1); masked scores become
// REPRO_NEG_INF.
template <int NT, typename Live>
__device__ __forceinline__ void warp_scale_mask(float (&s)[NT][4],
                                                float scale_log2,
                                                const Live& live) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gid + 8 * (e >> 1), c = 8 * j + 2 * tig + (e & 1);
      s[j][e] = live(r, c) ? s[j][e] * scale_log2 : REPRO_NEG_INF;
    }
}

template <int NT>
__device__ __forceinline__ void warp_scale(float (&s)[NT][4],
                                           float scale_log2) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
}

// Online softmax of one tile for the lane's two rows (gid, gid + 8):
// s becomes P (f32), m is the running max (log2 units, equal across the
// quad), l the lane's part of the running sum (summed over the quad once,
// at the end: warp_row_sum), alpha the factor the rows' O takes
// (warp_rescale).  A row with no live score yet keeps m = REPRO_NEG_INF
// and gets p = 0.
template <int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = m[h];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float base = mx == REPRO_NEG_INF ? 0.f : mx;
    alpha[h] = exp2f(m[h] - base);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][2 * h] = exp2f(s[j][2 * h] - base);
      s[j][2 * h + 1] = exp2f(s[j][2 * h + 1] - base);
      sum += s[j][2 * h] + s[j][2 * h + 1];
    }
    l[h] = l[h] * alpha[h] + sum;
    m[h] = mx;
  }
}

// o's two rows of the lane times their alpha.
template <int NO>
__device__ __forceinline__ void warp_rescale(float (&o)[NO][4],
                                             const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
}

// The lane's row sums (rows gid, gid + 8) summed over its quad.
__device__ __forceinline__ void warp_row_sum(float (&l)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
}

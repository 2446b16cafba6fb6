// Shared helpers of the attention kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Masked-score sentinel: the same finite -1e30 the JAX reference and the
// plain PyTorch versions use, so a fully masked tile behaves identically
// (its garbage is wiped by alpha = exp(-1e30 - m) = 0 at the first live
// tile).
#define REPRO_NEG_INF (-1e30f)

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

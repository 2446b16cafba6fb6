// GQA flash attention for prefill on Hopper: causal or not, optional
// sliding window and q_offset, ragged Sq / Sk edges masked in the kernel.
//
// Replaces repro/kernels/flash_attention.py::flash_attention_pallas
// (_kernel), with the semantics of repro/kernels/ops.py::_xla_flash (which
// pads ragged tails; here TMA zero-fills them and the kernel masks them,
// since bucketed prefill hands it Sq in {1, 2, 4, ..., 512}, often less
// than one tile, and the hybrid prefills at exact lengths Sq = prompt +
// 128).
//
// Bound on the H100: the two products are 4 * Sq * Sk * D flops per head
// (halved by the causal mask) against (Sq * 2H + 2 * Sk * K) * D * 2 bytes
// moved: at qwen2-7b's 512-token prefill about 1.9 GFLOP against 4.2 MB,
// so the bytes bound the ideal kernel (2.5 us) only just above the bf16
// tensor-core time (1.9 us): both products must run at wgmma's rate, and
// loads must overlap them.
//
// Design (warp-specialised, hopper.cuh's blocks): a CTA is one consumer
// warpgroup, which owns 64 q rows of one q head, and one producer
// warpgroup; two CTAs share an SM.  (Two consumer warpgroups a CTA, on
// 128 rows or on two q heads of one kv head, measured slower at the main
// shape: PERF.md §6.)  One producer thread issues TMA loads (4-d tensor
// maps over (D, heads, rows, batch), boxes of 64 rows, swizzled to the row
// size; rows past Sq or Sk are zero-filled): the Q tile once, onto its
// own mbarrier, then each 64-row K tile and V tile into its own ring of S
// stages, each stage with a full barrier (one arrival plus the tile's
// transaction bytes) and an empty barrier (one arrival per consumer
// warp); after setmaxnreg the producer keeps 24 registers and the
// consumers take the rest.  The consumer warpgroup computes S_i = Q . K_i^T
// with wgmma m64n64k16 from shared memory (both K-major) and frees K_i at
// once; it scales S_i in f32 after the dot (log2 units), masks only tiles
// that straddle the diagonal, the window edge or Sk, and runs the online
// softmax on the accumulator fragments (a wgmma accumulator is, warp by
// warp, mma.sync's C fragment: attention_common.cuh's warp helpers); P_i,
// rounded to bf16 in registers, is the A operand of O += P_i . V_i (wgmma
// m64nDk16, V read as the transposed B operand), issued after S_{i+1} so
// that tile i + 1's softmax runs while it does; then V_i is freed and O
// rescaled.  K tiles that the causal mask or the window hide from the
// CTA's rows are never loaded.  The grid walks q tiles heaviest first,
// across the batch too; where it fits in two waves (one CTA an SM, then a
// second), the second takes its tiles lightest first, so the two CTAs an
// SM runs sum to an even load.  A head's output bits do not depend on the
// other heads of its launch: every CTA runs the same tile sequence, with
// the same masks, whatever the grid.  Rows past Sq are never written.
// Built for D = 16, 32, 64 and 128 (D = 128 rows are two boxes of 64).
// P is rounded to bf16 for the second product (at most 2^-8 relative per
// weight).
#include <atomic>
#include <cstdint>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;  // q rows a CTA (its consumer warpgroup: wgmma's M)
constexpr int kBK = 64;  // key rows a K/V tile (one TMA box high, as Q's)
constexpr int kThreads = 256;  // the consumer, then the producer warpgroup
constexpr int kMinBlocks = 2;  // CTAs an SM
// Registers: the launch gives every thread kEntryRegs; the producer
// warpgroup drops to kProducerRegs and the consumer takes what it frees.
constexpr int kEntryRegs = 65536 / (kThreads * kMinBlocks);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 2 * kEntryRegs - kProducerRegs;

template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kBQ * D * 2;  // 64 rows of D bf16: a Q, K or V tile
}

// As many K/V stages (at most 4) as kMinBlocks CTAs leave shared memory
// for, beside the Q tile, the barriers and 1024 bytes of alignment.
template <int D>
__host__ __device__ constexpr int stages() {
  constexpr int budget =
      233472 / kMinBlocks - 1024 - 1024 - 256 - tile_bytes<D>();
  return budget / (2 * tile_bytes<D>()) > 4 ? 4
                                             : budget / (2 * tile_bytes<D>());
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + 256 + (1 + 2 * stages<D>()) * tile_bytes<D>();
}

// Barrier rings in shared memory, S of each: K full / empty, V full /
// empty; then the Q barrier.
enum Ring { kFullK = 0, kEmptyK = 1, kFullV = 2, kEmptyV = 3, kRings = 4 };

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks) flash_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
    int Sq, int Sk, int H, int KV, int causal, int window, int q_offset,
    float scale_log2, int first_wave) {
  constexpr int kBoxCols = box_cols(D);
  constexpr int kRowBytes = box_row_bytes(D);
  constexpr int kBoxBytes = kBQ * kRowBytes;  // one box: 64 rows
  constexpr int kTile = tile_bytes<D>();      // D / kBoxCols boxes
  constexpr int S = stages<D>();
  constexpr int NT = kBK / 8;  // n8 score tiles a warp and k tile
  constexpr int NO = D / 8;    // n8 output tiles a warp
  static_assert(S >= 2, "the K/V rings need two stages");

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t bars = smem_addr(smem_raw);
  // Tile i's barrier of a ring (tile i lives in stage i % S).
  auto bar = [&](int ring, int i) { return bars + 8 * (ring * S + i % S); };
  const uint32_t qbar = bars + 8 * kRings * S;
  const uint32_t Qs = (qbar + 8 + 1023) & ~1023u;
  const uint32_t Ks = Qs + kTile;     // [S]
  const uint32_t Vs = Ks + S * kTile;  // [S]

  // Work rank r of CTA L (launch order): q tiles heaviest first, then
  // batch, then head.  Where the grid fits in two waves (one CTA an SM,
  // then a second), the second takes its ranks lightest first, so that the
  // SM holding the heaviest CTA is given the lightest beside it.
  const int n_b = gridDim.z, n_cta = H * gridDim.y * n_b;
  const int L = (blockIdx.z * gridDim.y + blockIdx.y) * H + blockIdx.x;
  const int r = L >= first_wave && n_cta <= 2 * first_wave
                    ? first_wave + n_cta - 1 - L
                    : L;
  const int h = r % H, kh = h / (H / KV), b = r / H % n_b;
  const int row0 = (gridDim.y - 1 - r / (H * n_b)) * kBQ;
  const int rows = min(kBQ, Sq - row0);

  // Live k range: tiles hidden from all the CTA's rows by the causal mask
  // or the window are never loaded.
  const int q_lo = q_offset + row0, q_hi = q_lo + rows - 1;
  const int k_end = causal ? min(Sk, q_hi + 1) : Sk;
  const int k_begin = window >= 0 ? max(0, q_lo - window + 1) : 0;
  const int kt0 = k_begin / kBK;
  const int n_kt = max(0, (k_end + kBK - 1) / kBK - kt0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bar(kFullK, s), 1);
      mbar_init(bar(kFullV, s), 1);
      mbar_init(bar(kEmptyK, s), 4);  // one arrival per consumer warp
      mbar_init(bar(kEmptyV, s), 4);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // -- producer: one thread keeps both rings full ---------------------------
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_arrive_expect_tx(qbar, kTile);
#pragma unroll
      for (int bx = 0; bx < D / kBoxCols; ++bx)
        tma_load_4d(Qs + bx * kBoxBytes, &qmap, qbar, bx * kBoxCols, h, row0,
                    b);
      // K before V of each tile: the consumer frees K_i as soon as S_i is
      // done and V_i only after P_i . V_i, one tile later.
      for (int i = 0; i < n_kt; ++i) {
        const int kbase = (kt0 + i) * kBK, st = i % S;
        const unsigned again = (i / S - 1) & 1;  // the stage's last use
#pragma unroll
        for (int ring = kFullK; ring <= kFullV; ring += 2) {
          const CUtensorMap* map = ring == kFullK ? &kmap : &vmap;
          const uint32_t dst = (ring == kFullK ? Ks : Vs) + st * kTile;
          if (i >= S) mbar_wait(bar(ring + 1, i), again);
          mbar_arrive_expect_tx(bar(ring, i), kTile);
#pragma unroll
          for (int bx = 0; bx < D / kBoxCols; ++bx)
            tma_load_4d(dst + bx * kBoxBytes, map, bar(ring, i),
                        bx * kBoxCols, kh, kbase, b);
        }
      }
    }
  } else {
    // -- consumer warpgroup: the CTA's 64 q rows ------------------------------
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wq_lo = q_lo + 16 * warp, wq_hi = wq_lo + 15;  // warp's rows

    float acc[NO][4], s[NT][4], m[2], l[2], alpha[2];
    unsigned pa[NT / 2][4];  // P as the A operand, 16 keys a k16 step
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) m[h2] = REPRO_NEG_INF, l[h2] = 0.f;

    auto wait_tile = [&](int ring, int i) {
      mbar_wait(bar(ring, i), (i / S) & 1);
    };
    auto release = [&](int ring, int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar(ring, i));
    };
    // Issue S = Q . K_i^T: D / 16 k16 steps, 32 bytes along a box row each.
    auto scores = [&](int i) {
      const uint32_t k_tile = Ks + (i % S) * kTile;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off =
            (16 * kk / kBoxCols) * kBoxBytes + (16 * kk % kBoxCols) * 2;
        wgmma_ss_n64(s, desc_k_major(Qs + off, kRowBytes),
                     desc_k_major(k_tile + off, kRowBytes), kk > 0);
      }
    };
    // Issue O += P . V_i: V's rows are the reduction, read as the
    // transposed B operand, 16 rows a step.
    auto values = [&](int i) {
      const uint32_t v_tile = Vs + (i % S) * kTile;
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
        wgmma_rs_tb<D>(acc, pa[kk],
                       desc_mn_major(v_tile + 16 * kk * kRowBytes, kRowBytes,
                                     kBoxBytes));
    };
    // Scale (and, on an edge tile, mask) S_i, then its online softmax.
    auto softmax = [&](int i) {
      const int kbase = (kt0 + i) * kBK;
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
      softmax_tile<NT>(s, m, l, alpha);
    };
    auto to_a = [&] {  // P rounded to bf16, in the A operand's layout
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
    };

    mbar_wait(qbar, 0);
    if (n_kt > 0) {
      wait_tile(kFullK, 0);
      wgmma_fence();
      scores(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      release(kEmptyK, 0);
      softmax(0);  // O is still 0: nothing to rescale
      to_a();
      // Tile i's scores run on the tensor cores before tile i - 1's
      // P . V, and its softmax while that product runs.
      for (int i = 1; i < n_kt; ++i) {
        wait_tile(kFullK, i);
        wait_tile(kFullV, i - 1);
        wgmma_fence();
        scores(i);
        wgmma_commit();
        values(i - 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
        release(kEmptyK, i);
        softmax(i);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        release(kEmptyV, i - 1);
        warp_rescale<NO>(acc, alpha);
        to_a();
      }
      wait_tile(kFullV, n_kt - 1);
      wgmma_fence();
      values(n_kt - 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release(kEmptyV, n_kt - 1);
    }

    // Normalise and store the warp's rows below Sq, 4 bytes a lane and
    // n8 tile (a row's 16 bytes of a tile from its quad).
    warp_row_sum(l);
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * warp + gid + 8 * hr;
      if (r >= rows) continue;
      const float inv = 1.f / fmaxf(l[hr], 1e-30f);
      __nv_bfloat16* dst =
          o + (((long)b * Sq + row0 + r) * H + h) * D + 2 * tig;
#pragma unroll
      for (int j = 0; j < NO; ++j)
        *reinterpret_cast<unsigned*>(dst + 8 * j) =
            pack_bf16(acc[j][2 * hr] * inv, acc[j][2 * hr + 1] * inv);
    }
  }
}

// The current device's SM count, with flash_kernel<D>'s shared-memory
// limit raised there: both once a device, not a call.
template <int D>
cudaError_t device_sms(int* out) {
  constexpr int kMaxDevices = 64;
  static std::atomic<int> sms[kMaxDevices];  // 0: not asked yet
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = sms[dev].load(std::memory_order_acquire);
  if (n == 0) {
    err = cudaFuncSetAttribute(flash_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<D>());
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev].store(n, std::memory_order_release);
  }
  *out = n;
  return cudaSuccess;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int causal, int window,
           int q_offset, float scale, cudaStream_t st) {
  CUtensorMap qmap, kmap, vmap;
  int err = encode_rows<D>(&qmap, q, B, Sq, H, kBQ);
  if (!err) err = encode_rows<D>(&kmap, k, B, Sk, KV, kBK);
  if (!err) err = encode_rows<D>(&vmap, v, B, Sk, KV, kBK);
  if (err) return err;
  int sms;
  const cudaError_t cerr = device_sms<D>(&sms);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid(H, (Sq + kBQ - 1) / kBQ, B);
  flash_kernel<D><<<grid, kThreads, smem_bytes<D>(), st>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)o, Sq, Sk, H, KV, causal, window,
      q_offset, scale * REPRO_LOG2E, sms);
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

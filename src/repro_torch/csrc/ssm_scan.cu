// Mamba-style selective scan (the Hymba SSM heads): per (batch, head), over
// time t, with A = -exp(a_log) and the D x N state S in f32,
//   S[d][n] <- S[d][n] * exp(dt_t * A[n]) + x_t[d] * (dt_t * b_t[n])
//   y_t[d]   = sum_n S[d][n] * c_t[n]      (from the updated state)
// with S taken from `state_in` and left in `state_out`.  Two kernels, one
// per shape: the wrapper (kernels/ssm_scan.py) takes the step kernel below
// CHUNKED_MIN_S steps (a decode round, S = 1) and the chunked kernel from
// there up (prefill).
//
// Both replace repro/kernels/ssm_scan.py::ssm_scan_pallas (_kernel).
//
// Bound on the H100: the bytes are x read and y written once (B*S*H*D
// bf16 each), b, c (B*S*H*N bf16) and dt read once, and the state read
// and written once (f32); the f32 work is about 5 operations per (t, h, d,
// n).  At hymba's D = 64, N = 16 the two bounds are close and the bytes
// win (a 640-step batch-1 prefill: 5.4 MB, 1.6 us).  But the time axis is
// a sequential dependence, so latency, not bandwidth, bounds both kernels.
//
// ssm_scan_kernel (the step kernel, decode rounds): row d of the state
// depends only on x_t[d], dt_t, b_t, c_t and A, so rows are independent.
// One thread holds one float4 of the state, 4 consecutive n of one row:
// N / 4 threads hold a row, and a warp holds 8 (N = 16) or 16 (N = 8)
// rows of one (b, h), since D N / 4 is a multiple of 32 when D is a
// multiple of 16.  CTAs of kStepThreads = 128 threads cover the B H D N / 4
// threads (400 CTAs at hymba's round, B = 8: one wave); a tail CTA returns
// whole warps.  A thread issues all of its loads at once (its state float4,
// 4 a_log, b and c values as one 8-byte load each, dt and x[d]; the
// threads of a row share x, dt and a_log through L1), and loads step t +
// 1's operands before step t's math: no shared memory, no barrier.  y_t[d]
// is the row's partial dots summed by shuffles and stored by the row's
// first thread.  The state is read once and written once, as one float4,
// by the same thread, so `state_out` may be `state_in` (the pool's layer
// view, written in place): those two pointers are not __restrict__ and the
// state is never read through the non-coherent path.  What bounds a round
// is one DRAM round trip over 1.64 MB of state (read and written at B = 8,
// H = 25, D = 64, N = 16: 0.49 us at 3.35 TB/s) plus the launch and drain.
//
// ssm_chunked_kernel (prefill): WKV-6's chunked form (wkv6.cu) with the
// transposed state S^T (N x D) as its key x value state, k_s = dt_s b_s,
// v_s = x_s, r_t = c_t and the log-decay dt_t A[n].  Per chunk of kL = 16
// steps, with Lam_t = sum_{tau <= t} dt_tau from the chunk's start (one
// f32 scalar a step: the decay is rank 1, A[n] times a scalar),
//   y_t = sum_n c_t[n] e^{A[n] Lam_t} S_0[:, n] + sum_{s <= t} P[t][s] x_s,
//   P[t][s] = sum_n c_t[n] k_s[n] e^{A[n] (Lam_t - Lam_s)},
//   S_L[:, n] = e^{A[n] Lam_L} S_0[:, n]
//               + sum_s x_s k_s[n] e^{A[n] (Lam_L - Lam_s)},
// so the serial chain is 40 chunk links at S = 640 instead of 640 steps.
// Three differences from WKV-6: y reads the state after step t, so the
// r-side decay includes step t (e^{A Lam_t}, not Lam_{t-1}) and the
// diagonal is c_t . k_t with exponent 0 (no bonus u); the decay factors
// need one Lam per row and the head's N values of A, held in registers,
// not two rows of per-channel decay sums; and the key depth is N = 16 (or
// 8, zero-padded to a k16 step), not 64.  Nothing bounds dt A below (a_log
// is a trained weight and dt an unbounded softplus), so e^{-A Lam} is never
// formed: a score is factored only through a boundary between s and t,
// with z the highest power of two in t XOR s and ref = (t / z) z - 1,
//   P[t][s] = (c_t e^{A (Lam_t - Lam_ref)}) . (k_s e^{A (Lam_ref - Lam_s)}),
// both factors <= 1.  The 120 scores of a chunk fall into four levels
// (z = 8, 4, 2, 1), each a masked Q Q^T of a 16 x N matrix on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 out); the diagonal comes from
// c b^T of the exact raw rows, times dt_t in f32.  The state update
// S += X^T k~ (S as d x n C fragments) and the outputs y (t x d) =
// c~ S_0^T + P X run on the tensor cores too.  Operands that are not
// exact bf16 (the state, c~, k~, Q, P) are split into bf16 hi + lo and
// multiplied as hi.hi + hi.lo + lo.hi (P and k~ against the exact x: hi +
// lo); the state itself stays f32 in registers.
//
// Filling the card: output column d depends only on state row d, so a CTA
// takes kRows = 16 rows of one (b, h): grid (D / 16, H, B), 100 CTAs at
// hymba's batch-1 prefill; each recomputes the chunk's scores (at N = 16
// they are cheap).  Only the chain warp touches the state: it reads its
// CTA's rows before the first chunk and writes the same rows after the
// last, so `state_out` may be `state_in` here too (neither is
// __restrict__).  The scores do not depend on the state, so the work
// splits by chunk and by stage, a group of kG = 8 chunks at a time in
// three buffer sets: 8 producer warps build group g's factors and scores
// (one chunk a warp, its raw rows loaded into registers a group ahead
// by volatile loads, which the compiler cannot sink to their first use);
// the chain warp runs group g - 1's 8 links, each only S <- S e^{A Lam_L}
// + X^T k~ (4 mma) after handing S_0 to shared memory as hi and lo tiles;
// and 2 read-out warps write group g - 2's outputs (10 mma a chunk).
// What bounds it: the producers' chunk work, a latency chain of dependent
// shared-memory loads, exp2 and conversions in one warp, which 11 warps on
// 4 schedulers hide poorly, and the raw rows' global loads; the chain's
// links, 4 mma each, are shorter.  On an H100 (chip_smoke.py) hymba's
// 640-step prefill of 25 heads takes about 0.017 ms against a 0.0016 ms
// byte bound, and 200 CTAs (B = 2) take about twice as long as 100: one
// CTA fills an SM, so slices of 8 rows would run in two waves.
#include "attention_common.cuh"

namespace {

constexpr int kRows = 16;  // state rows per CTA of the chunked kernel
constexpr int kStepThreads = 128;  // threads per CTA of the step kernel

// Four bf16 (one 8-byte load) as f32.
__device__ __forceinline__ void unpack4(uint2 bits, float (&f)[4]) {
  f[0] = __uint_as_float(bits.x << 16);
  f[1] = __uint_as_float(bits.x & 0xffff0000u);
  f[2] = __uint_as_float(bits.y << 16);
  f[3] = __uint_as_float(bits.y & 0xffff0000u);
}

// One step's operands of one thread: x[d], dt, and its 4 b and c values.
struct StepIn {
  __nv_bfloat16 x, dt;
  uint2 b, c;
};

// kN: the state size, 8 or 16; kN / 4 threads hold a row.  `total`: B H
// D kN / 4 threads, a multiple of 32.
template <int kN>
__global__ void __launch_bounds__(kStepThreads) ssm_scan_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dt,
    const __nv_bfloat16* __restrict__ a_log,
    const __nv_bfloat16* __restrict__ bm, const __nv_bfloat16* __restrict__ cm,
    const float* state_in, __nv_bfloat16* __restrict__ y, float* state_out,
    int total, int S, int H, int D) {
  constexpr int kGroup = kN / 4;  // threads per row
  const int i = blockIdx.x * kStepThreads + threadIdx.x;
  if (i >= total) return;  // whole warps only
  const float4 st_in = reinterpret_cast<const float4*>(state_in)[i];
  const int row = i / kGroup, g = i % kGroup;  // row: (b, h, d)
  const int d = row % D, bh = row / D, h = bh % H, b = bh / H;
  const long bsh = (long)b * S * H + h;        // (b, t = 0, h)
  const long x_base = bsh * D + d;             // x[b, 0, h, d]; y alike
  const long n_base = bsh * kN + g * 4;        // b[b, 0, h, 4 g]; c alike
  const long x_step = (long)H * D, n_step = (long)H * kN;
  const uint2 a_bits = *reinterpret_cast<const uint2*>(a_log + h * kN + g * 4);
  auto load = [&](int t, StepIn& in) {
    in.x = x[x_base + t * x_step];
    in.dt = dt[bsh + (long)t * H];
    in.b = *reinterpret_cast<const uint2*>(bm + n_base + t * n_step);
    in.c = *reinterpret_cast<const uint2*>(cm + n_base + t * n_step);
  };
  StepIn cur;
  load(0, cur);
  float a[4];
  unpack4(a_bits, a);
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = -expf(a[j]);
  float st[4] = {st_in.x, st_in.y, st_in.z, st_in.w};
  for (int t = 0; t < S; ++t) {
    StepIn next = cur;
    if (t + 1 < S) load(t + 1, next);
    const float xv = bf2f(cur.x), dtv = bf2f(cur.dt);
    float bv[4], cv[4];
    unpack4(cur.b, bv);
    unpack4(cur.c, cv);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st[j] = fmaf(st[j], expf(dtv * a[j]), xv * (dtv * bv[j]));
    float part = fmaf(st[0], cv[0], st[1] * cv[1]) +
                 fmaf(st[2], cv[2], st[3] * cv[3]);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if constexpr (kGroup == 4) part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (g == 0) y[x_base + t * x_step] = __float2bfloat16(part);
    cur = next;
  }
  reinterpret_cast<float4*>(state_out)[i] =
      make_float4(st[0], st[1], st[2], st[3]);
}

// -- the chunked kernel -------------------------------------------------------

constexpr int kL = 16;            // steps per chunk: one k16 step
constexpr int kK = 16;            // the key depth of every product: N, or
                                  // N = 8 zero-padded to one k16 step
constexpr int kG = 8;             // chunks a group = producer warps
constexpr int kChainWarp = kG;    // the state chain
constexpr int kOutWarps = 2;      // the read-out warps, kG / 2 chunks each
constexpr int kCThreads = (kG + 1 + kOutWarps) * 32;
constexpr int kSets = 3;          // buffer sets: group g being built, g - 1
                                  // chained, g - 2 read out
constexpr int kLd = 24;  // bf16 row stride of a 16 x 16 tile (48 B: rows
                         // of an ldmatrix 8 x 8 fall in distinct banks)
constexpr int kTile = kL * kLd;   // elements of one tile
// A chunk's buffer: c~, k~ and P as hi and lo tiles, the CTA's x columns
// (exact bf16), the chunk's starting state S_0 as hi and lo tiles (d rows,
// n columns; written by the chain) and e^{A Lam_L} (kK f32).  A producer
// warp's scratch: its chunk's raw b and c rows, the four levels' Q as hi
// and lo tiles, and Lam and dt (kL f32 each).
constexpr int kDerivedBytes = 9 * kTile * 2 + kK * 4;
constexpr int kScratchBytes = 10 * kTile * 2 + 2 * kL * 4;
constexpr int kChunkSmem = kSets * kG * kDerivedBytes + kG * kScratchBytes;
static_assert(kDerivedBytes % 16 == 0 && kScratchBytes % 16 == 0,
              "16-byte aligned buffers");
static_assert(kL == kRows && kL == kK, "16 x 16 tiles throughout");
static_assert(kChunkSmem <= 232448, "an H100 block's shared memory");

// 16 bytes of global memory through the read-only path, or zeros where
// !pred.  Volatile, so the load is issued where it is written, a group
// ahead of its use, and not sunk toward its first use.
__device__ __forceinline__ uint4 ldg16_early(const void* p, bool pred) {
  uint4 r;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %5, 0;\n"
      " mov.b32 %0, 0;\n mov.b32 %1, 0;\n mov.b32 %2, 0;\n mov.b32 %3, 0;\n"
      " @q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p), "r"((int)pred));
  return r;
}

// One bf16 of global memory as f32 bits (bf16 << 16), or 0 where !pred;
// issued where it is written, as ldg16_early.
__device__ __forceinline__ unsigned ldg_bf16_early(const void* p, bool pred) {
  unsigned short h;
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n mov.b16 %0, 0;\n"
      " @q ld.global.nc.u16 %0, [%1];\n}\n"
      : "=h"(h) : "l"(p), "r"((int)pred));
  return (unsigned)h << 16;
}

// One chunk's raw inputs as a producer warp loads them: lane l holds 16
// bytes of x (row l / 2, columns 8 (l % 2) of the CTA's 16), of b and of c
// (at N = 16 as x; at N = 8 row l, lanes 0-15), and dt of step l (lanes
// 0-15); zero past S.
struct RawRegs {
  uint4 x, b, c;
  unsigned dt;  // f32 bits
};

// Fragment addressing of a 16 x 16 bf16 tile (row stride kLd) for
// mma.m16n8k16: the A fragment from row-major rows (ldmatrix), the B
// fragments of both n8 tiles from a tile whose rows are the n index
// (ldmatrix) or the k index (ldmatrix.trans).
__device__ __forceinline__ void load_a(unsigned (&a)[4],
                                       const __nv_bfloat16* tile, int lane) {
  ldmatrix_x4(a, tile + (lane & 15) * kLd + (lane >> 4) * 8);
}
__device__ __forceinline__ void load_b_nk(unsigned (&b)[4],
                                          const __nv_bfloat16* tile,
                                          int lane) {
  ldmatrix_x4(b, tile + ((lane & 7) + ((lane >> 4) << 3)) * kLd +
                     ((lane >> 3) & 1) * 8);
}
__device__ __forceinline__ void load_b_kn(unsigned (&b)[4],
                                          const __nv_bfloat16* tile,
                                          int lane) {
  ldmatrix_x4_trans(b, tile + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLd +
                           (lane >> 4) * 8);
}

template <int kN>
__global__ void __launch_bounds__(kCThreads) ssm_chunked_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dt,
    const __nv_bfloat16* __restrict__ a_log,
    const __nv_bfloat16* __restrict__ bm, const __nv_bfloat16* __restrict__ cm,
    const float* state_in, __nv_bfloat16* __restrict__ y, float* state_out,
    int S, int H, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* scr_base = smem_raw + kSets * kG * kDerivedBytes;

  struct Derived {
    __nv_bfloat16 *rhi, *rlo, *khi, *klo, *phi, *plo, *x, *shi, *slo;
    float* decay;
  };
  // Chunk c's buffer: group c / kG uses set (c / kG) % kSets.
  auto derived_at = [&](int c) {
    auto* p = reinterpret_cast<__nv_bfloat16*>(
        smem_raw + (((c / kG) % kSets) * kG + c % kG) * kDerivedBytes);
    return Derived{p,             p + kTile,     p + 2 * kTile,
                   p + 3 * kTile, p + 4 * kTile, p + 5 * kTile,
                   p + 6 * kTile, p + 7 * kTile, p + 8 * kTile,
                   reinterpret_cast<float*>(p + 9 * kTile)};
  };

  const int d0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const long bsh = (long)b * S * H + h;  // (b, t = 0, h)
  const long x_base = bsh * D + d0;      // x[b, 0, h, d0]; y alike
  const long n_base = bsh * kN;          // b[b, 0, h, 0]; c alike
  const long x_step = (long)H * D, n_step = (long)H * kN;
  const int n_chunks = (S + kL - 1) / kL;
  const int n_groups = (n_chunks + kG - 1) / kG;

  auto load_raw = [&](int c, RawRegs& r) {
    const int t0 = c * kL, half = (lane & 1) * 8;
    const int t = t0 + (lane >> 1);
    const bool live = c < n_chunks;
    const bool tok = live && t < S;
    r.x = ldg16_early(x + x_base + (tok ? t * x_step + half : 0), tok);
    const int tn = kN == 16 ? t : t0 + lane;
    const bool nok = live && (kN == 16 || lane < kL) && tn < S;
    const long noff = nok ? tn * n_step + (kN == 16 ? half : 0) : 0;
    r.b = ldg16_early(bm + n_base + noff, nok);
    r.c = ldg16_early(cm + n_base + noff, nok);
    const bool dok = live && lane < kL && t0 + lane < S;
    r.dt = ldg_bf16_early(dt + bsh + (dok ? (long)(t0 + lane) * H : 0), dok);
  };

  // A[n] log2(e) for every n of the k16 step, and for n = lane % 16 (0
  // past N: the padded columns hold zeros, whatever their factor).
  auto a2_of = [&](int n) {
    return n < kN ? -expf(bf2f(a_log[h * kN + n])) * REPRO_LOG2E : 0.f;
  };
  float a2[kK];
#pragma unroll
  for (int n = 0; n < kK; ++n) a2[n] = a2_of(n);
  const float a2_lane = a2_of(lane % kK);

  // Chunk c's factors and scores into its buffer (one producer warp).
  auto produce = [&](int c, const RawRegs& r) {
    if (c >= n_chunks) return;
    const Derived d = derived_at(c);
    auto* braw = reinterpret_cast<__nv_bfloat16*>(scr_base +
                                                  warp * kScratchBytes);
    __nv_bfloat16* craw = braw + kTile;
    auto q_hi = [&](int lev) { return braw + (2 + lev) * kTile; };
    auto q_lo = [&](int lev) { return braw + (6 + lev) * kTile; };
    float* lam = reinterpret_cast<float*>(braw + 10 * kTile);
    float* dts = lam + kL;
    *reinterpret_cast<uint4*>(d.x + (lane >> 1) * kLd + (lane & 1) * 8) = r.x;
    {
      // The raw rows; at N = 8 lanes 16-31 zero the padded columns.
      const int row = kN == 16 ? lane >> 1 : lane & 15;
      const int col = kN == 16 ? (lane & 1) * 8 : (lane >> 4) * 8;
      const bool pad = kN == 8 && lane >= kL;
      *reinterpret_cast<uint4*>(braw + row * kLd + col) =
          pad ? make_uint4(0u, 0u, 0u, 0u) : r.b;
      *reinterpret_cast<uint4*>(craw + row * kLd + col) =
          pad ? make_uint4(0u, 0u, 0u, 0u) : r.c;
    }
    // Lam: the inclusive running sum of dt over the chunk (lanes 0-15).
    const float dtv = __uint_as_float(r.dt);
    float v = dtv;
#pragma unroll
    for (int off = 1; off < kL; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off, kL);
      if ((lane & (kL - 1)) >= off) v += u;
    }
    if (lane < kL) {
      lam[lane] = v;
      dts[lane] = dtv;
    }
    __syncwarp();
    if (lane < kK) d.decay[lane] = exp2_ftz(a2_lane * lam[kL - 1]);
    // 96 factor rows, three a lane: task i = lane + 32 j is row i % 16 of
    // array i / 16: c~ (c_t e^{A Lam_t}), k~ (k_s e^{A (Lam_L - Lam_s)}),
    // then the Q of levels z = 8, 4, 2, 1: a row in an odd z-block is
    // c_t e^{A (Lam_t - Lam_ref)}, ref the last step of the block below;
    // a row in an even block is k_s e^{A (Lam_ref - Lam_s)}, ref the last
    // step of its own block.  Every exponent is A times a sum of dt: <= 0.
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int arr = (lane >> 4) + 2 * j, row = lane & (kL - 1);
      bool use_k = arr == 1;
      float delta = arr == 1 ? lam[kL - 1] - lam[row] : lam[row];
      if (arr >= 2) {
        const int z = 8 >> (arr - 2), blk = row / z;
        use_k = !(blk & 1);
        delta = use_k ? lam[blk * z + z - 1] - lam[row]
                      : lam[row] - lam[blk * z - 1];
      }
      const float scale = use_k ? dts[row] : 1.f;
      const __nv_bfloat16* src = (use_k ? braw : craw) + row * kLd;
      float val[kK];
      unpack8(reinterpret_cast<const uint4*>(src)[0], val);
      unpack8(reinterpret_cast<const uint4*>(src)[1], val + 8);
      unsigned wh[kK / 2], wl[kK / 2];
#pragma unroll
      for (int e = 0; e < kK / 2; ++e)
        split_pack(val[2 * e] * scale * exp2_ftz(a2[2 * e] * delta),
                   val[2 * e + 1] * scale * exp2_ftz(a2[2 * e + 1] * delta),
                   wh[e], wl[e]);
      __nv_bfloat16* dh =
          (arr == 0 ? d.rhi : arr == 1 ? d.khi : q_hi(arr - 2)) + row * kLd;
      __nv_bfloat16* dl =
          (arr == 0 ? d.rlo : arr == 1 ? d.klo : q_lo(arr - 2)) + row * kLd;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        reinterpret_cast<uint4*>(dh)[g] = make_uint4(
            wh[4 * g], wh[4 * g + 1], wh[4 * g + 2], wh[4 * g + 3]);
        reinterpret_cast<uint4*>(dl)[g] = make_uint4(
            wl[4 * g], wl[4 * g + 1], wl[4 * g + 2], wl[4 * g + 3]);
      }
    }
    __syncwarp();  // the Q tiles are complete
    // The four levels' Q Q^T (A = Q, B = Q^T from the same rows), each
    // kept where the highest bit of t XOR s is its z and s < t; and the
    // diagonal c_t . k_t = dt_t (c_t . b_t), with c . b^T from the exact
    // raw rows.
    float acc[4][2][4] = {}, cb[2][4] = {};
#pragma unroll
    for (int lev = 0; lev < 4; ++lev) {
      unsigned ah[4], al[4], bh[4], bl[4];
      load_a(ah, q_hi(lev), lane);
      load_a(al, q_lo(lev), lane);
      load_b_nk(bh, q_hi(lev), lane);
      load_b_nk(bl, q_lo(lev), lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        mma_bf16(acc[lev][nt], ah, bh[2 * nt], bh[2 * nt + 1]);
        mma_bf16(acc[lev][nt], ah, bl[2 * nt], bl[2 * nt + 1]);
        mma_bf16(acc[lev][nt], al, bh[2 * nt], bh[2 * nt + 1]);
      }
    }
    {
      unsigned ca[4], bb[4];
      load_a(ca, craw, lane);
      load_b_nk(bb, braw, lane);
      mma_bf16(cb[0], ca, bb[0], bb[1]);
      mma_bf16(cb[1], ca, bb[2], bb[3]);
    }
    // P as hi and lo halves, a pair of adjacent s a lane and row: C element
    // (t = gid + 8 hh, s = 8 nt + 2 tig + e).
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = gid + 8 * hh;
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * hh + e, s = 8 * nt + 2 * tig + e, xr = t ^ s;
          p[e] = t < s      ? 0.f
                 : t == s   ? dts[t] * cb[nt][i]
                 : xr >= 8  ? acc[0][nt][i]
                 : xr >= 4  ? acc[1][nt][i]
                 : xr >= 2  ? acc[2][nt][i]
                            : acc[3][nt][i];
        }
        unsigned hi, lo;
        split_pack(p[0], p[1], hi, lo);
        const int off = t * kLd + 8 * nt + 2 * tig;
        *reinterpret_cast<unsigned*>(d.phi + off) = hi;
        *reinterpret_cast<unsigned*>(d.plo + off) = lo;
      }
  };

  // The chain warp's state: S (16 rows d x 16 columns n, zero past N) as
  // the C fragments of two n8 tiles: st[nt][e] is S[d0 + gid + 8 (e >>
  // 1)][8 nt + 2 tig + (e & 1)].
  float st[2][4];
  const long s_off = (((long)b * H + h) * D + d0) * kN;
  auto s_col = [&](int nt, int e) { return 8 * nt + 2 * tig + (e & 1); };
  auto s_index = [&](int nt, int e) {
    return s_off + (gid + 8 * (e >> 1)) * kN + s_col(nt, e);
  };

  // Chunk c's link: hand S_0 to the read-out (hi and lo tiles), then
  // S <- S . e^{A Lam_L} (per column n) + X^T k~ (hi, lo), with A = X^T
  // through ldmatrix.trans from x (s rows, d contiguous) and B = k~ through
  // ldmatrix.trans from k~ (s rows, n contiguous).
  auto link = [&](int c) {
    const Derived d = derived_at(c);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        unsigned hi, lo;
        split_pack(st[nt][2 * hh], st[nt][2 * hh + 1], hi, lo);
        const int off = (gid + 8 * hh) * kLd + 8 * nt + 2 * tig;
        *reinterpret_cast<unsigned*>(d.shi + off) = hi;
        *reinterpret_cast<unsigned*>(d.slo + off) = lo;
      }
    unsigned va[4], bh[4], bl[4];
    ldmatrix_x4_trans(va, d.x + ((lane & 7) + ((lane >> 4) << 3)) * kLd +
                              ((lane >> 3) & 1) * 8);
    load_b_kn(bh, d.khi, lane);
    load_b_kn(bl, d.klo, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float2 dec =
          *reinterpret_cast<const float2*>(d.decay + 8 * nt + 2 * tig);
      st[nt][0] *= dec.x;
      st[nt][1] *= dec.y;
      st[nt][2] *= dec.x;
      st[nt][3] *= dec.y;
      mma_bf16(st[nt], va, bh[2 * nt], bh[2 * nt + 1]);
      mma_bf16(st[nt], va, bl[2 * nt], bl[2 * nt + 1]);
    }
  };

  // Chunk c's outputs (a read-out warp): y (t x d) = c~ S_0^T (hi, lo;
  // B = S_0^T from the state tiles, d rows) + P X (hi, lo; B = X through
  // ldmatrix.trans from x), in four independent accumulators; a lane
  // stores pairs of adjacent d, rows past S dropped.
  auto read_out = [&](int c) {
    const Derived d = derived_at(c);
    unsigned rh[4], rl[4], ph[4], pl[4], sh[4], sl[4], xb[4];
    load_a(rh, d.rhi, lane);
    load_a(rl, d.rlo, lane);
    load_a(ph, d.phi, lane);
    load_a(pl, d.plo, lane);
    load_b_nk(sh, d.shi, lane);
    load_b_nk(sl, d.slo, lane);
    load_b_kn(xb, d.x, lane);
    float o[4][2][4] = {};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      mma_bf16(o[0][nt], rh, sh[2 * nt], sh[2 * nt + 1]);
      mma_bf16(o[1][nt], rh, sl[2 * nt], sl[2 * nt + 1]);
      mma_bf16(o[2][nt], rl, sh[2 * nt], sh[2 * nt + 1]);
      mma_bf16(o[3][nt], ph, xb[2 * nt], xb[2 * nt + 1]);
      mma_bf16(o[3][nt], pl, xb[2 * nt], xb[2 * nt + 1]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = c * kL + gid + 8 * hh;
      if (t >= S) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * hh + e;
          v[e] = (o[0][nt][i] + o[1][nt][i]) + (o[2][nt][i] + o[3][nt][i]);
        }
        *reinterpret_cast<unsigned*>(y + x_base + t * x_step + 8 * nt +
                                     2 * tig) = pack_bf16(v[0], v[1]);
      }
    }
  };

  const bool producer = warp < kG, chain = warp == kChainWarp;
  RawRegs cur;
  if (producer) {
    load_raw(warp, cur);
  } else if (chain) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[nt][e] = s_col(nt, e) < kN ? state_in[s_index(nt, e)] : 0.f;
  }
  // Iteration g: the producers build group g, the chain warp runs group
  // g - 1's links and the read-out warps write group g - 2's outputs, each
  // in its own buffer set.
  for (int g = 0; g < n_groups + 2; ++g) {
    if (producer) {
      if (g < n_groups) {
        RawRegs next;
        load_raw((g + 1) * kG + warp, next);
        produce(g * kG + warp, cur);
        cur = next;
      }
    } else if (chain) {
      if (g >= 1 && g <= n_groups)
        for (int c = (g - 1) * kG; c < min(g * kG, n_chunks); ++c) link(c);
    } else if (g >= 2) {
      constexpr int kPer = kG / kOutWarps;
      const int c0 = (g - 2) * kG + (warp - kChainWarp - 1) * kPer;
      for (int c = c0; c < min(c0 + kPer, n_chunks); ++c) read_out(c);
    }
    __syncthreads();
  }
  if (chain) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s_col(nt, e) < kN) state_out[s_index(nt, e)] = st[nt][e];
  }
}

}  // namespace

// x: (B, S, H, D) bf16; dt: (B, S, H) bf16; a_log: (H, N) bf16; b, c:
// (B, S, H, N) bf16; state_in, state_out: (B, H, D, N) f32, one buffer or
// two that do not overlap; y: (B, S, H, D) bf16.  N must be 8 or 16 and D
// a multiple of 16.
// The step kernel: any S >= 1; the state 16-byte aligned, a_log 8-byte, b
// and c 8-byte.
extern "C" int repro_ssm_scan_bf16(const void* x, const void* dt,
                                   const void* a_log, const void* b,
                                   const void* c, const void* state_in,
                                   void* y, void* state_out, int B, int S,
                                   int H, int D, int N, void* stream) {
  if ((N != 8 && N != 16) || D % kRows || D < kRows || S < 1 || B < 1 ||
      H < 1)
    return (int)cudaErrorInvalidValue;
  const long total = (long)B * H * D * (N / 4);
  if (total > 2147483647L - kStepThreads) return (int)cudaErrorInvalidValue;
  auto kernel = N == 16 ? ssm_scan_kernel<16> : ssm_scan_kernel<8>;
  kernel<<<(int)((total + kStepThreads - 1) / kStepThreads), kStepThreads, 0,
           (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)dt,
      (const __nv_bfloat16*)a_log, (const __nv_bfloat16*)b,
      (const __nv_bfloat16*)c, (const float*)state_in, (__nv_bfloat16*)y,
      (float*)state_out, (int)total, S, H, D);
  return (int)cudaGetLastError();
}

// The chunked kernel: the same operands, any S >= 1; x, b, c and y
// 16-byte aligned.
extern "C" int repro_ssm_chunked_bf16(const void* x, const void* dt,
                                      const void* a_log, const void* b,
                                      const void* c, const void* state_in,
                                      void* y, void* state_out, int B, int S,
                                      int H, int D, int N, void* stream) {
  if ((N != 8 && N != 16) || D % kRows || D < kRows || S < 1 || B < 1 ||
      H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  auto kernel = N == 16 ? ssm_chunked_kernel<16> : ssm_chunked_kernel<8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kChunkSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(D / kRows, H, B), kCThreads, kChunkSmem,
           (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)dt,
      (const __nv_bfloat16*)a_log, (const __nv_bfloat16*)b,
      (const __nv_bfloat16*)c, (const float*)state_in, (__nv_bfloat16*)y,
      (float*)state_out, S, H, D);
  return (int)cudaGetLastError();
}

// RWKV-6 WKV recurrence: per (batch, head), over time t,
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- exp(w_t[i]) * S[i][j] + k_t[i] * v_t[j]
// with the D x D state S in f32, taken from `state_in` and left in
// `state_out`.  Two kernels, one per shape: the wrapper
// (kernels/wkv6.py) takes the step kernel below CHUNKED_MIN_S steps (a
// decode round, S = 1) and the chunked kernel from there up (prefill).
//
// Both replace repro/kernels/wkv6.py::wkv6_pallas (_kernel).
//
// Bound on the H100: the bytes are r, k, v, w read and out written once
// (bf16) plus the state read and written once (f32); the 5 * D * D flops
// per step and head are far below the ridge.  But the time axis is a
// sequential dependence, so at B * H = 32 heads (a batch-1 prefill) few
// CTAs run and latency, not bandwidth, bounds the kernels.
//
// wkv6_kernel (the step kernel): the Pallas kernel's sequential grid axis
// becomes a loop inside one CTA per (b, h) with D = 64 threads; thread j
// keeps column j of the state in registers for the whole sequence.
// Inputs are staged kChunk steps at a time into shared memory, with
// exp(w) and u * k formed at staging, and the chunk's steps then run
// without a barrier.  One step costs a 64-long dependent loop on the CUDA
// cores (about 350 ns), which is fine for a round and slow for a prompt.
//
// wkv6_chunked_kernel (prefill): the chunked form.  Per chunk of kL = 16
// steps, with A_t = sum_{tau <= t} w_tau per key channel (A_-1 = 0),
//   out_t = (r_t . e^{A_{t-1}}) S_0 + sum_{s <= t} P[t][s] v_s,
//   P[t][s] = sum_i r_t[i] k_s[i] e^{A_{t-1}[i] - A_s[i]} (s < t),
//   P[t][t] = sum_i r_t[i] u[i] k_t[i],
//   S_L = e^{A_L} . S_0 + sum_s (k_s . e^{A_L - A_s}) (x) v_s,
// so the serial chain is 32 chunk links at S = 512 instead of 512 steps.
// Nothing bounds w below (rwkv6 makes it -exp(.)), so a chunk's decay can
// pass -88 and e^{-A} would overflow: every exponent formed here is a sum
// of w's and <= 0.  A score is factored only through a boundary between
// s and t: with z the highest power of two in t XOR s, the boundary is
// ref = (t / z) z - 1, the last step of the z-block below t's, and
// P[t][s] = (r_t e^{A_{t-1} - A_ref}) . (k_s e^{A_ref - A_s}), both
// factors <= 1.  So the 120 scores fall into four levels (z = 8, 4, 2, 1),
// each one product Q Q^T of a 16 x 64 matrix Q whose rows are those
// factors, masked to the level's pairs (at z = 1 the factor is e^0 and Q
// is r and k themselves).  Everything that multiplies goes to the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 out): the four levels, then
// out^T (16 x 16) = S^T r~^T + V^T P^T and the state update S^T += V^T k~,
// computed transposed so that the state's C fragments are the A
// fragments of the next product.  Operands that are not exact bf16 (the
// state, r~ = r . e^{A_{t-1}}, k~ = k . e^{A_L - A_s}, Q, P) are split
// into bf16 hi + lo halves and multiplied as hi.hi + hi.lo + lo.hi (P and
// k~ against the exact V: hi + lo), so the products keep about f32's
// precision over thousands of steps; the state itself stays f32 in
// registers.  Output column j depends only on state column j, so a CTA
// takes 16 value columns of one (b, h): grid (4, H, B), 128 CTAs at a
// batch-1 prefill of 32 heads.  Each CTA recomputes the chunk's decays and
// scores for its slice (r, k and w are read 4 times, from L2).  Warps 0-11
// produce a chunk's factors and scores while warp 12 runs the previous
// chunk's products and state update; raw inputs arrive by cp.async two
// chunks ahead.  The producers' three phases set a chunk's time: the
// decay sums and the diagonal; r~, k~ and the four Q (one row's 16
// columns of one array a thread, 16-byte loads and stores, 16 exp2 each);
// the four level products, a warp each.  On an H100 (chip_smoke.py) a
// 512-step prefill of 32 heads takes about 0.052 ms, 1.6 us a chunk,
// against a 0.0034 ms byte bound: the producers' phases, chiefly the
// second one's shared-memory loads (two rows of decay sums for every 16
// factors), set the time, and the chain warp's 44 mma a chunk hide
// behind them.
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

// -- the chunked kernel -------------------------------------------------------

constexpr int kL = 16;                 // steps per chunk: one k16 mma step
constexpr int kSlice = 16;             // value columns per CTA
constexpr int kSlices = kD / kSlice;   // CTAs per (b, h)
constexpr int kProducers = 384;        // warps 0-11: factors and scores
constexpr int kCThreads = kProducers + 32;  // + warp 12: the state chain
constexpr int kRawStages = 3;          // chunks c, c + 1, c + 2 in flight
constexpr int kLdA = kD + 8;     // bf16 row stride of 64-wide tiles (144 B)
constexpr int kLdP = kL + 8;     // bf16 row stride of 16-wide tiles (48 B)
// The decay sums, f32: column c at c + 4 (c / 32), row stride kLdB.  The
// gap and the stride put the 16-byte loads of a quarter-warp (4 column
// groups of 2 rows) in distinct banks.
constexpr int kLdB = kD + 8;
__device__ __forceinline__ int bsum_col(int c) { return c + 4 * (c >> 5); }
constexpr int kLevels = 4;             // score levels z = 8, 4, 2, 1
static_assert((2 + kLevels) * kL * (kD / 16) == kProducers,
              "one thread a row's 16 columns of r~, k~ and each level's Q");
static_assert(kLevels * 32 <= kProducers && (kL >> kLevels) == 1,
              "a warp a level; the levels reach single steps");

// Shared memory, in bytes.  A raw stage: r, k, w (kL x kLdA bf16) and the
// CTA's v columns (kL x kSlice bf16), as they arrive.  A derived buffer:
// r~ and k~ as hi and lo halves (kL x kLdA bf16 each), P as hi and lo
// halves (kL x kLdP), the v columns (kL x kLdP) and e^{A_L} (kD f32).
constexpr int kTileA = kL * kLdA * 2;
constexpr int kTileP = kL * kLdP * 2;
constexpr int kRawBytes = 3 * kTileA + kL * kSlice * 2;
constexpr int kDerivedBytes = 4 * kTileA + 3 * kTileP + kD * 4;
constexpr int kChunkSmem = kRawStages * kRawBytes + 2 * kDerivedBytes +
                           kL * kLdB * 4 + kD * 4 + kTileP +
                           (2 * kLevels - 1) * kTileA;

__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kProducers) : "memory");
}

// 8 floats (two 16-byte loads).
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

__global__ void __launch_bounds__(kCThreads) wkv6_chunked_kernel(
    const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ u, const float* __restrict__ state_in,
    __nv_bfloat16* __restrict__ out, float* __restrict__ state_out, int S,
    int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* raw_base = smem_raw;
  unsigned char* der_base = raw_base + kRawStages * kRawBytes;
  float* bsum = reinterpret_cast<float*>(der_base + 2 * kDerivedBytes);
  float* u_sm = bsum + kL * kLdB;
  __nv_bfloat16* o_sm = reinterpret_cast<__nv_bfloat16*>(u_sm + kD);
  // The levels' Q (kL x kLdA bf16): hi halves of levels 0-3, then lo
  // halves of levels 0-2 (level 3's Q is r and k themselves, exact).
  __nv_bfloat16* q_sm = o_sm + kL * kLdP;
  auto q_hi = [&](int lev) { return q_sm + lev * kL * kLdA; };
  auto q_lo = [&](int lev) { return q_sm + (kLevels + lev) * kL * kLdA; };

  struct Raw {
    __nv_bfloat16 *r, *k, *w, *v;
  };
  struct Derived {
    __nv_bfloat16 *rhi, *rlo, *khi, *klo, *phi, *plo, *v;
    float* decay;
  };
  auto raw_at = [&](int c) {
    auto* p = reinterpret_cast<__nv_bfloat16*>(raw_base +
                                               (c % kRawStages) * kRawBytes);
    return Raw{p, p + kL * kLdA, p + 2 * kL * kLdA, p + 3 * kL * kLdA};
  };
  auto derived_at = [&](int c) {
    auto* p = reinterpret_cast<__nv_bfloat16*>(der_base +
                                               (c % 2) * kDerivedBytes);
    auto* pp = p + 4 * kL * kLdA;
    return Derived{p, p + kL * kLdA, p + 2 * kL * kLdA, p + 3 * kL * kLdA,
                   pp, pp + kL * kLdP, pp + 2 * kL * kLdP,
                   reinterpret_cast<float*>(pp + 3 * kL * kLdP)};
  };

  const int j0 = blockIdx.x * kSlice, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const bool chain = tid >= kProducers;
  const long step = (long)H * kD;                   // elements per time step
  const long seq = ((long)b * S * H + h) * kD;      // (b, t = 0, h, 0)
  const int n_chunks = (S + kL - 1) / kL;

  // Chunk c's raw rows into its stage, one 16-byte piece a thread of r
  // (threads 0-127), k (128-255) or w (256-383), and of the v columns
  // (256-287); rows past S zero-filled.
  auto issue = [&](int c) {
    if (c < n_chunks) {
      const Raw rw = raw_at(c);
      const int x = tid & 127, row = x >> 3, col = (x & 7) * 8;
      const int t = c * kL + row;
      const bool ok = t < S;
      const long src = seq + (ok ? t * step : 0) + col;
      const int which = tid >> 7;  // 0 r, 1 k, 2 w
      cp_async16((which == 0 ? rw.r : which == 1 ? rw.k : rw.w) +
                     row * kLdA + col,
                 (which == 0 ? r : which == 1 ? k : w) + src, ok);
      if (which == 2 && x < 2 * kL) {
        const int vr = x >> 1, vc = (x & 1) * 8;
        const int tv = c * kL + vr;
        const bool vok = tv < S;
        cp_async16(rw.v + vr * kSlice + vc,
                   v + seq + (vok ? tv * step : 0) + j0 + vc, vok);
      }
    }
    cp_async_commit();
  };

  // The chain warp's state: S^T (16 value columns x 64 key rows) as the C
  // fragments of 8 n8 tiles: st[nt][2 hh + e] is S[i][j0 + j] with
  // i = 8 nt + 2 tig + e, j = gid + 8 hh.
  const int gid = lane >> 2, tig = lane & 3;
  float st[8][4];
  const long s_off = ((long)b * H + h) * kD * kD + j0;
  if (chain) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[nt][e] = state_in[s_off + (8 * nt + 2 * tig + (e & 1)) * kD +
                             gid + 8 * (e >> 1)];
  } else {
    // Scores above the diagonal stay zero in both derived buffers.
    for (int x = tid; x < 2 * 2 * kL * kLdP; x += kProducers) {
      const Derived d = derived_at(x / (2 * kL * kLdP));
      d.phi[x % (2 * kL * kLdP)] = __float2bfloat16(0.f);
    }
    if (tid < kD) u_sm[tid] = bf2f(u[h * kD + tid]);
    issue(0);
    issue(1);
  }
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    if (!chain) {
      // -- producers: chunk c's factors and scores into derived[c % 2] --
      issue(c + 2);
      cp_async_wait<2>();  // chunk c has landed (this thread's copies)
      producers_sync();
      const Raw rw = raw_at(c);
      const Derived d = derived_at(c);
      if (tid < kD) {
        // Column i's running decay sums (log2 units) and e^{A_L}.
        const int i = tid;
        float wl[kL];
#pragma unroll
        for (int t = 0; t < kL; ++t)
          wl[t] = bf2f(rw.w[t * kLdA + i]) * REPRO_LOG2E;
        float a = 0.f;
#pragma unroll
        for (int t = 0; t < kL; ++t) {
          a += wl[t];
          bsum[t * kLdB + bsum_col(i)] = a;
        }
        d.decay[i] = exp2_ftz(a);
      } else if (tid < 2 * kD) {
        // The diagonal: P[t][t] = sum_i r_t[i] u[i] k_t[i], four threads a
        // row, 16 columns each, summed by two shuffles.
        const int y = tid - kD, t = y >> 2, c0 = (y & 3) * 16;
        float rf[16], kf[16], uf[16];
        unpack8(*reinterpret_cast<const uint4*>(rw.r + t * kLdA + c0), rf);
        unpack8(*reinterpret_cast<const uint4*>(rw.r + t * kLdA + c0 + 8),
                rf + 8);
        unpack8(*reinterpret_cast<const uint4*>(rw.k + t * kLdA + c0), kf);
        unpack8(*reinterpret_cast<const uint4*>(rw.k + t * kLdA + c0 + 8),
                kf + 8);
        load8(u_sm + c0, uf);
        load8(u_sm + c0 + 8, uf + 8);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int x = 0; x < 16; ++x)
          acc[x & 3] = fmaf(rf[x] * uf[x], kf[x], acc[x & 3]);
        float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (!(y & 3))
          split_store(sum, d.phi + t * kLdP + t, d.plo + t * kLdP + t);
      } else if (tid < 2 * kD + 2 * kL) {  // the v columns, for the chain
        const int vr = (tid - 2 * kD) >> 1, vc = (tid & 1) * 8;
        *reinterpret_cast<uint4*>(d.v + vr * kLdP + vc) =
            *reinterpret_cast<const uint4*>(rw.v + vr * kSlice + vc);
      }
      producers_sync();  // bsum is complete
      {
        // One row's 16 columns of one factor array a thread, as bf16 hi
        // and lo halves: x . 2^(B[hi] - B[lo]) with x = r or k of the
        // row, B the decay sums (B[-1] = 0), every exponent <= 0:
        //   r~ (a = 0): r_t e^{A_{t-1}};  k~ (a = 1): k_s e^{A_L - A_s};
        //   Q of level lev = a - 2 (blocks of z = 8 >> lev rows): a row
        //   in an odd block is r_t e^{A_{t-1} - A_ref}, ref the last step
        //   of the block below; a row in an even block is
        //   k_s e^{A_ref - A_s}, ref the last step of its own block.
        const int a = tid >> 6, row = (tid & 63) >> 2, c0 = (tid & 3) * 16;
        bool use_k = a == 1;
        int hi = a == 1 ? kL - 1 : row - 1, lo = a == 1 ? row : -1;
        if (a >= 2) {
          const int z = 8 >> (a - 2), blk = row / z;
          use_k = !(blk & 1);
          hi = use_k ? blk * z + z - 1 : row - 1;
          lo = use_k ? row : blk * z - 1;
        }
        const __nv_bfloat16* src = (use_k ? rw.k : rw.r) + row * kLdA + c0;
        const uint4 x0 = reinterpret_cast<const uint4*>(src)[0];
        const uint4 x1 = reinterpret_cast<const uint4*>(src)[1];
        __nv_bfloat16* dh = (a == 0 ? d.rhi : a == 1 ? d.khi : q_hi(a - 2)) +
                            row * kLdA + c0;
        if (a == 2 + kLevels - 1) {
          // Level 3: every factor is e^0 = 1, so Q is r or k itself.
          reinterpret_cast<uint4*>(dh)[0] = x0;
          reinterpret_cast<uint4*>(dh)[1] = x1;
        } else {
          float val[16], e[16], eh[8], el[8];
          unpack8(x0, val);
          unpack8(x1, val + 8);
          const int bc = bsum_col(c0);
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            if (hi >= 0) load8(bsum + hi * kLdB + bc + 8 * g, eh);
            if (lo >= 0) load8(bsum + lo * kLdB + bc + 8 * g, el);
#pragma unroll
            for (int y = 0; y < 8; ++y)
              e[8 * g + y] = (hi >= 0 ? eh[y] : 0.f) - (lo >= 0 ? el[y] : 0.f);
          }
          unsigned wh[8], wl[8];
#pragma unroll
          for (int y = 0; y < 8; ++y)
            split_pack(val[2 * y] * exp2_ftz(e[2 * y]),
                       val[2 * y + 1] * exp2_ftz(e[2 * y + 1]), wh[y], wl[y]);
          __nv_bfloat16* dl = (a == 0 ? d.rlo : a == 1 ? d.klo : q_lo(a - 2)) +
                              row * kLdA + c0;
          reinterpret_cast<uint4*>(dh)[0] = make_uint4(wh[0], wh[1], wh[2], wh[3]);
          reinterpret_cast<uint4*>(dh)[1] = make_uint4(wh[4], wh[5], wh[6], wh[7]);
          reinterpret_cast<uint4*>(dl)[0] = make_uint4(wl[0], wl[1], wl[2], wl[3]);
          reinterpret_cast<uint4*>(dl)[1] = make_uint4(wl[4], wl[5], wl[6], wl[7]);
        }
      }
      producers_sync();  // the factor arrays are complete
      if (tid < kLevels * 32) {
        // Warp lev: the scores of level z = 8 >> lev, P = Q Q^T on the
        // tensor cores (A = Q through ldmatrix, B = Q^T through ldmatrix
        // from the same rows), kept where the highest bit of t XOR s is z
        // and s < t: each score below the diagonal belongs to one level.
        const int lev = tid >> 5, z = 8 >> lev;
        const bool exact = lev == kLevels - 1;  // Q without a lo half
        const int arow = lane & 15, acol = (lane >> 4) * 8;
        const int brow = (lane & 7) + ((lane >> 4) << 3);
        const int bcol = ((lane >> 3) & 1) * 8;
        float acc[3][2][4] = {};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          unsigned ah[4], bh[4];
          ldmatrix_x4(ah, q_hi(lev) + arow * kLdA + 16 * kk + acol);
          ldmatrix_x4(bh, q_hi(lev) + brow * kLdA + 16 * kk + bcol);
          mma_bf16(acc[0][0], ah, bh[0], bh[1]);
          mma_bf16(acc[0][1], ah, bh[2], bh[3]);
          if (!exact) {
            unsigned al[4], bl[4];
            ldmatrix_x4(al, q_lo(lev) + arow * kLdA + 16 * kk + acol);
            ldmatrix_x4(bl, q_lo(lev) + brow * kLdA + 16 * kk + bcol);
            mma_bf16(acc[1][0], ah, bl[0], bl[1]);
            mma_bf16(acc[1][1], ah, bl[2], bl[3]);
            mma_bf16(acc[2][0], al, bh[0], bh[1]);
            mma_bf16(acc[2][1], al, bh[2], bh[3]);
          }
        }
        const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = gid + 8 * (e >> 1), s2 = 8 * nt + 2 * tig + (e & 1);
            const int x = t ^ s2;
            if (t > s2 && x >= z && x < 2 * z)
              split_store(acc[0][nt][e] + (acc[1][nt][e] + acc[2][nt][e]),
                          d.phi + t * kLdP + s2, d.plo + t * kLdP + s2);
          }
      }
    }
    __syncthreads();  // derived[c % 2] is complete; derived[(c+1) % 2] free
    if (chain) {
      // -- the chain warp: chunk c's products and state update --
      const Derived d = derived_at(c);
      // The old state as A fragments of S^T (hi, lo): two adjacent n8 C
      // tiles are one k16 A fragment.
      unsigned ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          split_pack(st[2 * kk + (x >> 1)][2 * (x & 1)],
                     st[2 * kk + (x >> 1)][2 * (x & 1) + 1], ahi[kk][x],
                     alo[kk][x]);
      // A = V^T (j x s) through ldmatrix.trans from v (s rows, j
      // contiguous); it serves P . V and the state update.
      unsigned va[4];
      ldmatrix_x4_trans(va, d.v + ((lane & 7) + ((lane >> 4) << 3)) * kLdP +
                                ((lane >> 3) & 1) * 8);
      // The state update first (it alone carries to the next chunk):
      // S^T <- S^T . e^{A_L} (per key row i) + V^T k~ (hi, lo), B = k~
      // through ldmatrix.trans from k~ (s rows, i contiguous).
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 dec =
            *reinterpret_cast<const float2*>(d.decay + 8 * nt + 2 * tig);
        st[nt][0] *= dec.x;
        st[nt][1] *= dec.y;
        st[nt][2] *= dec.x;
        st[nt][3] *= dec.y;
      }
      const int krow = (lane & 7) + (((lane >> 3) & 1) << 3);
      const int kcol = (lane >> 4) * 8;
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        unsigned bh[4], bl[4];
        ldmatrix_x4_trans(bh, d.khi + krow * kLdA + 16 * pr + kcol);
        ldmatrix_x4_trans(bl, d.klo + krow * kLdA + 16 * pr + kcol);
        mma_bf16(st[2 * pr], va, bh[0], bh[1]);
        mma_bf16(st[2 * pr + 1], va, bh[2], bh[3]);
        mma_bf16(st[2 * pr], va, bl[0], bl[1]);
        mma_bf16(st[2 * pr + 1], va, bl[2], bl[3]);
      }
      // out^T = S^T r~^T (B = r~^T through ldmatrix from r~: t rows, i
      // contiguous) + V^T P^T (B = P^T from P: t rows), in four
      // independent accumulators (hi.hi, hi.lo, lo.hi, P) so that no mma
      // waits on more than four before it.
      const int brow = (lane & 7) + ((lane >> 4) << 3);
      const int bcol = ((lane >> 3) & 1) * 8;
      float o[4][2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        unsigned bh[4], bl[4];
        ldmatrix_x4(bh, d.rhi + brow * kLdA + 16 * kk + bcol);
        ldmatrix_x4(bl, d.rlo + brow * kLdA + 16 * kk + bcol);
        mma_bf16(o[0][0], ahi[kk], bh[0], bh[1]);
        mma_bf16(o[0][1], ahi[kk], bh[2], bh[3]);
        mma_bf16(o[1][0], ahi[kk], bl[0], bl[1]);
        mma_bf16(o[1][1], ahi[kk], bl[2], bl[3]);
        mma_bf16(o[2][0], alo[kk], bh[0], bh[1]);
        mma_bf16(o[2][1], alo[kk], bh[2], bh[3]);
      }
      {
        unsigned ph[4], pl[4];
        ldmatrix_x4(ph, d.phi + brow * kLdP + bcol);
        ldmatrix_x4(pl, d.plo + brow * kLdP + bcol);
        mma_bf16(o[3][0], va, ph[0], ph[1]);
        mma_bf16(o[3][1], va, ph[2], ph[3]);
        mma_bf16(o[3][0], va, pl[0], pl[1]);
        mma_bf16(o[3][1], va, pl[2], pl[3]);
      }
      // out: C element (j = gid + 8 hh, t = 8 nt + 2 tig + e), through
      // shared memory to one 16-byte store a lane; rows past S dropped.
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o_sm[(8 * nt + 2 * tig + (e & 1)) * kLdP + gid + 8 * (e >> 1)] =
              __float2bfloat16((o[0][nt][e] + o[1][nt][e]) +
                               (o[2][nt][e] + o[3][nt][e]));
      __syncwarp();
      {
        const int t = c * kL + (lane >> 1), col = (lane & 1) * 8;
        if (t < S)
          *reinterpret_cast<uint4*>(out + seq + t * step + j0 + col) =
              *reinterpret_cast<const uint4*>(o_sm + (lane >> 1) * kLdP +
                                              col);
      }
      __syncwarp();  // o_sm is rewritten by the next chunk
    }
  }
  if (chain) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        state_out[s_off + (8 * nt + 2 * tig + (e & 1)) * kD + gid +
                  8 * (e >> 1)] = st[nt][e];
  } else {
    cp_async_wait<0>();
  }
}

}  // namespace

// r, k, v, w: (B, S, H, D) bf16; u: (H, D) bf16; state_in, state_out:
// two (B, H, D, D) f32 buffers; out: (B, S, H, D) bf16.  D must be 64.
// The step kernel: any S >= 1.
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

// The chunked kernel: the same operands, any S >= 1; r, k, v, w and out
// 16-byte aligned.
extern "C" int repro_wkv6_chunked_bf16(const void* r, const void* k,
                                       const void* v, const void* w,
                                       const void* u, const void* state_in,
                                       void* out, void* state_out, int B,
                                       int S, int H, int D, void* stream) {
  if (D != kD || S < 1 || B < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kChunkSmem);
  if (err != cudaSuccess) return (int)err;
  wkv6_chunked_kernel<<<dim3(kSlices, H, B), kCThreads, kChunkSmem,
                        (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)r, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)w,
      (const __nv_bfloat16*)u, (const float*)state_in, (__nv_bfloat16*)out,
      (float*)state_out, S, H);
  return (int)cudaGetLastError();
}

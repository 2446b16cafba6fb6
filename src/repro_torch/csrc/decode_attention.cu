// Single-token GQA decode attention: dense padded cache and block-paged
// cache, over bf16 K/V or int8 codes with per-(row, kv head) bf16 scales.
//
// Replaces repro/kernels/decode_attention.py::decode_attention_pallas
// (_kernel), ::paged_decode_attention_pallas (_paged_kernel),
// ::decode_attention_quant_pallas (_kernel_q8) and
// ::paged_decode_attention_quant_pallas (_paged_kernel_q8).
//
// Bound on the H100: bytes.  Each (sequence, kv head) streams its K and V
// rows once (2 * cache_len * D * 2 bytes in bf16, half that plus 4 bytes of
// scales per row in int8) for 2 * G * D flops per row, far below the ~295
// flop/byte ridge.  So the kernels must keep many bytes in flight and add
// little latency per row.  A CTA per (kv head, b, split of S) holds all G
// query heads of its kv head, so every K/V row leaves HBM once for the
// whole group, and the split of S (flash-decoding) puts B * K * n_split
// CTAs in flight instead of B * K.  The dense kernels stop at
// min(cache_len, S) (a free continuous slot keeps advancing its position
// past S) and start at the window edge; the paged kernels read their own
// block-table row and only the sequence's own pages.  Rows are walked in
// tiles of 16 logical rows whatever the page size, and the G heads (up to
// 16) are the rows of one mma.sync m16n8k16 A fragment (padded with zero
// rows to 16): the online softmax on the C fragments
// (attention_common.cuh), P kept in registers as the A fragment of P . V.
// The products stay on mma.sync: a wgmma tile is 64 rows, at least 4x the
// G <= 16 heads, and tensor work does not set the pace of a kernel bound
// by bytes.
//
// All four kernels are one launch a call and one body (decode_split) over
// two row sources (dense, paged) and two element kinds (bf16; int8 codes
// with scales).  What a byte-bound kernel loses is time with nothing in
// flight and work outside the stream of K/V bytes; the design takes both
// away.
//   - TMA loads into an mbarrier ring.  A producer warp issues each tile
//     as TMA boxes (4-d tensor maps: (D, KV, S, B) dense, (D, KV, bs, N)
//     paged; bf16 boxes of box_cols(D) dims, int8 boxes of a whole row of
//     D codes, each swizzled to its row bytes, none at 16 bytes) into a
//     ring of up to 16 stages and 64 KB, sized to the CTA's tile count,
//     so at the main shape the CTA's whole share is in flight from its
//     first instruction.  Each stage has a full barrier
//     (the producer's arrival and the tile's bytes) and an empty one (its
//     consumer's release).  The producer computes every address: the
//     consumers spend no instruction on one.  Rows at or past S, past the
//     block table or on an entry outside [0, N) come from TMA as zeros
//     (the coordinates go to TMA as they are) and are masked through a
//     mask the producer leaves beside the stage.  A paged tile is 16 / g
//     boxes of g = gcd(bs, 16) rows, each within one page, at 128-byte
//     aligned pitches (TMA's alignment of a shared destination); the
//     producer warp reads the block table in coalesced windows of 256
//     entries, the first in flight beside cache_len, each entry once (at
//     most one twice, where two windows meet), and walks its rows' pages
//     without a division, so no row waits on its table entry.
//   - int8 scales off the chain.  The scales, strided by KV (8 bytes a row
//     at 4 kv heads, not the 16 a tensor map's strides need), come through
//     the producer warp too: behind a tile's boxes, lane r copies row r's
//     K and V scale, each as the aligned 4-byte word that holds it, by
//     cp.async into the stage's slots in the header (zeros for a row not
//     stored), and its copies are one arrival on the stage's full barrier
//     once they land (cp.async.mbarrier.arrive.noinc: the barrier counts
//     the producer's arrival and the 16 lanes').  The producer never waits
//     on a load; which half of a word is the scale goes beside the stage
//     as a bit.
//   - Four consumer warps take the CTA's tiles round-robin in a fixed
//     order, each with its own online softmax, the query heads' A
//     fragments read by ldmatrix from a query tile in shared memory (in
//     registers they would leave room for two CTAs an SM, not three).  A
//     bf16 warp reads the K/V boxes by ldmatrix (.trans for V) at
//     addresses XORed to their swizzle (conflict-free, as the old 16-byte
//     row pad was).  An int8 warp widens the codes in registers, straight
//     into the B fragments, to bf16(code * scale) bit for bit as computed
//     in f32: the dequantize of ops.decode_attention_quant and of the
//     port's plain version, so the int8 kernels differ from it only as
//     the bf16 ones do.  Two codes at a time, with integer masks and two
//     bf16x2 operations (exact, then one rounding), and no conversion
//     instruction: F2FP, a quarter-rate unit, was what the first version
//     waited on.  No widened tile goes through shared memory.  A lane
//     loads, of its two K rows, the D / 4 codes from dim tig * D / 4 on
//     (a k16 block's B fragment is a word of them; the dims stand in the
//     query tile in that order), and of its four V rows the D / 8 codes
//     from dim gid * D / 8 on (n8 block j of the output holds dims
//     c * D / 8 + j, put in place as the output is written); the reads
//     are conflict-free at pages of 16 rows, but V's at D = 32 and 64.
//     Then the warps merge in warp order through the ring's bytes.
//   - The splits of S merge inside a thread block cluster: the n_split
//     CTAs of one (b, kv head) are one cluster (at most 16, past the
//     portable 8; the plan keeps the clusters to one wave of about two
//     CTAs an SM).  Each CTA leaves its merged (m, l, acc) in its own
//     shared memory; after a cluster barrier every CTA loads, for its
//     share of the G x D outputs, every split's partial through
//     distributed shared memory at once, forms the weights in rank order
//     as every CTA does, and writes its share.  A second, relaxed barrier
//     keeps each CTA's shared memory until its peers have loaded from it.
//     A CTA with no rows still passes both barriers with (-inf, 0, 0).
//     No combine kernel, no partials in HBM.
//
// Built for D = 16, 32, 64 and 128.  Since tiles, their warps, the split
// and both merges depend on logical rows alone, a dense and a paged
// kernel give bit-identical outputs on identical K/V (or codes and
// scales) for every page size with M * bs = S, and a launch holding some
// of the kv heads, planned as the whole launch (the same tiles a split),
// gives those heads the whole launch's bits.  Scores are scaled in f32
// after the dot; P is rounded to bf16 for P . V (at most 2^-8 relative
// per weight).
#include <atomic>
#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxG = 16;  // query heads per kv head: the A fragment's rows
constexpr int kMaxT = 64;  // rows per page of the paged kernels
constexpr int kTile = 16;  // logical rows per tile: one mma n16 step

// Raises a kernel's dynamic shared-memory limit to `smem` bytes and allows
// clusters past the portable 8 CTAs: once a device, not on every call.
template <auto Kernel>
cudaError_t once_per_device(int smem) {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> ready[kMaxDevices];  // false: not set yet
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) ready[dev].store(true, std::memory_order_release);
  return err;
}

constexpr int kWarps = 4;                    // consumer warps
constexpr int kThreads = 32 * (kWarps + 1);  // and the producer warp
constexpr int kMaxCluster = 16;  // splits of one (b, kv head): its cluster
constexpr int kMaxStages = 16;   // tiles in flight at most ...
constexpr int kRingBytes = 64 * 1024;  // ... and their bytes
constexpr int kTbl = 256;  // block-table entries the producer holds at once
// CTAs per SM asked of ptxas: 3, so that a cluster of every (b, kv head)
// at the main shape fits the SMs in one wave.
constexpr int kMinCtas = 3;

// Element kinds of the K/V rows: bf16, or int8 codes with one bf16 scale
// per (row, kv head), whose bits are laid out as the codes with D = 1.
struct Bf16KV {
  static constexpr bool kQ8 = false;
};

struct Q8KV {
  static constexpr bool kQ8 = true;
  const unsigned short* ks;
  const unsigned short* vs;
};

// Shared memory: a header, then (1024-aligned) the ring, whose bytes the
// merges reuse (the warps' partials, then the CTA's that its cluster
// reads), then the query tile.  The header: full barriers [kMaxStages],
// empty barriers, the stages' stored-row masks, the stages' odd-scale
// bits (int8: bit r, and r + 16 for V, when row r's scale is the high
// half of its word), the scales' words [kMaxStages][kTile][2] (int8: K,
// V), the producer's block-table window.  Under 75 KB at every G, so
// three CTAs fit an SM.
constexpr int kHdrEmpty = 8 * kMaxStages;
constexpr int kHdrMasks = kHdrEmpty + 8 * kMaxStages;
constexpr int kHdrOdds = kHdrMasks + 4 * kMaxStages;
constexpr int kHdrScales = kHdrOdds + 4 * kMaxStages;
constexpr int kHdrTbl = kHdrScales + 8 * kTile * kMaxStages;
constexpr int kHdrUsed = kHdrTbl + 4 * kTbl;
constexpr int kHdrBytes = kHdrUsed + 1024;  // and the ring's alignment

// A ring box's row bytes and the boxes of a tile's K (or V): bf16 rows in
// boxes of box_cols(D) dims, an int8 row of D codes in one box.
template <int D, bool Q8>
__host__ __device__ constexpr int ring_row_bytes() {
  return Q8 ? D : box_row_bytes(D);
}

template <int D, bool Q8>
__host__ __device__ constexpr int ring_boxes() {
  return Q8 ? 1 : D / box_cols(D);
}

// Rows a TMA box of one page holds: g = gcd(bs, 16), so a box never
// crosses a page and a tile is 16 / g boxes.
__host__ __device__ inline int piece_rows(int bs) {
  int g = kTile;
  while (bs % g) g >>= 1;
  return g;
}

// Bytes from one piece of g rows to the next in a box column of a stage:
// its rows, but at least the 128 bytes TMA aligns a shared destination
// to.  Every box base stays a multiple of its swizzle's repeat.
template <int D, bool Q8>
__host__ __device__ inline int piece_pitch(int g) {
  const int bytes = g * ring_row_bytes<D, Q8>();
  return bytes < 128 ? 128 : bytes;
}

// One box column of a tile (16 rows), a stage (the K tile's boxes, then
// the V tile's), the ring.
template <int D, bool Q8>
__host__ __device__ inline int tile_box_bytes(int g) {
  return kTile / g * piece_pitch<D, Q8>(g);
}

template <int D, bool Q8>
__host__ __device__ inline int stage_bytes(int g) {
  return 2 * ring_boxes<D, Q8>() * tile_box_bytes<D, Q8>(g);
}

// Stages for a CTA of `per` tiles: one for each, up to kMaxStages and
// kRingBytes.  A ring shorter than the CTA's tiles is a multiple of the 4
// consumer warps, so every use of a stage goes to one warp, which waits
// for the stage's uses in order: a warp waiting on a full barrier's
// parity two uses ahead would pass it at the use before.  (Every cap here
// is at least 8.)
template <int D, bool Q8>
int ring_stages(int per, int g) {
  int cap = kRingBytes / stage_bytes<D, Q8>(g);
  if (cap > kMaxStages) cap = kMaxStages;
  return per <= cap ? per : cap / kWarps * kWarps;
}

// The merges' bytes over the ring: the warps' partials [kWarps][G][D +
// 2] f32, then the CTA's [G][D + 2] (its cluster's reads).  The query
// tile [16][D + 8] bf16 lies past them: the A fragment's rows, padded 16
// bytes for ldmatrix without bank conflicts.
template <int D>
__host__ __device__ inline int warp_merge_bytes(int G) {
  return kWarps * G * (D + 2) * (int)sizeof(float);
}

template <int D>
__host__ __device__ inline int merge_bytes(int G) {  // 128-byte multiple
  return (warp_merge_bytes<D>(G) + G * (D + 2) * (int)sizeof(float) + 127) &
         ~127;
}

template <int D>
__host__ __device__ constexpr int q_tile_bytes() {
  return kMaxG * (D + 8) * (int)sizeof(__nv_bfloat16);
}

template <int D, bool Q8>
int smem_bytes(int stages, int G, int g) {
  const int ring = stages * stage_bytes<D, Q8>(g);
  const int merge = merge_bytes<D>(G);
  return kHdrBytes + (ring > merge ? ring : merge) + q_tile_bytes<D>();
}

// The most a launch can ask (the ring at kRingBytes, kMaxG heads).
template <int D>
int max_smem() {
  const int merge = merge_bytes<D>(kMaxG);
  return kHdrBytes + (kRingBytes > merge ? kRingBytes : merge) +
         q_tile_bytes<D>();
}

// The tiles of one (b, kv head) of a dense (B, S, KV, D) cache: live
// rows [lo, hi), the window start to min(cache_len, S); row r's box is at
// (r, b) of the (D, KV, S, B) map, zeros past S.
struct DenseTiles {
  static constexpr bool kPaged = false;
  int S, b, lo, hi;
};

// ... of (N, bs, KV, D) pages through the sequence's block-table row:
// live rows [0, min(cache_len, M * bs)); row r's box is at (r % bs,
// table[r / bs]) of the (D, KV, bs, N) map.  A row past the table or on
// an entry outside [0, N) reads zeros and is masked.
struct PagedTiles {
  static constexpr bool kPaged = true;
  const int* table;
  int M, bs, N, lo, hi;
};

// The producer warp's window of a sequence's block-table entries from
// `first` on, kTbl at most, read into `tbl` in one coalesced pass;
// returns the window's end.
__device__ __forceinline__ int table_window(const PagedTiles& rows, int* tbl,
                                            int first, int lane) {
  __syncwarp();  // every lane is done with the last window
  const int end = min(rows.M, first + kTbl);
  for (int e = lane; e < end - first; e += 32)
    tbl[e] = __ldg(rows.table + first + e);
  __syncwarp();
  return end;
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Scores of one 16-row K tile in swizzled bf16 boxes of `box_bytes`, the
// A fragments read by ldmatrix from the query tile: `q_lane` is this
// lane's address there (row lane & 15, dims + 8 for lanes 16-31), `row`
// the byte offset in a box of the K row this lane addresses (keys lane &
// 7, + 8 for lanes 16-31), `x` its swizzle_xor.
template <int D>
__device__ __forceinline__ void tile_scores(uint32_t q_lane, uint32_t k_tile,
                                            int box_bytes, uint32_t row,
                                            uint32_t x, float (&s)[2][4]) {
  constexpr int kCols = box_cols(D);
  const uint32_t half = (threadIdx.x >> 3) & 1;  // dims +0..7 or +8..15
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t chunk = (16 * kk % kCols / 8 + half) * 16;
    unsigned qa[4], bk[4];
    ldsm_x4(qa, q_lane + 32 * kk);
    ldsm_x4(bk, k_tile + 16 * kk / kCols * box_bytes + row + (chunk ^ x));
    mma_bf16(s[0], qa, bk[0], bk[1]);
    mma_bf16(s[1], qa, bk[2], bk[3]);
  }
}

// o += P . V over one 16-row V tile in swizzled bf16 boxes: `row` is the
// byte offset of this lane's row (keys lane & 7, + 8 for lanes 8-15 and
// 24-31), `x` its swizzle_xor.
template <int D>
__device__ __forceinline__ void tile_values(const float (&p)[2][4],
                                            uint32_t v_tile, int box_bytes,
                                            uint32_t row, uint32_t x,
                                            float (&o)[D / 8][4]) {
  constexpr int kCols = box_cols(D);
  const uint32_t half = (threadIdx.x >> 4) & 1;  // dims +0..7 or +8..15
  const unsigned a[4] = {pack_bf16(p[0][0], p[0][1]),
                         pack_bf16(p[0][2], p[0][3]),
                         pack_bf16(p[1][0], p[1][1]),
                         pack_bf16(p[1][2], p[1][3])};
#pragma unroll
  for (int dd = 0; dd < D / 16; ++dd) {
    const uint32_t chunk = (16 * dd % kCols / 8 + half) * 16;
    unsigned bv[4];
    ldsm_x4_trans(bv,
                  v_tile + 16 * dd / kCols * box_bytes + row + (chunk ^ x));
    mma_bf16(o[2 * dd], a, bv[0], bv[1]);
    mma_bf16(o[2 * dd + 1], a, bv[2], bv[3]);
  }
}

// The bf16 bits of row r's scale in a stage (K: kv 0, V: 1): its word
// in the stage's slots `sc`, the half `odd` names.
__device__ __forceinline__ unsigned row_scale(const unsigned* sc,
                                              unsigned odd, int r, int kv) {
  const unsigned w = sc[2 * r + kv];
  return (odd >> (r + 16 * kv)) & 1u ? w >> 16 : w & 0xffffu;
}

// Two int8 codes, byte b0 of w0 and byte b1 of w1, times the bf16 scales
// in the halves of `s2`, as packed bf16(code * scale), b0's in the low
// half.  A code c is a bf16 without a conversion: its low 7 bits m under
// the exponent of 2^7 is 128 + m, and adding -128 (c >= 0) or -256 (its
// top bit set) gives c exactly.  The bf16 product of c and the scale is
// rounded once from the exact one, so it is the plain version's
// bf16(c * scale) computed in f32, bit for bit.
__device__ __forceinline__ unsigned widen2(unsigned w0, int b0, unsigned w1,
                                           int b1, unsigned s2) {
  const unsigned t = __byte_perm(w0, w1, b0 | (4 + b1) << 8);
  const unsigned m = (t & 0x007f007fu) | 0x43004300u;
  const unsigned k = (t & 0x00800080u) | 0xc300c300u;
  unsigned c, out;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(c) : "r"(m), "r"(k));
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(out) : "r"(c), "r"(s2));
  return out;
}

// N bytes (2-32) of a row of int8 codes from byte `at` (a multiple of
// min(N, 16)) of the row at `row`, its 16-byte pieces XORed by `x` (the
// row's swizzle_xor), as words.
template <int N>
__device__ __forceinline__ void load_codes(const unsigned char* row, int at,
                                           uint32_t x,
                                           unsigned (&w)[(N + 3) / 4]) {
  auto piece = [&](int a) { return row + ((a & ~15) ^ x) + (a & 15); };
  if constexpr (N >= 16) {
#pragma unroll
    for (int c = 0; c < N / 16; ++c) {
      const uint4 v = *reinterpret_cast<const uint4*>(piece(at + 16 * c));
      w[4 * c] = v.x, w[4 * c + 1] = v.y, w[4 * c + 2] = v.z,
      w[4 * c + 3] = v.w;
    }
  } else if constexpr (N == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(piece(at));
    w[0] = v.x, w[1] = v.y;
  } else if constexpr (N == 4) {
    w[0] = *reinterpret_cast<const unsigned*>(piece(at));
  } else {
    w[0] = *reinterpret_cast<const unsigned short*>(piece(at));
  }
}

// Scores of one 16-row tile of int8 K codes, widened into the B
// fragments in registers: n8 tile h's keys are rows gid + 8 h (at byte
// `row[h]` of the box, swizzle_xor `x[h]`), of which the lane loads the
// D / 4 codes from dim tig * D / 4 on at once; its B fragment of k16
// block kk is their word kk, dims tig * D / 4 + 4 kk + e standing at k =
// 2 tig + e (e < 2) and 2 tig + 6 + e (e >= 2): the order of the query
// tile's dims (``q_lane`` as in tile_scores).  Even and odd blocks sum
// in two chains of products, added at the end.
template <int D>
__device__ __forceinline__ void tile_scores_q8(
    uint32_t q_lane, const unsigned char* k_box, const uint32_t (&row)[2],
    const uint32_t (&x)[2], const unsigned (&ks)[2], float (&s)[2][4]) {
  const int tig = threadIdx.x & 3;
  unsigned w[2][D / 16];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    load_codes<D / 4>(k_box + row[h], tig * (D / 4), x[h], w[h]);
  float odd[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = odd[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    unsigned qa[4];
    ldsm_x4(qa, q_lane + 32 * kk);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned s2 = ks[h] | ks[h] << 16;
      mma_bf16(kk % 2 ? odd[h] : s[h], qa,
               widen2(w[h][kk], 0, w[h][kk], 1, s2),
               widen2(w[h][kk], 2, w[h][kk], 3, s2));
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += odd[j][e];
}

// o += P . V over one 16-row tile of int8 V codes, widened into the B
// fragments in registers: the lane takes the rows of its k (keys 2 tig,
// 2 tig + 1, 2 tig + 8, 2 tig + 9: bytes `row[i]` of the box, swizzle_xor
// `x[i]`) and of each the D / 8 codes from dim gid * D / 8 on.  n8 block
// j of o holds dims n * D / 8 + j (n its column), so each B fragment's
// codes are the lane's own.
template <int D>
__device__ __forceinline__ void tile_values_q8(
    const float (&p)[2][4], const unsigned char* v_box,
    const uint32_t (&row)[4], const uint32_t (&x)[4],
    const unsigned (&vs)[4], float (&o)[D / 8][4]) {
  constexpr int kBytes = D / 8;  // a row's codes the lane takes
  const int gid = (threadIdx.x & 31) >> 2;
  const unsigned a[4] = {pack_bf16(p[0][0], p[0][1]),
                         pack_bf16(p[0][2], p[0][3]),
                         pack_bf16(p[1][0], p[1][1]),
                         pack_bf16(p[1][2], p[1][3])};
  unsigned w[4][(kBytes + 3) / 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    load_codes<kBytes>(v_box + row[i], gid * kBytes, x[i], w[i]);
  const unsigned s01 = vs[0] | vs[1] << 16, s23 = vs[2] | vs[3] << 16;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int k = j / 4, bt = j % 4;
    mma_bf16(o[j], a, widen2(w[0][k], bt, w[1][k], bt, s01),
             widen2(w[2][k], bt, w[3][k], bt, s23));
  }
}

// CTA (kh, b, sp) of a launch: the split's tiles through the ring, the
// warps' merge, then the cluster's merge and this CTA's share of the (b,
// kh) outputs.  g: rows a box holds (16 dense, gcd(bs, 16) paged).
template <int D, typename Tiles, typename KV>
__device__ __forceinline__ void decode_split(
    const CUtensorMap* kmap, const CUtensorMap* vmap,
    const __nv_bfloat16* __restrict__ q, const Tiles& rows, const KV& kv,
    __nv_bfloat16* __restrict__ o, int H, int n_kv, int per, int stages,
    int g, float scale_log2) {
  constexpr bool kQ8 = KV::kQ8;
  constexpr int kCols = box_cols(D);
  constexpr int kRowBytes = ring_row_bytes<D, kQ8>();
  constexpr int kBoxes = ring_boxes<D, kQ8>();  // a tile's K (or V) boxes
  constexpr int NO = D / 8;
  // A tile's K and V bytes, TMA's transactions on its full barrier.
  constexpr unsigned kTileTx = 2 * kTile * D * (kQ8 ? 1 : 2);
  extern __shared__ __align__(1024) unsigned char smem[];
  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int n_split = gridDim.z, G = H / n_kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t base = smem_addr(smem);
  auto full = [&](int st) { return base + 8 * st; };
  auto empty = [&](int st) { return base + kHdrEmpty + 8 * st; };
  unsigned* masks = reinterpret_cast<unsigned*>(smem + kHdrMasks);
  unsigned* odds = reinterpret_cast<unsigned*>(smem + kHdrOdds);
  const unsigned* scales = reinterpret_cast<const unsigned*>(
      smem + kHdrScales);
  int* tbl = reinterpret_cast<int*>(smem + kHdrTbl);
  const uint32_t ring = (base + kHdrUsed + 1023) & ~1023u;
  unsigned char* ring_p = smem + (ring - base);
  const int pitch = piece_pitch<D, kQ8>(g), box_bytes = kTile / g * pitch;
  const int st_bytes = 2 * kBoxes * box_bytes;
  __nv_bfloat16* q_sm = reinterpret_cast<__nv_bfloat16*>(
      ring_p + max(stages * st_bytes, merge_bytes<D>(G)));  // [16][D + 8]
  float* w_acc = reinterpret_cast<float*>(ring_p);  // [kWarps][G][D]
  float* w_ml = w_acc + kWarps * G * D;             // [kWarps][G][2]
  float* part = w_ml + kWarps * G * 2;              // [G][D]
  float* part_ml = part + G * D;  // [G]: (max in log2 units, sum)

  // The CTA's tiles: split sp's, past those wholly before the window;
  // local tile j is t_first + j, in stage j % stages, for warp j % 4.
  const int t_first = max(sp * per, rows.lo / kTile);
  const int t_end = min((sp + 1) * per, (rows.hi + kTile - 1) / kTile);
  const int n = max(0, t_end - t_first);

  // The tensor maps' prefetch and, paged, the loads of the producer
  // warp's first window of block-table entries [w_lo, w_hi) (kTbl / 32 a
  // lane, stored to tbl once the barriers are set up): neither depends on
  // cache_len, so they are in flight beside its load.
  int w_lo = 0, w_hi = 0;
  int entries[kTbl / 32];
  if (warp == kWarps) {
    if (lane == 0) {
      tma_prefetch_map(kmap);
      tma_prefetch_map(vmap);
    }
    if constexpr (Tiles::kPaged) {
      w_lo = t_first * kTile / rows.bs;
      w_hi = min(rows.M, w_lo + kTbl);
#pragma unroll
      for (int i = 0; i < kTbl / 32; ++i) {
        const int e = lane + 32 * i;
        entries[i] = e < w_hi - w_lo ? __ldg(rows.table + w_lo + e) : 0;
      }
    }
  }

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      // The producer's arrival and, int8, its 16 lanes' scale copies.
      mbar_init(full(st), kQ8 ? 1 + kTile : 1);
      mbar_init(empty(st), 1);  // the consuming warp's release
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {
    // -- producer: lane r < 16 finds row r of the tile; the lane at the
    //    head of each g-row piece issues its boxes -----------------------
    const bool issues = lane < kTile && lane % g == 0;
    const uint32_t piece = lane / g * pitch;
    // Paged: this lane's row of the tile as (page, row in the page),
    // moved on a tile at a time without a division.
    int page = 0, in_page = 0, d_page = 0, d_row = 0;
    if constexpr (Tiles::kPaged) {
#pragma unroll
      for (int i = 0; i < kTbl / 32; ++i) tbl[lane + 32 * i] = entries[i];
      __syncwarp();
      const int r = t_first * kTile + lane;
      page = r / rows.bs;
      in_page = r - page * rows.bs;
      d_page = kTile / rows.bs;
      d_row = kTile - d_page * rows.bs;
    }
    // Tile j's stage j % stages and use j / stages (its parity: phase),
    // kept without a division.
    int st = 0;
    unsigned phase = 0;
    for (int j = 0; j < n; ++j) {
      const int t = t_first + j;
      int c2, c3;
      bool stored;
      if constexpr (Tiles::kPaged) {
        const int last =
            min(rows.M - 1, __shfl_sync(0xffffffffu, page, kTile - 1));
        if (last >= w_hi) {  // the tile's pages pass the window: move it
          w_lo = __shfl_sync(0xffffffffu, page, 0);
          w_hi = table_window(rows, tbl, w_lo, lane);
        }
        c3 = lane < kTile && page < rows.M ? tbl[page - w_lo] : -1;
        c2 = in_page;
        stored = c3 >= 0 && c3 < rows.N;
        page += d_page;
        in_page += d_row;
        if (in_page >= rows.bs) in_page -= rows.bs, ++page;
      } else {
        c2 = t * kTile + lane;
        c3 = rows.b;
        stored = c2 < rows.S;
      }
      const unsigned bits =
          __ballot_sync(0xffffffffu, lane < kTile && stored);
      if (j >= stages) mbar_wait(empty(st), phase ^ 1);  // the last use
      // int8: row `lane`'s scales, element (c3, c2, kh) of the (outer,
      // rows, KV) scales, and which half of its 4-byte word each is.
      const unsigned short *ks = nullptr, *vs = nullptr;
      unsigned odd = 0;
      if constexpr (kQ8) {
        int n_rows;
        if constexpr (Tiles::kPaged) n_rows = rows.bs;
        else n_rows = rows.S;
        const long i = stored ? ((long)c3 * n_rows + c2) * n_kv + kh : 0;
        ks = kv.ks + i;
        vs = kv.vs + i;
        const uintptr_t k_at = reinterpret_cast<uintptr_t>(ks);
        const uintptr_t v_at = reinterpret_cast<uintptr_t>(vs);
        odd = __ballot_sync(0xffffffffu, lane < kTile && (k_at & 2u)) |
              __ballot_sync(0xffffffffu, lane < kTile && (v_at & 2u)) << 16;
      }
      if (lane == 0) {
        masks[st] = bits;
        if constexpr (kQ8) odds[st] = odd;
        mbar_arrive_expect_tx(full(st), kTileTx);
      }
      __syncwarp();
      if (issues) {
        const uint32_t dst = ring + st * st_bytes + piece;
#pragma unroll
        for (int bx = 0; bx < kBoxes; ++bx) {
          tma_load_4d(dst + bx * box_bytes, kmap, full(st), bx * kCols, kh,
                      c2, c3);
          tma_load_4d(dst + (kBoxes + bx) * box_bytes, vmap, full(st),
                      bx * kCols, kh, c2, c3);
        }
      }
      if constexpr (kQ8) {
        // Behind the boxes: the scales' words by cp.async into the
        // stage's slots (zeros for a row not stored), each lane's copies
        // one arrival on the full barrier once they land.
        if (lane < kTile) {
          const uint32_t slot = smem_addr(scales + (st * kTile + lane) * 2);
          cp_async4(slot, reinterpret_cast<const void*>(
                              reinterpret_cast<uintptr_t>(ks) & ~3ull),
                    stored);
          cp_async4(slot + 4, reinterpret_cast<const void*>(
                                  reinterpret_cast<uintptr_t>(vs) & ~3ull),
                    stored);
          cp_async_mbar_arrive(full(st));
        }
      }
      if (++st == stages) st = 0, phase ^= 1;
    }
  } else {
    // -- consumers: warp w attends local tiles w, w + 4, ... ------------
    // The query tile: heads kh * G + r are its rows r < G, the rows past
    // G zero.  bf16: a thread and copy a 16-byte piece.  int8: a thread
    // and copy a word, logical word w of k16 block kk holding dims
    // (w % 4) * D / 4 + 4 kk + 2 (w / 4), + 1 (tile_scores_q8's order).
    if constexpr (kQ8) {
      const unsigned* q_g = reinterpret_cast<const unsigned*>(
          q + ((long)b * H + kh * G) * D);
      unsigned* q_w = reinterpret_cast<unsigned*>(q_sm);
      for (int c = threadIdx.x; c < kMaxG * D / 2; c += 32 * kWarps) {
        const int r = c / (D / 2), lw = c % (D / 2);
        const int kk = lw / 8, w = lw % 8;
        q_w[r * (D + 8) / 2 + lw] =
            r < G ? q_g[r * D / 2 + w % 4 * (D / 8) + 2 * kk + w / 4] : 0u;
      }
    } else {
      constexpr int kChunks = D / 8;  // 16-byte pieces of a row
      const uint4* q_g = reinterpret_cast<const uint4*>(
          q + ((long)b * H + kh * G) * D);
      for (int c = threadIdx.x; c < kMaxG * kChunks; c += 32 * kWarps) {
        const int r = c / kChunks, col = c % kChunks;
        *reinterpret_cast<uint4*>(q_sm + r * (D + 8) + 8 * col) =
            r < G ? q_g[r * kChunks + col] : make_uint4(0, 0, 0, 0);
      }
    }
    named_barrier_sync(1, 32 * kWarps);
    const uint32_t q_lane =
        smem_addr(q_sm + (lane & 15) * (D + 8) + 8 * (lane >> 4));
    // The rows this lane's loads name in a tile, as byte offsets in a box
    // and their swizzle_xor: bf16, those of tile_scores' and tile_values'
    // ldmatrix addresses; int8, rows gid and gid + 8 of K and 2 tig,
    // 2 tig + 1, 2 tig + 8, 2 tig + 9 of V.
    auto row_off = [&](int r) {
      return (uint32_t)(r / g * pitch + r % g * kRowBytes);
    };
    const uint32_t k_row = row_off((lane & 7) + ((lane >> 4) << 3));
    const uint32_t v_row = row_off((lane & 7) + (((lane >> 3) & 1) << 3));
    const uint32_t k_x = swizzle_xor(k_row, kRowBytes);
    const uint32_t v_x = swizzle_xor(v_row, kRowBytes);
    const int k8[2] = {gid, gid + 8};
    const int v8[4] = {2 * tig, 2 * tig + 1, 2 * tig + 8, 2 * tig + 9};
    uint32_t k8_row[2], k8_x[2], v8_row[4], v8_x[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      k8_row[i] = row_off(k8[i]);
      k8_x[i] = swizzle_xor(k8_row[i], kRowBytes);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v8_row[i] = row_off(v8[i]);
      v8_x[i] = swizzle_xor(v8_row[i], kRowBytes);
    }
    float acc[NO][4] = {};
    float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
    // Local tile j = warp + 4 i is in stage st, its use's parity phase: a
    // ring as long as the CTA's tiles never wraps, and a shorter one is a
    // multiple of the 4 warps, so a stage's uses are all this warp's.
    int st = warp;
    unsigned phase = 0;
    for (int j = warp; j < n; j += kWarps) {
      mbar_wait(full(st), phase);
      const unsigned bits = masks[st];
      const uint32_t tile = ring + st * st_bytes;
      const unsigned char* tile_p = ring_p + st * st_bytes;
      unsigned ks[2], vs[4];
      float s[2][4];
      if constexpr (kQ8) {
        const unsigned* sc = scales + st * kTile * 2;
        const unsigned odd = odds[st];
#pragma unroll
        for (int i = 0; i < 2; ++i) ks[i] = row_scale(sc, odd, k8[i], 0);
#pragma unroll
        for (int i = 0; i < 4; ++i) vs[i] = row_scale(sc, odd, v8[i], 1);
        tile_scores_q8<D>(q_lane, tile_p, k8_row, k8_x, ks, s);
      } else {
        tile_scores<D>(q_lane, tile, box_bytes, k_row, k_x, s);
      }
      const int r0 = (t_first + j) * kTile;
      warp_scale_mask<2>(s, scale_log2, [&](int, int c) {
        const int r = r0 + c;
        return ((bits >> c) & 1u) && r >= rows.lo && r < rows.hi;
      });
      // The accumulators' rescale, but where it changes no bit: before
      // the warp's first tile (they are 0) or where no row's maximum
      // moved (every factor 1).
      float alpha[2];
      softmax_tile<2>(s, m, l, alpha);
      if (j != warp &&
          !__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f))
        warp_rescale<NO>(acc, alpha);
      if constexpr (kQ8)
        tile_values_q8<D>(s, tile_p + box_bytes, v8_row, v8_x, vs, acc);
      else
        tile_values<D>(s, tile + kBoxes * box_bytes, box_bytes, v_row, v_x,
                       acc);
      __syncwarp();  // the tile is read: its bytes may be refilled
      if (lane == 0) mbar_arrive(empty(st));
      st += kWarps;
      if (st >= stages) st -= stages, phase ^= 1;
    }
    warp_row_sum(l);
    // The warps' partials (rows 0..G-1 of each: the heads) go to the
    // ring's bytes once every consumer is done with the ring (the
    // producer's loads have all landed by then), in the products' order:
    // column c of n8 block j at 8 j + c (int8: dim c * D / 8 + j, put in
    // place as the output is written).
    named_barrier_sync(1, 32 * kWarps);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (gid + 8 * h >= G) continue;
      const int row = warp * G + gid + 8 * h;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        w_acc[row * D + 8 * j + 2 * tig] = acc[j][2 * h];
        w_acc[row * D + 8 * j + 2 * tig + 1] = acc[j][2 * h + 1];
      }
      if (tig == 0) {
        w_ml[row * 2] = m[h];
        w_ml[row * 2 + 1] = l[h];
      }
    }
  }

  // Merge the warps in warp order: a head's maximum, sum and the warps'
  // weights once (each warp's maximum becomes its weight), then the
  // accumulators four dims a thread.
  __syncthreads();
  if ((int)threadIdx.x < G) {
    const int gg = threadIdx.x;
    float m_all = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m_all = fmaxf(m_all, w_ml[(w * G + gg) * 2]);
    float l_all = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(w_ml[(w * G + gg) * 2] - m_all);
      l_all += w_ml[(w * G + gg) * 2 + 1] * wt;
      w_ml[(w * G + gg) * 2] = wt;
    }
    part_ml[gg * 2] = m_all;
    part_ml[gg * 2 + 1] = l_all;
  }
  __syncthreads();
  for (int e = 4 * threadIdx.x; e < G * D; e += 4 * kThreads) {
    const int gg = e / D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = w_ml[(w * G + gg) * 2];
      const float4 x =
          *reinterpret_cast<const float4*>(w_acc + (w * G + gg) * D + e % D);
      a.x += x.x * wt;
      a.y += x.y * wt;
      a.z += x.z * wt;
      a.w += x.w * wt;
    }
    *reinterpret_cast<float4*>(part + e) = a;
  }

  // Merge the splits in rank (split) order across the cluster: this CTA
  // takes the sp-th share of the G * D / 2 pairs of output dims, and for
  // a pair loads every split's (max, sum) of its head and partial pair
  // at once, so they are in flight together; each CTA forms the weights
  // the same way.
  cluster_sync();  // every split's partial is in its CTA's shared memory
  const uint32_t part_at = smem_addr(part), ml_at = smem_addr(part_ml);
  const int pairs = G * D / 2, share = (pairs + n_split - 1) / n_split;
  const int end = min(pairs, (sp + 1) * share);
  for (int i = sp * share + threadIdx.x; i < end; i += kThreads) {
    const int gg = 2 * i / D, d = 2 * i % D;
    float2 ml[kMaxCluster], v[kMaxCluster];
#pragma unroll
    for (int rk = 0; rk < kMaxCluster; ++rk) {
      if (rk < n_split) {
        ml[rk] = ld_cluster2(cluster_map(ml_at + 8 * gg, rk));
        v[rk] = ld_cluster2(cluster_map(part_at + 8 * i, rk));
      }
    }
    float m_all = REPRO_NEG_INF;
#pragma unroll
    for (int rk = 0; rk < kMaxCluster; ++rk)
      if (rk < n_split) m_all = fmaxf(m_all, ml[rk].x);
    float l_all = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int rk = 0; rk < kMaxCluster; ++rk) {
      if (rk < n_split) {
        const float w = exp2f(ml[rk].x - m_all);
        l_all += ml[rk].y * w;
        a0 += v[rk].x * w;
        a1 += v[rk].y * w;
      }
    }
    const float den = fmaxf(l_all, 1e-30f);
    __nv_bfloat16* out = o + ((long)b * H + kh * G + gg) * D;
    if constexpr (kQ8) {  // dims c * D / 8 + j, c + 1 ... (d = 8 j + c)
      out[d % 8 * (D / 8) + d / 8] = __float2bfloat16(a0 / den);
      out[(d % 8 + 1) * (D / 8) + d / 8] = __float2bfloat16(a1 / den);
    } else {
      *reinterpret_cast<unsigned*>(out + d) = pack_bf16(a0 / den, a1 / den);
    }
  }
  // No CTA's shared memory goes while a peer reads it.
  cluster_sync_relaxed();
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinCtas) decode_bf16_kernel(
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ cache_len,
    __nv_bfloat16* __restrict__ o, int S, int H, int KV, int window, int per,
    int stages, float scale_log2) {
  const int b = blockIdx.y, len = cache_len[b];
  const DenseTiles rows{S, b, window >= 0 ? max(0, len - window) : 0,
                        min(len, S)};
  decode_split<D>(&kmap, &vmap, q, rows, Bf16KV{}, o, H, KV, per, stages,
                  kTile, scale_log2);
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    paged_decode_bf16_kernel(
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ tables,
    const int* __restrict__ cache_len, __nv_bfloat16* __restrict__ o, int N,
    int bs, int M, int H, int KV, int per, int stages, float scale_log2) {
  const int b = blockIdx.y, len = cache_len[b];
  const PagedTiles rows{tables + (long)b * M, M, bs, N, 0,
                        min(len, M * bs)};
  decode_split<D>(&kmap, &vmap, q, rows, Bf16KV{}, o, H, KV, per, stages,
                  piece_rows(bs), scale_log2);
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinCtas) decode_q8_kernel(
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, const unsigned short* ks,
    const unsigned short* vs, const int* __restrict__ cache_len,
    __nv_bfloat16* __restrict__ o, int S, int H, int KV, int per, int stages,
    float scale_log2) {
  const int b = blockIdx.y, len = cache_len[b];
  const DenseTiles rows{S, b, 0, min(len, S)};
  decode_split<D>(&kmap, &vmap, q, rows, Q8KV{ks, vs}, o, H, KV, per,
                  stages, kTile, scale_log2);
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    paged_decode_q8_kernel(
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, const unsigned short* ks,
    const unsigned short* vs, const int* __restrict__ tables,
    const int* __restrict__ cache_len, __nv_bfloat16* __restrict__ o, int N,
    int bs, int M, int H, int KV, int per, int stages, float scale_log2) {
  const int b = blockIdx.y, len = cache_len[b];
  const PagedTiles rows{tables + (long)b * M, M, bs, N, 0,
                        min(len, M * bs)};
  decode_split<D>(&kmap, &vmap, q, rows, Q8KV{ks, vs}, o, H, KV, per,
                  stages, piece_rows(bs), scale_log2);
}

// Launches a kernel on its (KV, B, n_split) grid as clusters of the
// n_split CTAs of one (b, kv head).
template <auto Kernel, typename... Args>
int launch_cluster(int max_smem, int KV, int B, int n_split, int smem,
                   cudaStream_t st, const Args&... args) {
  cudaError_t err = once_per_device<Kernel>(max_smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KV, B, n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = n_split;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Calls f with std::integral_constant<int, D> for a head dim the kernels
// are built for.
template <typename F>
int by_head_dim(int D, F&& f) {
  switch (D) {
    case 128: return f(std::integral_constant<int, 128>());
    case 64: return f(std::integral_constant<int, 64>());
    case 32: return f(std::integral_constant<int, 32>());
    case 16: return f(std::integral_constant<int, 16>());
    default: return (int)cudaErrorInvalidValue;
  }
}

// Splits of a launch over `n_tiles` tiles (one cluster), or 0 where the
// shapes are not ones every kernel takes: G = H / KV whole and at most
// kMaxG, a positive split, at most kMaxCluster splits.
int cluster_splits(int H, int KV, int n_tiles, int tiles_per_split) {
  if (KV < 1 || H % KV || H / KV > kMaxG || tiles_per_split < 1) return 0;
  const int n = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  return n < 1 ? 1 : n > kMaxCluster ? 0 : n;
}

using bf16_t = __nv_bfloat16;
using u16_t = unsigned short;

}  // namespace

// Every entry point: n_tiles = ceil(rows / 16), rows = S dense and M * bs
// paged (pages of 1-64 rows), split into n_split = ceil(n_tiles /
// tiles_per_split) CTAs a (b, kv head), launched as one cluster (at most
// 16).  q (B, H, D) bf16, H / KV up to 16; o (B, H, D) bf16.  Cache
// tensors start at a multiple of 16 bytes (TMA's rule), scales at 2.

// bf16 cache k, v (B, S, KV, D); `block` must be 16.
extern "C" int repro_decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* o, int B, int S, int H, int KV, int D, int block, int window,
    int tiles_per_split, float scale, void* stream) {
  const int n_split =
      cluster_splits(H, KV, (S + kTile - 1) / kTile, tiles_per_split);
  if (n_split == 0 || block != kTile) return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    CUtensorMap kmap, vmap;
    int err = encode_rows<kD>(&kmap, k, B, S, KV, kTile);
    if (!err) err = encode_rows<kD>(&vmap, v, B, S, KV, kTile);
    if (err) return err;
    const int stages = ring_stages<kD, false>(tiles_per_split, kTile);
    return launch_cluster<decode_bf16_kernel<kD>>(
        max_smem<kD>(), KV, B, n_split,
        smem_bytes<kD, false>(stages, H / KV, kTile), (cudaStream_t)stream,
        kmap, vmap, (const bf16_t*)q, (const int*)cache_len, (bf16_t*)o, S,
        H, KV, window, tiles_per_split, stages, scale * REPRO_LOG2E);
  });
}

// int8 codes k, v (B, S, KV, D) with bf16 scales ks, vs (B, S, KV, 1);
// `block` must be 16.  No window (the reference has none).
extern "C" int repro_decode_attention_q8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* cache_len, void* o, int B, int S, int H,
    int KV, int D, int block, int tiles_per_split, float scale,
    void* stream) {
  const int n_split =
      cluster_splits(H, KV, (S + kTile - 1) / kTile, tiles_per_split);
  if (n_split == 0 || block != kTile) return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    CUtensorMap kmap, vmap;
    int err = encode_codes<kD>(&kmap, k, B, S, KV, kTile);
    if (!err) err = encode_codes<kD>(&vmap, v, B, S, KV, kTile);
    if (err) return err;
    const int stages = ring_stages<kD, true>(tiles_per_split, kTile);
    return launch_cluster<decode_q8_kernel<kD>>(
        max_smem<kD>(), KV, B, n_split,
        smem_bytes<kD, true>(stages, H / KV, kTile), (cudaStream_t)stream,
        kmap, vmap, (const bf16_t*)q, (const u16_t*)ks, (const u16_t*)vs,
        (const int*)cache_len, (bf16_t*)o, S, H, KV, tiles_per_split,
        stages, scale * REPRO_LOG2E);
  });
}

// bf16 pages (N, bs, KV, D) through int32 tables (B, M).
extern "C" int repro_paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* cache_len, void* o, int B, int N, int bs,
    int M, int H, int KV, int D, int tiles_per_split, float scale,
    void* stream) {
  const int n_split =
      cluster_splits(H, KV, (M * bs + kTile - 1) / kTile, tiles_per_split);
  if (n_split == 0 || bs < 1 || bs > kMaxT)
    return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const int g = piece_rows(bs);
    CUtensorMap kmap, vmap;
    int err = encode_rows<kD>(&kmap, k_pages, N, bs, KV, g);
    if (!err) err = encode_rows<kD>(&vmap, v_pages, N, bs, KV, g);
    if (err) return err;
    const int stages = ring_stages<kD, false>(tiles_per_split, g);
    return launch_cluster<paged_decode_bf16_kernel<kD>>(
        max_smem<kD>(), KV, B, n_split,
        smem_bytes<kD, false>(stages, H / KV, g), (cudaStream_t)stream, kmap,
        vmap, (const bf16_t*)q, (const int*)tables, (const int*)cache_len,
        (bf16_t*)o, N, bs, M, H, KV, tiles_per_split, stages,
        scale * REPRO_LOG2E);
  });
}

// int8 code pages (N, bs, KV, D) with bf16 scale pages (N, bs, KV, 1)
// through int32 tables (B, M).
extern "C" int repro_paged_decode_attention_q8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* ks_pages, const void* vs_pages, const void* tables,
    const void* cache_len, void* o, int B, int N, int bs, int M, int H,
    int KV, int D, int tiles_per_split, float scale, void* stream) {
  const int n_split =
      cluster_splits(H, KV, (M * bs + kTile - 1) / kTile, tiles_per_split);
  if (n_split == 0 || bs < 1 || bs > kMaxT)
    return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const int g = piece_rows(bs);
    CUtensorMap kmap, vmap;
    int err = encode_codes<kD>(&kmap, k_pages, N, bs, KV, g);
    if (!err) err = encode_codes<kD>(&vmap, v_pages, N, bs, KV, g);
    if (err) return err;
    const int stages = ring_stages<kD, true>(tiles_per_split, g);
    return launch_cluster<paged_decode_q8_kernel<kD>>(
        max_smem<kD>(), KV, B, n_split,
        smem_bytes<kD, true>(stages, H / KV, g), (cudaStream_t)stream, kmap,
        vmap, (const bf16_t*)q, (const u16_t*)ks_pages,
        (const u16_t*)vs_pages, (const int*)tables, (const int*)cache_len,
        (bf16_t*)o, N, bs, M, H, KV, tiles_per_split, stages,
        scale * REPRO_LOG2E);
  });
}

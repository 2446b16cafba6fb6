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
// little latency per row.  Shared by all four: a CTA per (kv head, b,
// split of S) holds all G query heads of its kv head, so every K/V row
// leaves HBM once for the whole group, and the split of S
// (flash-decoding) puts B * K * n_split CTAs in flight instead of B * K.
// The dense kernels stop at min(cache_len, S) (a free continuous slot
// keeps advancing its position past S) and start at the window edge; the
// paged kernels read their own block-table row and only the sequence's
// own pages.  Rows are walked in tiles of 16 logical rows whatever the
// page size, and the G heads (up to 16) are the rows of one mma.sync
// m16n8k16 A fragment (padded with zero rows to 16): each tile runs the
// tensor-core tile of attention_common.cuh, scores through ldmatrix, the
// online softmax on the C fragments, P kept in registers for P . V
// through ldmatrix.trans.  The products stay on mma.sync: a wgmma tile
// is 64 rows, at least 4x the G <= 16 heads, and tensor work does not set
// the pace of a kernel bound by bytes.
//
// bf16 (decode_bf16_kernel, paged_decode_bf16_kernel): one launch a call.
// What a byte-bound kernel loses is time with nothing in flight and work
// outside the stream of K/V bytes; the design takes both away.
//   - TMA loads into an mbarrier ring.  A producer warp issues each tile
//     as TMA boxes (4-d tensor maps: (D, KV, S, B) dense, (D, KV, bs, N)
//     paged; boxes of box_cols(D) dims, swizzled to their row bytes as
//     flash's) into a ring of up to 16 stages and 64 KB, sized to the
//     CTA's tile count, so at the main shape the CTA's whole share is in
//     flight from its first instruction.  Each stage has a full barrier
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
//   - Four consumer warps take the CTA's tiles round-robin in a fixed
//     order, each with its own online softmax, the query heads' A
//     fragments read by ldmatrix from a query tile in shared memory (in
//     registers they would leave room for two CTAs an SM, not three), the
//     K/V boxes by ldmatrix addresses XORed to their swizzle
//     (conflict-free, as the old 16-byte row pad was); then they merge in
//     warp order through the ring's bytes.
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

// int8 (decode_q8_kernel, paged_decode_q8_kernel) still run decode_split
// and the combine kernel: each warp streams its own tiles of codes
// through a private cp.async stage (16 bytes a lane; rows past the cache
// or on an out-of-pool page are zero-filled, noted by a ballot as the
// copies are issued, and masked) and keeps its own (m, l, acc); the CTA
// merges its warps in warp order and stores its partials for
// combine_kernel, which forms the splits' weights once and sums with its
// loads in flight together.  A paged row's address comes from the block
// table row by row.  The rows' bf16 scales, strided by KV, come beside
// the codes by plain loads into registers.  Once its copies have landed,
// each lane widens the pieces it copied into the warp's bf16 tile as
// bf16(code * scale), computed in f32: the dequantize of
// ops.decode_attention_quant and of the port's plain version, so the int8
// kernels differ from it only as the bf16 ones do.  Then the lane refills
// the same bytes with the next tile's codes, which are in flight while
// the widened tile is attended: since a lane reads back only what it
// copied, one stage suffices.  At D = 16 an int8 row is a single 16-byte
// piece, so a tile's codes are 16 pieces: lanes 0-15 copy and widen them,
// and lanes 16-31 only take part in the ballot.
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

// CTAs per SM the int8 kernels ask of ptxas: 3 at D <= 32 (a 170-register
// cap; left alone ptxas held a D = 32 paged kernel of this loop to 64
// registers, and it spilled), 0 at D = 64 and 128, which compiles as no
// bound at all.
template <int D>
__host__ __device__ constexpr int dec_min_ctas() { return D <= 32 ? 3 : 0; }

// Raises a kernel's dynamic shared-memory limit to `smem` bytes and, for
// a cluster launch, allows clusters past the portable 8 CTAs: once a
// device, not on every call.
template <auto Kernel>
cudaError_t once_per_device(int smem, bool cluster) {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> ready[kMaxDevices];  // false: not set yet
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev].load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && cluster)
    err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) ready[dev].store(true, std::memory_order_release);
  return err;
}

// -- the bf16 pair: a TMA ring, a producer warp, the merge in a cluster ------

constexpr int kBfWarps = 4;                      // consumer warps
constexpr int kBfThreads = 32 * (kBfWarps + 1);  // and the producer warp
constexpr int kMaxCluster = 16;  // splits of one (b, kv head): its cluster
constexpr int kMaxStages = 16;   // tiles in flight at most ...
constexpr int kRingBytes = 64 * 1024;  // ... and their bytes
constexpr int kTbl = 256;  // block-table entries the producer holds at once
// CTAs per SM asked of ptxas: 3, so that a cluster of every (b, kv head)
// at the main shape fits the SMs in one wave.
constexpr int kBfMinCtas = 3;

// Shared memory: a header, then (1024-aligned) the ring, whose bytes the
// merges reuse (the warps' partials, then the CTA's that its cluster
// reads), then the query tile.  The header: full barriers [kMaxStages],
// empty barriers, the stages' stored-row masks, the producer's
// block-table window.  Under 73 KB at every G, so three CTAs fit an SM.
constexpr int kHdrEmpty = 8 * kMaxStages;
constexpr int kHdrMasks = kHdrEmpty + 8 * kMaxStages;
constexpr int kHdrTbl = kHdrMasks + 4 * kMaxStages;
constexpr int kHdrUsed = kHdrTbl + 4 * kTbl;
constexpr int kHdrBytes = kHdrUsed + 1024;  // and the ring's alignment

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
template <int D>
__host__ __device__ inline int piece_pitch(int g) {
  const int bytes = g * box_row_bytes(D);
  return bytes < 128 ? 128 : bytes;
}

// One box column of a tile (16 rows of box_cols(D) dims), a stage (the K
// tile's D / box_cols(D) columns, then the V tile's), the ring.
template <int D>
__host__ __device__ inline int tile_box_bytes(int g) {
  return kTile / g * piece_pitch<D>(g);
}

template <int D>
__host__ __device__ inline int stage_bytes(int g) {
  return 2 * (D / box_cols(D)) * tile_box_bytes<D>(g);
}

// Stages for a CTA of `per` tiles: one for each, up to kMaxStages and
// kRingBytes.  A ring shorter than the CTA's tiles is a multiple of the 4
// consumer warps, so every use of a stage goes to one warp, which waits
// for the stage's uses in order: a warp waiting on a full barrier's
// parity two uses ahead would pass it at the use before.  (Every cap
// here is at least 8.)
template <int D>
int ring_stages(int per, int g) {
  int cap = kRingBytes / stage_bytes<D>(g);
  if (cap > kMaxStages) cap = kMaxStages;
  return per <= cap ? per : cap / kBfWarps * kBfWarps;
}

// The merges' bytes over the ring: the warps' partials [kBfWarps][G][D +
// 2] f32, then the CTA's [G][D + 2] (its cluster's reads).  The query
// tile [16][D + 8] bf16 lies past them: the A fragment's rows, padded 16
// bytes for ldmatrix without bank conflicts.
template <int D>
__host__ __device__ inline int warp_merge_bytes(int G) {
  return kBfWarps * G * (D + 2) * (int)sizeof(float);
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

template <int D>
int bf16_smem_bytes(int stages, int G, int g) {
  const int ring = stages * stage_bytes<D>(g);
  const int merge = merge_bytes<D>(G);
  return kHdrBytes + (ring > merge ? ring : merge) + q_tile_bytes<D>();
}

// The most a launch can ask (the ring at kRingBytes, kMaxG heads).
template <int D>
int bf16_max_smem() {
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

// warp_scores over one 16-row K tile in swizzled boxes of `box_bytes`,
// the A fragments read by ldmatrix from the query tile: `q_lane` is this
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

// warp_pv over one 16-row V tile in swizzled boxes: `row` is the byte
// offset of this lane's row (keys lane & 7, + 8 for lanes 8-15 and
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

// CTA (kh, b, sp) of a bf16 launch: the split's tiles through the ring,
// the warps' merge, then the cluster's merge and this CTA's share of the
// (b, kh) outputs.  g: rows a box holds (16 dense, gcd(bs, 16) paged).
template <int D, typename Tiles>
__device__ __forceinline__ void bf16_split(
    const CUtensorMap* kmap, const CUtensorMap* vmap,
    const __nv_bfloat16* __restrict__ q, const Tiles& rows,
    __nv_bfloat16* __restrict__ o, int H, int KV, int per, int stages,
    int g, float scale_log2) {
  constexpr int kCols = box_cols(D), kRowBytes = box_row_bytes(D);
  constexpr int kBoxes = D / kCols;
  constexpr int NO = D / 8;
  constexpr unsigned kTileTx = 2 * kTile * D * 2;  // a tile's K and V bytes
  extern __shared__ __align__(1024) unsigned char bf_smem[];
  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int n_split = gridDim.z, G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const uint32_t base = smem_addr(bf_smem);
  auto full = [&](int st) { return base + 8 * st; };
  auto empty = [&](int st) { return base + kHdrEmpty + 8 * st; };
  unsigned* masks = reinterpret_cast<unsigned*>(bf_smem + kHdrMasks);
  int* tbl = reinterpret_cast<int*>(bf_smem + kHdrTbl);
  const uint32_t ring = (base + kHdrUsed + 1023) & ~1023u;
  unsigned char* ring_p = bf_smem + (ring - base);
  const int pitch = piece_pitch<D>(g), box_bytes = kTile / g * pitch;
  const int st_bytes = 2 * kBoxes * box_bytes;
  const int ring_bytes = stages * st_bytes;
  __nv_bfloat16* q_sm = reinterpret_cast<__nv_bfloat16*>(
      ring_p + max(ring_bytes, merge_bytes<D>(G)));  // [16][D + 8]
  float* w_acc = reinterpret_cast<float*>(ring_p);  // [kBfWarps][G][D]
  float* w_ml = w_acc + kBfWarps * G * D;           // [kBfWarps][G][2]
  float* part = w_ml + kBfWarps * G * 2;            // [G][D]
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
  if (warp == kBfWarps) {
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
      mbar_init(full(st), 1);
      mbar_init(empty(st), 1);  // the consuming warp's release
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kBfWarps) {
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
      if (lane == 0) {
        masks[st] = bits;
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
      if (++st == stages) st = 0, phase ^= 1;
    }
  } else {
    // -- consumers: warp w attends local tiles w, w + 4, ... ------------
    // The query tile: heads kh * G + r are its rows r < G (16 bytes a
    // thread and copy), the rows past G zero.
    constexpr int kChunks = D / 8;  // 16-byte pieces of a row
    const uint4* q_g = reinterpret_cast<const uint4*>(
        q + ((long)b * H + kh * G) * D);
    for (int c = threadIdx.x; c < kMaxG * kChunks; c += 32 * kBfWarps) {
      const int r = c / kChunks, col = c % kChunks;
      *reinterpret_cast<uint4*>(q_sm + r * (D + 8) + 8 * col) =
          r < G ? q_g[r * kChunks + col] : make_uint4(0, 0, 0, 0);
    }
    named_barrier_sync(1, 32 * kBfWarps);
    const uint32_t q_lane =
        smem_addr(q_sm + (lane & 15) * (D + 8) + 8 * (lane >> 4));
    // The rows this lane's ldmatrix addresses name in a tile (as
    // warp_scores and warp_pv address them), as byte offsets in a box.
    auto row_off = [&](int r) {
      return (uint32_t)(r / g * pitch + r % g * kRowBytes);
    };
    const uint32_t k_row = row_off((lane & 7) + ((lane >> 4) << 3));
    const uint32_t v_row = row_off((lane & 7) + (((lane >> 3) & 1) << 3));
    const uint32_t k_x = swizzle_xor(k_row, kRowBytes);
    const uint32_t v_x = swizzle_xor(v_row, kRowBytes);
    float acc[NO][4] = {};
    float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
    // Local tile j = warp + 4 i is in stage st, its use's parity phase: a
    // ring as long as the CTA's tiles never wraps, and a shorter one is a
    // multiple of the 4 warps, so a stage's uses are all this warp's.
    int st = warp;
    unsigned phase = 0;
    for (int j = warp; j < n; j += kBfWarps) {
      mbar_wait(full(st), phase);
      const unsigned bits = masks[st];
      const uint32_t k_tile = ring + st * st_bytes;
      float s[2][4];
      tile_scores<D>(q_lane, k_tile, box_bytes, k_row, k_x, s);
      const int r0 = (t_first + j) * kTile;
      warp_scale_mask<2>(s, scale_log2, [&](int, int c) {
        const int r = r0 + c;
        return ((bits >> c) & 1u) && r >= rows.lo && r < rows.hi;
      });
      warp_softmax<2, NO>(s, m, l, acc);
      tile_values<D>(s, k_tile + kBoxes * box_bytes, box_bytes, v_row, v_x,
                     acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
      st += kBfWarps;
      if (st >= stages) st -= stages, phase ^= 1;
    }
    warp_row_sum(l);
    // The warps' partials (rows 0..G-1 of each: the heads) go to the
    // ring's bytes once every consumer is done with the ring (the
    // producer's loads have all landed by then).
    named_barrier_sync(1, 32 * kBfWarps);
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
    for (int w = 0; w < kBfWarps; ++w)
      m_all = fmaxf(m_all, w_ml[(w * G + gg) * 2]);
    float l_all = 0.f;
#pragma unroll
    for (int w = 0; w < kBfWarps; ++w) {
      const float wt = exp2f(w_ml[(w * G + gg) * 2] - m_all);
      l_all += w_ml[(w * G + gg) * 2 + 1] * wt;
      w_ml[(w * G + gg) * 2] = wt;
    }
    part_ml[gg * 2] = m_all;
    part_ml[gg * 2 + 1] = l_all;
  }
  __syncthreads();
  for (int e = 4 * threadIdx.x; e < G * D; e += 4 * kBfThreads) {
    const int gg = e / D;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kBfWarps; ++w) {
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
  for (int i = sp * share + threadIdx.x; i < end; i += kBfThreads) {
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
    *reinterpret_cast<unsigned*>(o + ((long)b * H + kh * G + gg) * D + d) =
        pack_bf16(a0 / den, a1 / den);
  }
  // No CTA's shared memory goes while a peer reads it.
  cluster_sync_relaxed();
}

template <int D>
__global__ void __launch_bounds__(kBfThreads, kBfMinCtas)
    decode_bf16_kernel(
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ cache_len,
    __nv_bfloat16* __restrict__ o, int S, int H, int KV, int window, int per,
    int stages, float scale_log2) {
  const int b = blockIdx.y, len = cache_len[b];
  const DenseTiles rows{S, b, window >= 0 ? max(0, len - window) : 0,
                        min(len, S)};
  bf16_split<D>(&kmap, &vmap, q, rows, o, H, KV, per, stages, kTile,
                scale_log2);
}

template <int D>
__global__ void __launch_bounds__(kBfThreads, kBfMinCtas)
    paged_decode_bf16_kernel(
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __nv_bfloat16* __restrict__ q, const int* __restrict__ tables,
    const int* __restrict__ cache_len, __nv_bfloat16* __restrict__ o, int N,
    int bs, int M, int H, int KV, int per, int stages, float scale_log2) {
  const int b = blockIdx.y, len = cache_len[b];
  const PagedTiles rows{tables + (long)b * M, M, bs, N, 0,
                        min(len, M * bs)};
  bf16_split<D>(&kmap, &vmap, q, rows, o, H, KV, per, stages,
                piece_rows(bs), scale_log2);
}

// Launches a bf16 kernel on its (KV, B, n_split) grid as clusters of the
// n_split CTAs of one (b, kv head).
template <auto Kernel, typename... Args>
int launch_cluster(int max_smem, int KV, int B, int n_split, int smem,
                   cudaStream_t st, const Args&... args) {
  cudaError_t err = once_per_device<Kernel>(max_smem, true);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KV, B, n_split);
  cfg.blockDim = dim3(kBfThreads);
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

// -- the int8 pair: decode_split and the combine ------------------------------

constexpr int kDecWarps = 4;  // warps per CTA, each with its own tiles
constexpr int kDecThreads = 32 * kDecWarps;

// Merge the n_split partials of (b, kv head) in split order (a fixed
// order: the result does not depend on which CTA finished first).  One
// CTA per (kv head, b, query head): the splits' weights exp(m - m_all)
// are formed once in shared memory, then each thread sums its output
// dimension over the splits with the loads unrolled, so they are in
// flight together rather than one after another.
template <int D>
__global__ void __launch_bounds__(D) combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    __nv_bfloat16* __restrict__ o, int H, int KV, int n_split) {
  extern __shared__ float w_sm[];  // [n_split]: maxima, then weights
  const int kh = blockIdx.x, b = blockIdx.y, g = blockIdx.z;
  const int tid = threadIdx.x, G = H / KV;
  const long base = ((long)b * KV + kh) * n_split;
  for (int sp = tid; sp < n_split; sp += D)
    w_sm[sp] = part_ml[((base + sp) * kMaxG + g) * 2];
  __syncthreads();
  float m_all = REPRO_NEG_INF;
  for (int sp = 0; sp < n_split; ++sp) m_all = fmaxf(m_all, w_sm[sp]);
  __syncthreads();  // every thread has read the maxima
  for (int sp = tid; sp < n_split; sp += D)
    w_sm[sp] = expf(w_sm[sp] - m_all);
  __syncthreads();
  float l_all = 0.f, acc = 0.f;
#pragma unroll 8
  for (int sp = 0; sp < n_split; ++sp) {
    const long slot = (base + sp) * kMaxG + g;
    const float w = w_sm[sp];
    l_all += part_ml[slot * 2 + 1] * w;
    acc += part_acc[slot * D + tid] * w;
  }
  o[((long)b * H + kh * G + g) * D + tid] =
      __float2bfloat16(acc / fmaxf(l_all, 1e-30f));
}

// Row stride of a warp's widened bf16 K/V tiles: D plus a 16-byte pad, so
// ldmatrix reads are free of bank conflicts.
template <int D>
__host__ __device__ constexpr int dec_ld() { return D + 8; }

// Bytes of the bf16 (K, V) tile pair a warp widens its codes into.
template <int D>
__host__ __device__ constexpr int dec_tile_bytes() {
  return 2 * kTile * dec_ld<D>() * (int)sizeof(__nv_bfloat16);
}

// One warp's shared memory: the widened tile pair, then its stage of
// codes (a K and a V tile, row stride D bytes).
template <int D>
__host__ __device__ constexpr int q8_warp_bytes() {
  return dec_tile_bytes<D>() + 2 * kTile * D;
}

// The CTA's: its warps'; after the loop the same bytes hold the warps'
// partials for the CTA's merge.
template <int D>
constexpr int q8_smem_bytes() {
  constexpr int warps = kDecWarps * q8_warp_bytes<D>();
  constexpr int merge = kDecWarps * kMaxG * (D + 2) * (int)sizeof(float);
  return warps > merge ? warps : merge;
}

// Logical rows of one (b, kv head) of a dense (B, S, KV, D) cache: live
// rows are [lo, hi), the window start to min(cache_len, S).  offset(r)
// is the row's element offset, or -1 for a row that is not stored.
struct DenseRows {
  long base;    // element offset of (b, row 0, kh)
  long stride;  // KV * D
  int S, lo, hi;
  __device__ __forceinline__ long offset(int r) const {
    return r < S ? base + r * stride : -1;
  }
};

// Logical rows of one (b, kv head) in (N, bs, KV, D) pages through its
// block-table row: live rows are [0, min(cache_len, M * bs)) on pages of
// the pool (an entry outside [0, N) is never read, its rows masked).
struct PagedRows {
  const int* table;
  int M, bs, N;
  long stride;  // KV * D
  long kh_off;  // kh * D
  int lo, hi;
  __device__ __forceinline__ long offset(int r) const {
    const int page = r / bs;
    if (page >= M) return -1;
    const int phys = table[page];
    if (phys < 0 || phys >= N) return -1;
    return ((long)phys * bs + r % bs) * stride + kh_off;
  }
};

// int8 codes with one bf16 scale per (row, kv head), laid out as the
// codes with D = 1 (a row's scale index is its code offset / D).
struct Q8Cache {
  const int8_t* k;
  const int8_t* v;
  const __nv_bfloat16* ks;
  const __nv_bfloat16* vs;
};

// The bf16 bits of a row's K scale (low half) and V scale (high half).
__device__ __forceinline__ unsigned scale_bits(const Q8Cache& c, long i) {
  const auto* ks = reinterpret_cast<const unsigned short*>(c.ks);
  const auto* vs = reinterpret_cast<const unsigned short*>(c.vs);
  return (unsigned)__ldg(ks + i) | ((unsigned)__ldg(vs + i) << 16);
}

// 16 int8 codes (a 16-byte piece in shared memory) to bf16(code * scale),
// computed in f32, stored as two 16-byte pieces.  A code c becomes a float
// without a conversion instruction: byte c + 128 under the exponent of
// 2^23 is the float 2^23 + c + 128, and subtracting 2^23 + 128 is exact.
__device__ __forceinline__ void widen_piece(const int8_t* src, float scale,
                                            __nv_bfloat16* dst) {
  const int4 w = *reinterpret_cast<const int4*>(src);
  const unsigned words[4] = {(unsigned)w.x, (unsigned)w.y, (unsigned)w.z,
                             (unsigned)w.w};
  unsigned out[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned biased = words[i] ^ 0x80808080u;  // each byte c + 128
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = (__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + b)) -
              8388736.f) * scale;
    out[2 * i] = pack_bf16(f[0], f[1]);
    out[2 * i + 1] = pack_bf16(f[2], f[3]);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(out[0], out[1], out[2], out[3]);
  d[1] = make_uint4(out[4], out[5], out[6], out[7]);
}

// One int8 CTA's split: tiles [t_begin, t_end) of 16 logical rows, tile
// t_begin + w + 4 i to warp w; then the warps' partials merged in warp
// order and stored for combine_kernel (max in natural-log units).
template <int D, typename Rows>
__device__ __forceinline__ void decode_split(
    const __nv_bfloat16* __restrict__ q, const Q8Cache& cache,
    const Rows& rows, int b, int kh, int H, int G, int t_begin, int t_end,
    float scale_log2, float* __restrict__ part_acc,
    float* __restrict__ part_ml, long slot) {
  constexpr int LD = dec_ld<D>();
  constexpr int NO = D / 8;
  constexpr int kPieces = D / 16;  // 16-byte pieces of codes per row
  // Lanes that copy: all 32, except where a tile is fewer than 32 pieces
  // (D = 16: one piece a row, 16 a tile), where lanes 16-31 idle.
  constexpr int kLanes = kTile * kPieces < 32 ? kTile * kPieces : 32;
  constexpr int kRowsPerIt = kLanes / kPieces;  // rows one copy step covers
  constexpr int kIts = kTile * kPieces / kLanes;  // copy steps per tile
  static_assert(kIts >= 1 && kIts * kRowsPerIt == kTile, "copy shape");
  extern __shared__ __align__(16) unsigned char q8_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  unsigned char* mine = q8_smem + warp * q8_warp_bytes<D>();
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(mine);
  int8_t* kcodes = reinterpret_cast<int8_t*>(mine + dec_tile_bytes<D>());
  int8_t* vcodes = kcodes + kTile * D;

  // Heads kh * G + gid and kh * G + gid + 8 are rows gid and gid + 8 of
  // the A fragment; the rows past G are zero.
  unsigned qa[D / 16][4];
  const __nv_bfloat16* q_row = q + ((long)b * H + kh * G + gid) * D + 2 * tig;
  const bool top = gid < G, bottom = gid + 8 < G;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* p = q_row + 16 * kk;
    qa[kk][0] = top ? *reinterpret_cast<const unsigned*>(p) : 0u;
    qa[kk][1] = bottom ? *reinterpret_cast<const unsigned*>(p + 8 * D) : 0u;
    qa[kk][2] = top ? *reinterpret_cast<const unsigned*>(p + 8) : 0u;
    qa[kk][3] = bottom ? *reinterpret_cast<const unsigned*>(p + 8 * D + 8)
                       : 0u;
  }

  // This warp's tiles, past those wholly before the window.
  int t0 = t_begin + warp;
  const int t_lo = rows.lo / kTile;
  if (t0 < t_lo) t0 += (t_lo - t0 + kDecWarps - 1) / kDecWarps * kDecWarps;
  const int n = t0 < t_end ? (t_end - t0 + kDecWarps - 1) / kDecWarps : 0;
  // The bf16 bits of the scales of the lane's rows of the tile in flight
  // (K low, V high).
  unsigned sc[kIts] = {};
  // Copies tile i's codes into the stage and its scales into sc; returns
  // the tile's stored rows as bits (a row not stored is zero-filled, and
  // masked below).
  auto issue = [&](int i) {
    const int base = (t0 + i * kDecWarps) * kTile;
    unsigned stored = 0u;
#pragma unroll
    for (int it = 0; it < kIts; ++it) {
      const int p = lane + kLanes * it;
      const int r = p / kPieces, c = (p % kPieces) * 16;
      bool ok = false;
      if (lane < kLanes) {
        const long off = rows.offset(base + r);
        ok = off >= 0;
        cp_async16(kcodes + r * D + c, cache.k + (ok ? off : 0) + c, ok);
        cp_async16(vcodes + r * D + c, cache.v + (ok ? off : 0) + c, ok);
        sc[it] = ok ? scale_bits(cache, off / D) : 0u;
      }
      const unsigned vote = __ballot_sync(0xffffffffu, ok);
#pragma unroll
      for (int j = 0; j < kRowsPerIt; ++j)
        stored |= ((vote >> (j * kPieces)) & 1u) << (it * kRowsPerIt + j);
    }
    return stored;
  };
  // The lane widens the pieces it copied (so its own wait suffices).
  auto widen = [&] {
    if (lane >= kLanes) return;
#pragma unroll
    for (int it = 0; it < kIts; ++it) {
      const int p = lane + kLanes * it;
      const int r = p / kPieces, c = (p % kPieces) * 16;
      widen_piece(kcodes + r * D + c, __uint_as_float(sc[it] << 16),
                  wide + r * LD + c);
      widen_piece(vcodes + r * D + c, __uint_as_float(sc[it] & 0xffff0000u),
                  wide + (kTile + r) * LD + c);
    }
  };

  float acc[NO][4] = {};
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
  unsigned stored = n > 0 ? issue(0) : 0u;
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    // Tile i has landed (this lane's copies); the lane widens them and
    // refills the same bytes with tile i + 1, in flight while tile i is
    // attended.
    cp_async_wait<0>();
    widen();
    const unsigned stored_next = i + 1 < n ? issue(i + 1) : 0u;
    cp_async_commit();
    __syncwarp();  // every lane's widened pieces are in
    const int base = (t0 + i * kDecWarps) * kTile;
    float s[2][4];
    warp_scores<D, 2>(qa, wide, LD, s);
    warp_scale_mask<2>(s, scale_log2, [&](int, int c) {
      const int r = base + c;
      return ((stored >> c) & 1u) && r >= rows.lo && r < rows.hi;
    });
    warp_softmax<2, NO>(s, m, l, acc);
    warp_pv<D, 2>(s, wide + kTile * LD, LD, acc);
    __syncwarp();  // the widened tile is refilled later
    stored = stored_next;
  }
  cp_async_wait<0>();
  warp_row_sum(l);

  // Merge the warps (rows 0..G-1 of each: the heads) through shared
  // memory.
  __syncthreads();  // every warp is done with its stage
  float* acc_sm = reinterpret_cast<float*>(q8_smem);  // [warp][kMaxG][D]
  float* ml_sm = acc_sm + kDecWarps * kMaxG * D;      // [warp][kMaxG][2]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (gid + 8 * h >= G) continue;
    const int row = warp * kMaxG + gid + 8 * h;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc_sm[row * D + 8 * j + 2 * tig] = acc[j][2 * h];
      acc_sm[row * D + 8 * j + 2 * tig + 1] = acc[j][2 * h + 1];
    }
    if (tig == 0) {
      ml_sm[row * 2] = m[h];
      ml_sm[row * 2 + 1] = l[h];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < G * D; e += kDecThreads) {
    const int g = e / D, d = e % D;
    float m_all = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      m_all = fmaxf(m_all, ml_sm[(w * kMaxG + g) * 2]);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      a += acc_sm[(w * kMaxG + g) * D + d] *
           exp2f(ml_sm[(w * kMaxG + g) * 2] - m_all);
    part_acc[(slot * kMaxG + g) * D + d] = a;
  }
  if ((int)threadIdx.x < G) {
    const int g = threadIdx.x;
    float m_all = REPRO_NEG_INF;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      m_all = fmaxf(m_all, ml_sm[(w * kMaxG + g) * 2]);
    float l_all = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      l_all += ml_sm[(w * kMaxG + g) * 2 + 1] *
               exp2f(ml_sm[(w * kMaxG + g) * 2] - m_all);
    part_ml[(slot * kMaxG + g) * 2] = m_all * REPRO_LN2;
    part_ml[(slot * kMaxG + g) * 2 + 1] = l_all;
  }
}

template <int D>
__global__ void __launch_bounds__(kDecThreads, dec_min_ctas<D>())
    decode_q8_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
    const int8_t* __restrict__ v, const __nv_bfloat16* __restrict__ ks,
    const __nv_bfloat16* __restrict__ vs, const int* __restrict__ cache_len,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int S, int H,
    int KV, int tiles_per_split, float scale_log2) {
  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int len = cache_len[b];
  const DenseRows rows{((long)b * S * KV + kh) * D, (long)KV * D, S, 0,
                       min(len, S)};
  const int t_end =
      min((sp + 1) * tiles_per_split, (rows.hi + kTile - 1) / kTile);
  decode_split<D>(q, Q8Cache{k, v, ks, vs}, rows, b, kh, H, H / KV,
                  sp * tiles_per_split, t_end, scale_log2, part_acc, part_ml,
                  ((long)b * KV + kh) * gridDim.z + sp);
}

template <int D>
__global__ void __launch_bounds__(kDecThreads, dec_min_ctas<D>())
    paged_decode_q8_kernel(
    const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kp,
    const int8_t* __restrict__ vp, const __nv_bfloat16* __restrict__ ksp,
    const __nv_bfloat16* __restrict__ vsp, const int* __restrict__ tables,
    const int* __restrict__ cache_len, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int N, int bs, int M, int H, int KV,
    int tiles_per_split, float scale_log2) {
  const int kh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int len = cache_len[b];
  const PagedRows rows{tables + (long)b * M, M, bs, N, (long)KV * D,
                       (long)kh * D, 0, min(len, M * bs)};
  const int t_end =
      min((sp + 1) * tiles_per_split, (rows.hi + kTile - 1) / kTile);
  decode_split<D>(q, Q8Cache{kp, vp, ksp, vsp}, rows, b, kh, H, H / KV,
                  sp * tiles_per_split, t_end, scale_log2, part_acc, part_ml,
                  ((long)b * KV + kh) * gridDim.z + sp);
}

// Launches an int8 kernel on its (KV, B, n_split) grid, n_split =
// ceil(n_tiles / tiles_per_split), then the combine.
template <int D, auto Kernel, typename... Args>
int launch_split(int n_tiles, int B, int H, int KV, int tiles_per_split,
                 void* part_acc, void* part_ml, void* o, cudaStream_t st,
                 Args... args) {
  constexpr int smem = q8_smem_bytes<D>();
  const cudaError_t err = once_per_device<Kernel>(smem, false);
  if (err != cudaSuccess) return (int)err;
  const int n_split = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  Kernel<<<dim3(KV, B, n_split), kDecThreads, smem, st>>>(args...);
  combine_kernel<D><<<dim3(KV, B, H / KV), D, n_split * sizeof(float), st>>>(
      (const float*)part_acc, (const float*)part_ml, (__nv_bfloat16*)o, H,
      KV, n_split);
  return (int)cudaGetLastError();
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

// Shapes every kernel takes: G = H / KV whole and at most kMaxG, a
// positive split.
bool bad_split(int H, int KV, int tiles_per_split) {
  return KV < 1 || H % KV || H / KV > kMaxG || tiles_per_split < 1;
}

// Splits of a bf16 launch over `n_tiles` tiles: one cluster, so at most
// kMaxCluster.
int cluster_splits(int n_tiles, int tiles_per_split) {
  const int n = (n_tiles + tiles_per_split - 1) / tiles_per_split;
  return n < 1 ? 1 : n;
}

using bf16_t = __nv_bfloat16;

}  // namespace

// Every entry point: n_tiles = ceil(rows / 16), rows = S dense and M * bs
// paged (pages of 1-64 rows), split into n_split = ceil(n_tiles /
// tiles_per_split) CTAs a (b, kv head).  q (B, H, D) bf16, H / KV up to
// 16; o (B, H, D) bf16.  The bf16 entry points launch n_split as one
// cluster (at most 16) and take no scratch; the int8 ones take part_acc
// (B, KV, n_split, 16, D) f32 and part_ml (B, KV, n_split, 16, 2) f32
// scratch, allocated by the caller.

// bf16 cache k, v (B, S, KV, D); `block` must be 16.
extern "C" int repro_decode_attention_bf16(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* o, int B, int S, int H, int KV, int D, int block, int window,
    int tiles_per_split, float scale, void* stream) {
  if (bad_split(H, KV, tiles_per_split) || block != kTile)
    return (int)cudaErrorInvalidValue;
  const int n_split =
      cluster_splits((S + kTile - 1) / kTile, tiles_per_split);
  if (n_split > kMaxCluster) return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    CUtensorMap kmap, vmap;
    int err = encode_rows<kD>(&kmap, k, B, S, KV, kTile);
    if (!err) err = encode_rows<kD>(&vmap, v, B, S, KV, kTile);
    if (err) return err;
    const int stages = ring_stages<kD>(tiles_per_split, kTile);
    return launch_cluster<decode_bf16_kernel<kD>>(
        bf16_max_smem<kD>(), KV, B, n_split,
        bf16_smem_bytes<kD>(stages, H / KV, kTile), (cudaStream_t)stream,
        kmap, vmap, (const bf16_t*)q, (const int*)cache_len, (bf16_t*)o, S,
        H, KV, window, tiles_per_split, stages, scale * REPRO_LOG2E);
  });
}

// int8 codes k, v (B, S, KV, D) with bf16 scales ks, vs (B, S, KV, 1);
// `block` must be 16.  No window (the reference has none).
extern "C" int repro_decode_attention_q8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* cache_len, void* part_acc, void* part_ml,
    void* o, int B, int S, int H, int KV, int D, int block,
    int tiles_per_split, float scale, void* stream) {
  if (bad_split(H, KV, tiles_per_split) || block != kTile)
    return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return launch_split<kD, decode_q8_kernel<kD>>(
        (S + kTile - 1) / kTile, B, H, KV, tiles_per_split, part_acc,
        part_ml, o, (cudaStream_t)stream, (const bf16_t*)q, (const int8_t*)k,
        (const int8_t*)v, (const bf16_t*)ks, (const bf16_t*)vs,
        (const int*)cache_len, (float*)part_acc, (float*)part_ml, S, H, KV,
        tiles_per_split, scale * REPRO_LOG2E);
  });
}

// bf16 pages (N, bs, KV, D) through int32 tables (B, M).
extern "C" int repro_paged_decode_attention_bf16(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* cache_len, void* o, int B, int N, int bs,
    int M, int H, int KV, int D, int tiles_per_split, float scale,
    void* stream) {
  if (bad_split(H, KV, tiles_per_split) || bs < 1 || bs > kMaxT)
    return (int)cudaErrorInvalidValue;
  const int n_split =
      cluster_splits((M * bs + kTile - 1) / kTile, tiles_per_split);
  if (n_split > kMaxCluster) return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const int g = piece_rows(bs);
    CUtensorMap kmap, vmap;
    int err = encode_rows<kD>(&kmap, k_pages, N, bs, KV, g);
    if (!err) err = encode_rows<kD>(&vmap, v_pages, N, bs, KV, g);
    if (err) return err;
    const int stages = ring_stages<kD>(tiles_per_split, g);
    return launch_cluster<paged_decode_bf16_kernel<kD>>(
        bf16_max_smem<kD>(), KV, B, n_split,
        bf16_smem_bytes<kD>(stages, H / KV, g), (cudaStream_t)stream, kmap,
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
    const void* cache_len, void* part_acc, void* part_ml, void* o, int B,
    int N, int bs, int M, int H, int KV, int D, int tiles_per_split,
    float scale, void* stream) {
  if (bad_split(H, KV, tiles_per_split) || bs < 1 || bs > kMaxT)
    return (int)cudaErrorInvalidValue;
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return launch_split<kD, paged_decode_q8_kernel<kD>>(
        (M * bs + kTile - 1) / kTile, B, H, KV, tiles_per_split, part_acc,
        part_ml, o, (cudaStream_t)stream, (const bf16_t*)q,
        (const int8_t*)k_pages, (const int8_t*)v_pages,
        (const bf16_t*)ks_pages, (const bf16_t*)vs_pages,
        (const int*)tables, (const int*)cache_len, (float*)part_acc,
        (float*)part_ml, N, bs, M, H, KV, tiles_per_split,
        scale * REPRO_LOG2E);
  });
}

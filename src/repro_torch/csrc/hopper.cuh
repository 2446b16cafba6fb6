// Hopper (sm_90a) building blocks of the port's kernels, in inline PTX:
// mbarriers, TMA tile loads and the host's tensor-map encoder, cluster
// barriers and distributed shared memory, warpgroup matrix products
// (wgmma) and their shared-memory descriptors, and warpgroup register
// reallocation (setmaxnreg).  The flash kernel is built from them, and so
// are the decode kernels (mbarriers, TMA and clusters; their products
// stay on mma.sync).
//
// Shared tiles are written by TMA with a 32-, 64- or 128-byte swizzle
// and read by wgmma through a descriptor of the same
// swizzle: a row of one box holds 16, 32 or 64 bf16, rows lie one box
// row apart, 8 rows form one swizzle atom, and a tile base is aligned to
// 1024 bytes.  A K-major operand (the reduction runs along a row) steps
// through a row 32 bytes per k16 product; an MN-major one (wgmma's
// transposed B: the reduction runs down the rows) steps 16 rows.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads (with the __syncthreads that follows).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One arrival on `bar` once this thread's earlier cp.async copies have
// landed (an arrival the barrier's count includes).
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// -- named barriers ----------------------------------------------------------

// Barrier `id` (1-15; 0 is __syncthreads') over `count` threads of the
// CTA, whole warps.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// -- TMA ---------------------------------------------------------------------

// Row bytes of one box at D bf16 per row, and the swizzle that matches
// it: D = 16, 32 rows of 32 and 64 bytes; D >= 64 boxes of 64 (128 bytes).
__host__ __device__ constexpr int box_cols(int d) { return d < 64 ? d : 64; }
__host__ __device__ constexpr int box_row_bytes(int d) {
  return 2 * box_cols(d);
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// One box of a 4-d tensor map at coordinates (c0 innermost .. c3) into
// shared memory at `dst`, completing its bytes on `bar`.  Elements out of
// the tensor's bounds are filled with zeros (and still counted).
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver through the runtime (so the
// library links no libcuda).
inline EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of an (outer, rows, heads, d) tensor of `elem`-byte elements,
// in boxes of `box_rows` rows by `cols` elements of one head, swizzled to
// the box's row bytes (32, 64 or 128; none at 16); boxes reaching past the
// tensor read zeros.
inline int encode_boxes(CUtensorMap* map, CUtensorMapDataType type,
                        int elem, const void* base, int d, int outer,
                        int rows, int heads, int cols, int box_rows) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)elem * d;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)outer};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * rows};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const int row_bytes = elem * cols;
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : row_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                        : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = fn(map, type, 4, const_cast<void*>(base), dims, strides,
                        box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The map of an (outer, rows, heads, D) bf16 tensor in boxes of box_cols(D)
// dims.  Flash maps (batch, rows, heads) in boxes of 64 rows, dense decode
// (batch, S, kv heads) in boxes of 16, paged decode (pages, page rows, kv
// heads) in boxes of the rows a piece of one page holds.
template <int D>
inline int encode_rows(CUtensorMap* map, const void* base, int outer,
                       int rows, int heads, int box_rows) {
  return encode_boxes(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, D,
                      outer, rows, heads, box_cols(D), box_rows);
}

// The same over int8 codes, a box row a whole row of D codes (16-128
// bytes).
template <int D>
inline int encode_codes(CUtensorMap* map, const void* base, int outer,
                        int rows, int heads, int box_rows) {
  return encode_boxes(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, D, outer,
                      rows, heads, D, box_rows);
}

// The XOR a TMA swizzle applies to the 16-byte chunks of the box row at
// byte offset `row_off` (a multiple of `row_bytes`) from a base aligned
// to the swizzle's repeat (8 rows of `row_bytes`): a chunk's offset bits
// 4.. XOR the row's address bits 7.., as many bits as a row has chunks.
__host__ __device__ constexpr uint32_t swizzle_xor(uint32_t row_off,
                                                   int row_bytes) {
  return ((row_off >> 7) & (uint32_t)(row_bytes / 16 - 1)) << 4;
}

// -- thread block clusters ---------------------------------------------------

// Every thread of every CTA of the cluster arrives (its earlier shared
// memory writes released to the cluster), then waits for all of them.
// The warp reconverges first: the barrier is .aligned.  The release
// compiles to MEMBAR.ALL.GPU before the arrive, and the acquire to an L1
// invalidation after the wait.
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The same barrier with nothing to release: where a CTA only waits until
// its peers are done reading its shared memory (their loads have
// returned), its own earlier writes need not be made visible first.
__device__ __forceinline__ void cluster_sync_relaxed() {
  __syncwarp();
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::
          : "memory");
}

// The distributed shared-memory address of shared address `addr` in the
// CTA of cluster rank `rank`.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr,
                                                unsigned rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float2 ld_cluster2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// -- warpgroup register reallocation -----------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -- wgmma -------------------------------------------------------------------

// A wgmma shared-memory descriptor: start address, leading and stride
// byte offsets (in 16-byte units), layout type 1 / 2 / 3 for the 128- /
// 64- / 32-byte swizzle.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo,
                                               int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major tile of boxes with `row_bytes`-byte rows: 8 rows (one swizzle
// atom) lie 8 * row_bytes apart; the leading offset is unused.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr,
                                                 int row_bytes) {
  return wgmma_desc(addr, 16, 8 * row_bytes, row_bytes);
}

// MN-major (transposed B) tile: 8 k-rows one atom apart, and the next
// box's columns `box_bytes` on.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr,
                                                  int row_bytes,
                                                  uint32_t box_bytes) {
  return wgmma_desc(addr, box_bytes, 8 * row_bytes, row_bytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers in place around the asynchronous products: the
// compiler may neither read an accumulator before the wait that
// completes it nor reuse a register a product still reads.
template <int R, int C>
__device__ __forceinline__ void fence_regs(float (&r)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+f"(r[i][j])::"memory");
}

template <int R, int C>
__device__ __forceinline__ void fence_regs(unsigned (&r)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Accumulator layout of m64nNk16 (f32): warp w of the warpgroup holds
// rows 16 w .. 16 w + 15; element e of n8 tile j is row gid + 8 (e >> 1),
// column 8 j + 2 tig + (e & 1) (lane = 4 gid + tig), as mma.sync's C.
// The register A operand (bf16, 16 x 16 a warp) is mma.sync's A
// fragment, so two adjacent n8 tiles of scores, rounded to bf16, are the
// A operand of the next product.

// d (64 x 64, f32) = (scale_d ? d : 0) + A . B, A and B from shared memory
// (K-major, descriptors).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4],
                                             uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x N, f32) += A . B, A (64 x 16 bf16) from registers, B (16 x N)
// from shared memory, transposed (MN-major: N runs along a row).
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 8][4],
                                            const unsigned (&a)[4],
                                            uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs_tb<16>(float (&d)[2][4],
                                                const unsigned (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<32>(float (&d)[4][4],
                                                const unsigned (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[8][4],
                                                const unsigned (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[16][4],
                                                const unsigned (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

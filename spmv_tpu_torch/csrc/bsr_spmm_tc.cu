// Kernel K7, tensor-core path: BSR SpMM Y = A X for bfloat16 blocks of
// 64 or 128 rows, X of shape (num_columns, k) in bfloat16 with k a
// multiple of 8 and a 16-byte aligned base, Y (num_rows, k) in float32,
// row-major.  The register-tiled SIMT path (bsr_spmm.cu) takes every
// other case; the wrapper (ops/bsr_kernels.py, ``bsr_path``) picks the
// path from the shape alone.
//
// Replaces, with bsr_spmm.cu, both Pallas kernels of
// spmv_tpu/ops/pallas_kernels.py that bsr_spmm (:954) dispatches to:
// K7a _bsr_spmm_kernel (:896, pallas_call :1045) and K7b
// _bsr_spmm_wholex_kernel (:918, pallas_call :1001).  Same function:
//
//   Y[r * bh + i, j] = sum_t sum_c blocks[t, i, c] * X[block_col[t] * 128 + c, j]
//
// over block row r's blocks [row_ptr[r], row_ptr[r + 1]) in storage
// order, X rows at or past num_columns read as 0, products of bfloat16
// values summed in float32.
//
// What bounds it on an H100: bytes.  A (128, 128) block and its (128,
// 128) X tile do 2 * 128^3 flops for 32 KB of block: 128 flops a byte,
// under the card's 295 (989 TFLOP/s bf16 over 3.35 TB/s), so the design
// keeps the block stream flowing and leaves the math to the tensor cores.
//
// The design (Hopper's TMA + wgmma):
// - One CTA per (block row, tile of 128 columns of X); a block row's
//   column tiles are neighbours in the grid, so their block re-reads hit
//   the L2.  Its 192 KB ring of stages makes it one CTA an SM; a grid
//   that walks tiles persistently, static round-robin, came out slower
//   than the hardware's own scheduling of one tile a CTA.
// - A stage holds one whole block and its X tile: two (bh, 64) boxes of
//   the block and two (128, 64) boxes of X (64 bf16 columns, 128 B, is
//   the widest box the 128-byte swizzle takes), 64 KB at bh = 128; three
//   stages.  Both halves of a block are asked for at once, so each
//   256-byte row of it leaves the HBM in one piece (a stage of half a
//   block read each row twice through the L2).
// - One producer warp: one thread issues the TMA loads
//   (cp.async.bulk.tensor.2d, 128-byte swizzle) through two tensor maps,
//   the blocks seen as a (num_blocks * bh, 128) matrix and X as
//   (num_columns, k), completing on the stage's "full" mbarrier.  X's
//   rows past num_columns and columns past k are out of the map's bounds
//   and arrive as zeros, which gives the "X past num_columns reads 0"
//   rule and the ragged last column tile for free.  Blocks are read once
//   (L2 evict-first), X tiles again by other block rows (evict-last), and
//   Y is written with streaming stores, so that X can stay in the L2.
// - bh / 64 consumer warpgroups, one per 64 rows of the block: eight
//   wgmma.mma_async m64n128k16 (bf16 x bf16 -> f32) a block, A (the
//   block, K-major) and B (X, row-major, so MN-major: the transposed-B
//   flag) read straight from the swizzled stage; the accumulators stay in
//   registers across the block row's whole run, and each thread stores
//   its fragment straight to Y after the row's last block.  A consumer
//   warp frees the stage on its "empty" mbarrier once its wgmmas are done.
// - wgmma rather than mma.sync: it reads both operands from the TMA's
//   swizzled tiles with no ldmatrix and no register staging, which
//   leaves the consumer warps nothing to do but wait for bytes.
// - No atomics and a fixed order (blocks in storage order, k-steps
//   ascending), so two launches give bitwise equal Y.  The
//   tensor cores sum each k-step's 16 products in their own order and
//   rounding, so Y differs from a float32 sequential sum by rounding.
// - Rows past num_rows and columns past k are never written.  Y must not
//   overlap X.
//
// The tensor maps are encoded on the host for each launch with
// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point (no -lcuda), and passed by value as __grid_constant__ kernel
// parameters, so a CUDA graph captures them with the launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mbarrier.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kBlockCols = 128;    // a BSR block's width
constexpr int kBox = 64;           // columns of a TMA box: 128 B of bf16
constexpr int kTileN = 128;        // output columns a CTA computes
constexpr int kStages = 3;
constexpr int kSwizzleSpan = 1024; // 8 rows of 128 B: the swizzle's period
constexpr size_t kDefaultSmem = 48 * 1024;

template <int BH>
struct TcShape {
  static constexpr int kConsumers = BH / 64;  // warpgroups, 64 rows each
  static constexpr int kThreads = kConsumers * 128 + 32;
  static constexpr int kABytes = BH * kBlockCols * 2;      // two (BH, 64) boxes
  static constexpr int kXBytes = kBlockCols * kTileN * 2;  // two (128, 64) boxes
  static constexpr int kStageBytes = kABytes + kXBytes;
  static constexpr size_t kSmem = kStages * kStageBytes + kSwizzleSpan;
};

// One box of a 2-D tensor map into shared memory; c0 is the inner
// (column) coordinate, c1 the row.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "l"(policy)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, f32) += A (64 x 16, K-major) * B (16 x 128, MN-major).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n\t"
      "}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <int BH>
__global__ void __launch_bounds__(TcShape<BH>::kThreads, 1)
    bsr_tc_kernel(const __grid_constant__ CUtensorMap blocks_map,
                  const __grid_constant__ CUtensorMap x_map,
                  const int* __restrict__ block_col,
                  const int* __restrict__ row_ptr, int num_col_tiles,
                  int64_t num_rows, int k, float* __restrict__ Y) {
  using S = TcShape<BH>;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  extern __shared__ unsigned char tc_smem[];
  // the stages start on the swizzle's 1024-byte period
  unsigned char* smem =
      tc_smem + (kSwizzleSpan - smem_addr(tc_smem) % kSwizzleSpan) %
                    kSwizzleSpan;
  const int64_t br = blockIdx.x / num_col_tiles;
  const int n0 = (blockIdx.x % num_col_tiles) * kTileN;
  const int t0 = row_ptr[br];
  const int count = row_ptr[br + 1] - t0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == S::kConsumers * 4) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      const uint64_t stream = l2_evict_first();
      const uint64_t keep = l2_evict_last();
      for (int q = 0; q < count; ++q) {
        const int s = q % kStages;
        if (q >= kStages) mbar_wait(&empty[s], (q / kStages - 1) & 1);
        const int t = t0 + q;
        unsigned char* a = smem + s * S::kStageBytes;
        unsigned char* x = a + S::kABytes;
        mbar_expect_tx(&full[s], S::kStageBytes);
        tma_load(a, &blocks_map, &full[s], 0, t * BH, stream);
        tma_load(a + S::kABytes / 2, &blocks_map, &full[s], kBox, t * BH,
                 stream);
        const int xrow = block_col[t] * kBlockCols;
        tma_load(x, &x_map, &full[s], n0, xrow, keep);
        tma_load(x + S::kXBytes / 2, &x_map, &full[s], n0 + kBox, xrow, keep);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg * 64 .. wg * 64 + 63 of a block
  const int wg = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  for (int q = 0; q < count; ++q) {
    const int s = q % kStages;
    mbar_wait(&full[s], (q / kStages) & 1);
    const uint32_t a = smem_addr(smem + s * S::kStageBytes) + wg * 64 * 128;
    const uint32_t x = smem_addr(smem + s * S::kStageBytes + S::kABytes);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBlockCols / 16; ++kk) {
      // A: columns 16 kk.. of the block, in its (kk / 4)-th box, 32 B
      // along each swizzled 128-B row; B: rows 16 kk.. of the X tile
      // (2 KB each), its second 64-column box 16 KB on
      wgmma_m64n128k16(
          acc,
          sw128_desc(a + (kk / 4) * (S::kABytes / 2) + (kk % 4) * 32, 16,
                     1024),
          sw128_desc(x + kk * 2048, S::kXBytes / 2, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // accumulator fragment: values i, i + 1 of thread (warp w, lane l)
  // are row 16 (w % 4) + l / 4 + 8 ((i / 2) % 2), columns 8 (i / 4) +
  // 2 (l % 4) and one on; streaming stores keep Y out of the way of X
  // in the L2
  const int64_t row0 = br * BH + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int64_t row = row0 + 8 * ((i / 2) % 2);
    const int col = col0 + 8 * (i / 4);
    if (row < num_rows && col < k)
      __stcs(reinterpret_cast<float2*>(Y + row * k + col),
             make_float2(acc[i], acc[i + 1]));
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded, or nullptr.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D bf16 map of a row-major (rows, cols) matrix, boxes of (box_rows,
// 64) with the 128-byte swizzle; reads out of bounds fill zeros.
bool encode(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
            uint32_t box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {kBox, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BH>
cudaError_t launch(const void* blocks, const void* block_col,
                   const void* row_ptr, int64_t num_blocks,
                   int64_t num_block_rows, int64_t num_rows,
                   int64_t num_columns, int k, const void* X, void* Y,
                   cudaStream_t stream) {
  using S = TcShape<BH>;
  const int64_t col_tiles = (static_cast<int64_t>(k) + kTileN - 1) / kTileN;
  const int64_t grid = num_block_rows * col_tiles;
  if (grid > 0x7fffffff || num_blocks * BH > 0x7fffffff ||
      num_columns > 0x7fffffff)
    return cudaErrorInvalidValue;
  CUtensorMap blocks_map, x_map;
  if (!encode(&blocks_map, blocks, num_blocks * BH, kBlockCols, BH) ||
      !encode(&x_map, X, num_columns, k, kBlockCols))
    return cudaErrorInvalidValue;
  if (S::kSmem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        bsr_tc_kernel<BH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::kSmem));
    if (e != cudaSuccess) return e;
  }
  bsr_tc_kernel<BH><<<static_cast<unsigned>(grid), S::kThreads, S::kSmem,
                      stream>>>(
      blocks_map, x_map, static_cast<const int*>(block_col),
      static_cast<const int*>(row_ptr), static_cast<int>(col_tiles),
      num_rows, k, static_cast<float*>(Y));
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launch (0 on success; invalid value for
// a shape this path does not take, or a tensor map the driver refuses).
// blocks (num_blocks, block_rows, 128) and X (num_columns, k) are
// bfloat16 with 16-byte aligned bases, block_rows is 64 or 128, k a
// multiple of 8; Y (num_rows, k) is float32 with an 8-byte aligned base;
// block_col and row_ptr are int32.
extern "C" int bsr_tc_launch(int device, const void* blocks,
                             const void* block_col, const void* row_ptr,
                             int block_rows, long long num_blocks,
                             long long num_block_rows, long long num_rows,
                             long long num_columns, int k, const void* X,
                             void* Y, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (num_block_rows == 0 || k == 0) return cudaSuccess;
  if (k < 0 || k % 8 != 0 || num_blocks <= 0 || num_columns <= 0 ||
      reinterpret_cast<uintptr_t>(blocks) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(X) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(Y) % 8 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_rows) {
    case 64:
      return launch<64>(blocks, block_col, row_ptr, num_blocks,
                        num_block_rows, num_rows, num_columns, k, X, Y, s);
    case 128:
      return launch<128>(blocks, block_col, row_ptr, num_blocks,
                         num_block_rows, num_rows, num_columns, k, X, Y, s);
    default:
      return cudaErrorInvalidValue;
  }
}

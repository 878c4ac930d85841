// Kernel K7, register-tiled SIMT path: BSR SpMM, Y = A X over dense
// (block_rows x 128) blocks, X of shape (num_columns, k) in the blocks'
// type and Y of shape (num_rows, k) in the accumulator type, row-major.
// It takes float32 and float64 blocks, and bfloat16 blocks outside the
// tensor-core path's shapes (bsr_spmm_tc.cu: bh 64 or 128, k a multiple
// of 8, X 16-byte aligned); the wrapper (ops/bsr_kernels.py,
// ``bsr_path``) picks the path from the shape alone.
//
// Replaces, with bsr_spmm_tc.cu, both Pallas kernels of
// spmv_tpu/ops/pallas_kernels.py that bsr_spmm (:954) dispatches to:
//   K7a _bsr_spmm_kernel (line 896, pallas_call :1045): X streamed, one
//       (128, k) tile per block, when X is larger than 80 MB;
//   K7b _bsr_spmm_wholex_kernel (line 918, pallas_call :1001): X resident
//       in VMEM when it fits (_BSR_WHOLEX_BYTES, :946).
// The two differ only in where X lives on the TPU, a residency choice of
// its 128 MB VMEM.  On Hopper an X tile reaches shared memory through L2
// either way, so one CUDA kernel (a path each) is the counterpart of both.
//
// What it computes.  Block row r's blocks are [row_ptr[r], row_ptr[r+1])
// in storage order:
//
//   Y[r * bh + i, j] = sum_t sum_c blocks[t, i, c] * X[block_col[t] * 128 + c, j]
//
// with X rows at or past num_columns read as 0 (the zero-padded X of the
// Pallas kernels).  float32 and float64 blocks accumulate in their own
// type, in exact arithmetic of that type (no TF32); bfloat16 blocks (and
// their bfloat16 X) accumulate in float32 and Y is float32, bsr_spmm's
// contract (:957-962).
//
// The port's containers store no zero-padding blocks (BsrKernel builds
// DeviceBsr with blocks_per_step = 1): a stated deviation from the JAX
// container, whose padding blocks point at column block 0, so that an inf
// or NaN there turns the whole block row into NaN (0 * inf) where the
// port gives the finite product.  A container padded as JAX pads it
// still gives JAX's result here: the kernel walks whatever row_ptr holds.
//
// What bounds it on an H100: operations.  A 128 x 128 block does
// 2 * 128 * 128 * k flops for 128 * 128 values streamed, 64 flops a byte
// at k = 128 in float32, far above the card's 20 flops a byte (67 TFLOP/s
// float32 over 3.35 TB/s); a small k is bound by the block stream.
//
// The design: an SGEMM-style register tile on CUDA cores.
// - One CUDA block of 256 threads per (block row, tile of kCols columns
//   of X); a block row's column tiles are neighbours in the grid, so they
//   read its blocks from L2 at about the same time.  The tile is 128 rows
//   (any bh up to 128; the rows past bh compute on stale shared memory
//   and are never stored) by kCols columns, each thread TM x TN of it:
//   8 x 8 at k > 32 (float64 4 x 8), 4 x 4 at k <= 32, 1 x 4 at k <= 8
//   (k = 1 is the SpMV of `-s bsr --cg`).
// - A block is consumed in chunks of 32 of its 128 columns.  A chunk's
//   (bh, 32) block slice (rows padded by 16 bytes, so a warp's vector
//   reads of neighbouring rows fall in distinct banks) and its (32, kCols)
//   X slice are staged by cp.async in a ring of three stages, so the next
//   chunks arrive while this one is multiplied.  X's out-of-range rows
//   and columns are zero-filled by the copy.  Where X's rows are not
//   16-byte multiples (k = 1, k = 3, ...), X goes an element a copy.
// - Each step of four columns of the chunk: a thread reads four values of
//   each of its TM block rows and four X rows of its TN columns (16-byte
//   vector loads from shared memory) and does 4 TM TN FMAs in registers.
// - No atomics and a fixed order of every sum (blocks in storage order,
//   columns c ascending, one FMA chain an output), so two launches give
//   bitwise equal Y.  The order differs from the Pallas kernels' pairwise
//   _tree_sum over a step's blocks (:883): results agree to rounding, not
//   bit for bit.
// - The Y tile is written once, after the row's last block.  Rows past
//   num_rows are never written, so Y can be an exactly (num_rows, k)
//   buffer.  Y must not overlap X.

#include <cstdint>

#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kBlockCols = 128;
constexpr int kRows = 128;     // rows of a CTA's tile: any bh up to 128
constexpr int kChunk = 32;     // block columns a stage holds
constexpr int kStages = 3;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zeros where !ok.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// One value from global to shared memory, zero where !ok: cp.async for
// 4- and 8-byte types, a plain load for bfloat16 (cp.async copies 4
// bytes at least).
__device__ __forceinline__ void copy1(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void copy1(double* dst, const double* src,
                                      bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void copy1(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16(0.0f);
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Four consecutive values from shared memory, in the accumulator type.
__device__ __forceinline__ void load4(const float* p, float (&a)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}
__device__ __forceinline__ void load4(const double* p, double (&a)[4]) {
  const double2 v0 = *reinterpret_cast<const double2*>(p);
  const double2 v1 = *reinterpret_cast<const double2*>(p + 2);
  a[0] = v0.x;
  a[1] = v0.y;
  a[2] = v1.x;
  a[3] = v1.y;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&a)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  a[0] = lo.x;
  a[1] = lo.y;
  a[2] = hi.x;
  a[3] = hi.y;
}

// A thread computes TM x TN outputs: rows ty + RG i (i < TM) and columns
// tx 4 + CG 4 j + e (j < TN / 4, e < 4) of its CTA's (128, CG TN) tile.
template <typename T, int TM, int TN, int RG, int CG>
struct Tile {
  static_assert(RG * CG == kThreads && RG * TM == kRows && TN % 4 == 0,
                "tile shape");
  static constexpr int kCols = CG * TN;                        // X columns
  static constexpr int kPitch = kChunk + 16 / int(sizeof(T));  // A row pitch
  static constexpr int kStageElems = kRows * kPitch + kChunk * kCols;
  static constexpr size_t kSmem = size_t(kStages) * kStageElems * sizeof(T);
  static constexpr int kPer = 16 / int(sizeof(T));  // values a 16-B copy
};

template <typename T, typename Acc, int TM, int TN, int RG, int CG>
__global__ void __launch_bounds__(kThreads, (sizeof(T) == 8 ? 1 : 2))
    bsr_simt_kernel(const T* __restrict__ blocks,
                    const int* __restrict__ block_col,
                    const int* __restrict__ row_ptr, int bh,
                    int num_col_tiles, int64_t num_rows, int64_t num_columns,
                    int k, bool x_vec, const T* __restrict__ X,
                    Acc* __restrict__ Y) {
  using S = Tile<T, TM, TN, RG, CG>;
  extern __shared__ __align__(16) unsigned char simt_smem[];
  T* const base = reinterpret_cast<T*>(simt_smem);
  const int64_t br = blockIdx.x / num_col_tiles;
  const int c0 = (blockIdx.x % num_col_tiles) * S::kCols;
  const int t0 = row_ptr[br];
  constexpr int kPerBlock = kBlockCols / kChunk;
  const int chunks = (row_ptr[br + 1] - t0) * kPerBlock;
  const int tid = threadIdx.x;
  // thread (ty, tx); a warp takes 32 / kWx neighbouring ty by kWx
  // neighbouring tx, so that its X reads span 128 B (one shared-memory
  // wavefront) and its block reads a few neighbouring rows
  constexpr int kWx = CG < 8 ? CG : 8;
  const int ty = (tid / 32) / (CG / kWx) * (32 / kWx) + (tid % 32) / kWx;
  const int tx = (tid / 32) % (CG / kWx) * kWx + (tid % 32) % kWx;

  // issue the copies of chunk q into its stage
  auto stage = [&](int q) {
    T* As = base + (q % kStages) * S::kStageElems;
    T* Xs = As + kRows * S::kPitch;
    const int t = t0 + q / kPerBlock;
    const int kc = (q % kPerBlock) * kChunk;
    const T* blk = blocks + static_cast<int64_t>(t) * bh * kBlockCols + kc;
    constexpr int kPieces = kChunk / S::kPer;  // 16-B pieces of a row
    for (int e = tid; e < bh * kPieces; e += kThreads) {
      const int r = e / kPieces, p = e % kPieces;
      copy16(As + r * S::kPitch + p * S::kPer,
             blk + static_cast<int64_t>(r) * kBlockCols + p * S::kPer, true);
    }
    const int64_t xrow0 = static_cast<int64_t>(block_col[t]) * kBlockCols + kc;
    if (x_vec) {
      constexpr int kXPieces = S::kCols / S::kPer;
      for (int e = tid; e < kChunk * kXPieces; e += kThreads) {
        const int r = e / kXPieces, p = e % kXPieces;
        const int64_t row = xrow0 + r;
        const int col = c0 + p * S::kPer;
        const bool ok = row < num_columns && col < k;
        copy16(Xs + r * S::kCols + p * S::kPer, ok ? X + row * k + col : X,
               ok);
      }
    } else {
      for (int e = tid; e < kChunk * S::kCols; e += kThreads) {
        const int64_t row = xrow0 + e / S::kCols;
        const int col = c0 + e % S::kCols;
        const bool ok = row < num_columns && col < k;
        copy1(Xs + e, ok ? X + row * k + col : X, ok);
      }
    }
  };

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < chunks) stage(q);
    commit();
  }
  for (int q = 0; q < chunks; ++q) {
    wait_pending<kStages - 2>();  // chunk q's copies of this thread
    __syncthreads();  // everyone's, and chunk q - 1 is consumed
    if (q + kStages - 1 < chunks) stage(q + kStages - 1);
    commit();
    const T* As = base + (q % kStages) * S::kStageElems + ty * S::kPitch;
    const T* Xs = base + (q % kStages) * S::kStageElems +
                  kRows * S::kPitch + tx * 4;
#pragma unroll 2
    for (int kk = 0; kk < kChunk; kk += 4) {
      Acc a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) load4(As + i * RG * S::kPitch + kk, a[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        Acc x[TN];
#pragma unroll
        for (int j = 0; j < TN / 4; ++j) {
          Acc v[4];
          load4(Xs + (kk + u) * S::kCols + j * CG * 4, v);
#pragma unroll
          for (int e = 0; e < 4; ++e) x[4 * j + e] = v[e];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += a[i][u] * x[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + i * RG;
    const int64_t row = br * bh + r;
    if (r >= bh || row >= num_rows) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + tx * 4 + (j / 4) * CG * 4 + j % 4;
      if (col < k) Y[row * k + col] = acc[i][j];
    }
  }
}

template <typename T, typename Acc, int TM, int TN, int RG, int CG>
cudaError_t launch_tiles(const void* blocks, const void* block_col,
                         const void* row_ptr, int bh, int64_t num_block_rows,
                         int64_t num_rows, int64_t num_columns, int k,
                         const void* X, void* Y, cudaStream_t stream) {
  using S = Tile<T, TM, TN, RG, CG>;
  const int64_t tiles = (static_cast<int64_t>(k) + S::kCols - 1) / S::kCols;
  const int64_t grid = num_block_rows * tiles;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = bsr_simt_kernel<T, Acc, TM, TN, RG, CG>;
  if (S::kSmem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::kSmem));
    if (e != cudaSuccess) return e;
  }
  const bool x_vec = reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                     (static_cast<int64_t>(k) * sizeof(T)) % 16 == 0;
  kernel<<<static_cast<unsigned>(grid), kThreads, S::kSmem, stream>>>(
      static_cast<const T*>(blocks), static_cast<const int*>(block_col),
      static_cast<const int*>(row_ptr), bh, static_cast<int>(tiles),
      num_rows, num_columns, k, x_vec, static_cast<const T*>(X),
      static_cast<Acc*>(Y));
  return cudaGetLastError();
}

template <typename T, typename Acc>
cudaError_t launch(const void* blocks, const void* block_col,
                   const void* row_ptr, int bh, int64_t num_block_rows,
                   int64_t num_rows, int64_t num_columns, int k,
                   const void* X, void* Y, cudaStream_t stream) {
  if (num_block_rows == 0 || k == 0) return cudaSuccess;
  if (k < 0 || bh < 8 || bh > kRows || bh % 8 != 0 ||
      reinterpret_cast<uintptr_t>(blocks) % 16 != 0)
    return cudaErrorInvalidValue;
  if (k <= 8)
    return launch_tiles<T, Acc, 1, 4, 128, 2>(blocks, block_col, row_ptr,
                                              bh, num_block_rows, num_rows,
                                              num_columns, k, X, Y, stream);
  if (k <= 32)
    return launch_tiles<T, Acc, 4, 4, 32, 8>(blocks, block_col, row_ptr, bh,
                                             num_block_rows, num_rows,
                                             num_columns, k, X, Y, stream);
  if constexpr (sizeof(T) == 8)  // float64: half the accumulators a thread
    return launch_tiles<T, Acc, 4, 8, 32, 8>(blocks, block_col, row_ptr, bh,
                                             num_block_rows, num_rows,
                                             num_columns, k, X, Y, stream);
  else
    return launch_tiles<T, Acc, 8, 8, 16, 16>(blocks, block_col, row_ptr,
                                              bh, num_block_rows, num_rows,
                                              num_columns, k, X, Y, stream);
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launch (0 on success).  dtype is the
// blocks' type, kFloat32, kFloat64 or kBFloat16 (dia_common.cuh); X is in
// that type and Y in its accumulator type (float32 for kBFloat16);
// block_col and row_ptr are int32; block_rows is a multiple of 8 up to
// 128; blocks has a 16-byte aligned base.
extern "C" int bsr_simt_launch(int dtype, int device, const void* blocks,
                               const void* block_col, const void* row_ptr,
                               int block_rows, long long num_block_rows,
                               long long num_rows, long long num_columns,
                               int k, const void* X, void* Y, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float, float>(blocks, block_col, row_ptr, block_rows,
                                  num_block_rows, num_rows, num_columns, k,
                                  X, Y, s);
    case kFloat64:
      return launch<double, double>(blocks, block_col, row_ptr, block_rows,
                                    num_block_rows, num_rows, num_columns,
                                    k, X, Y, s);
    case kBFloat16:
      return launch<__nv_bfloat16, float>(blocks, block_col, row_ptr,
                                          block_rows, num_block_rows,
                                          num_rows, num_columns, k, X, Y, s);
    default:
      return cudaErrorInvalidValue;
  }
}

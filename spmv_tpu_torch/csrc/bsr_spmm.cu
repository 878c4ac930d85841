// Kernel K7 (serves K7a and K7b): BSR SpMM, Y = A X over dense
// (block_rows x 128) blocks, X of shape (num_columns, k) in the blocks'
// type and Y of shape (num_rows, k) in the accumulator type, row-major.
//
// Replaces both Pallas kernels of spmv_tpu/ops/pallas_kernels.py that
// bsr_spmm (:954) dispatches to:
//   K7a _bsr_spmm_kernel (line 896, pallas_call :1045): X streamed, one
//       (128, k) tile per block, when X is larger than 80 MB;
//   K7b _bsr_spmm_wholex_kernel (line 918, pallas_call :1001): X resident
//       in VMEM when it fits (_BSR_WHOLEX_BYTES, :946).
// The two differ only in where X lives on the TPU, a residency choice of
// its 128 MB VMEM.  On Hopper an X tile reaches shared memory through L2
// either way, so one CUDA kernel is the counterpart of both.
//
// What it computes.  Block row r's blocks are [row_ptr[r], row_ptr[r+1])
// in storage order (each run padded with zero blocks to a multiple of
// blocks_per_step, as the JAX container stores it):
//
//   Y[r * bh + i, j] = sum_t sum_c blocks[t, i, c] * X[block_col[t] * 128 + c, j]
//
// with X rows at or past num_columns read as 0 (the zero-padded X of the
// Pallas kernels).  float32 and float64 blocks accumulate in their own
// type; bfloat16 blocks (and their bfloat16 X) accumulate in float32 and
// Y is float32, bsr_spmm's contract (:957-962).
//
// What bounds it on an H100: operations.  A 128 x 128 block does
// 2 * 128 * 128 * k flops for 128 * 128 values streamed, 64 flops a byte
// at k = 128 in float32, far above the card's 20 flops a byte (67 TFLOP/s
// float32 over 3.35 TB/s); a small k is bound by the block stream.
//
// What this simple design does about it (CUDA cores, FMA in the
// accumulator type; tensor cores are a later speed item):
// - One CUDA block of 256 threads per (block row, tile of KT columns of
//   X); a block row's column tiles are neighbours in the grid, so they
//   read its blocks from L2 at about the same time.  KT is 32, or 8 when
//   k <= 8 (k = 1 is the SpMV).
// - For each block of the row, in storage order: the block (converted to
//   the accumulator type, rows padded by 16 bytes so that a warp's reads
//   of four rows fall in distinct banks) and its gathered X tile (128 x
//   KT) are staged in shared memory; then thread (row group g, column j)
//   adds 128-term products into its rows g, g + 256 / KT, ... of column
//   j, held in registers (at most 16).  Block values are read four at a
//   time by one vector load, broadcast across the warp.
// - No atomics and a fixed order of every sum (blocks in storage order,
//   c ascending), so two launches give bitwise equal Y.  The order differs
//   from the Pallas kernels' pairwise _tree_sum over a step's blocks
//   (:883): results agree to rounding, not bit for bit.
// - The Y tile is written once, after the row's last block.  Rows past
//   num_rows are never written, so Y can be an exactly (num_rows, k)
//   buffer.  Y must not overlap X.

#include <cstdint>

#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kBlockCols = 128;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on sm_90

// Row stride of the staged block: 128 values and 16 bytes of padding.
template <typename Acc>
__host__ __device__ constexpr int block_stride() {
  return kBlockCols + 16 / static_cast<int>(sizeof(Acc));
}

// Four consecutive accumulator values from shared memory, 16-byte
// aligned.
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

template <typename T, typename Acc, int KT>
__global__ void __launch_bounds__(kThreads)
    bsr_spmm_kernel(const T* __restrict__ blocks,
                    const int* __restrict__ block_col,
                    const int* __restrict__ row_ptr, int bh,
                    int num_col_tiles, int64_t num_rows,
                    int64_t num_columns, int k, const T* __restrict__ X,
                    Acc* __restrict__ Y) {
  constexpr int kStride = block_stride<Acc>();
  constexpr int kGroups = kThreads / KT;       // row groups
  constexpr int kMaxRows = kBlockCols / kGroups;
  extern __shared__ __align__(16) unsigned char bsr_smem[];
  Acc* As = reinterpret_cast<Acc*>(bsr_smem);  // [bh][kStride]
  Acc* Xs = As + bh * kStride;                 // [128][KT]
  const int64_t br = blockIdx.x / num_col_tiles;
  const int c0 = (blockIdx.x % num_col_tiles) * KT;
  const int tid = threadIdx.x;
  const int j = tid % KT;
  const int g = tid / KT;
  Acc acc[kMaxRows];
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) acc[i] = Acc(0);
  const int t_end = row_ptr[br + 1];
  for (int t = row_ptr[br]; t < t_end; ++t) {
    __syncthreads();  // the previous block's tiles are consumed
    const T* blk = blocks + static_cast<int64_t>(t) * bh * kBlockCols;
    for (int e = tid; e < bh * kBlockCols; e += kThreads)
      As[(e / kBlockCols) * kStride + e % kBlockCols] =
          to_acc<Acc>(blk[e]);
    const int64_t xrow0 = static_cast<int64_t>(block_col[t]) * kBlockCols;
    for (int e = tid; e < kBlockCols * KT; e += kThreads) {
      const int64_t row = xrow0 + e / KT;
      const int col = c0 + e % KT;
      Xs[e] = (row < num_columns && col < k)
                  ? to_acc<Acc>(X[row * k + col])
                  : Acc(0);
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kBlockCols; c += 4) {
      Acc x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = Xs[(c + q) * KT + j];
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        const int r = g + i * kGroups;
        if (r < bh) {
          Acc a[4];
          load4(As + r * kStride + c, a);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i] += a[q] * x[q];
        }
      }
    }
  }
  const int col = c0 + j;
  if (col >= k) return;
#pragma unroll
  for (int i = 0; i < kMaxRows; ++i) {
    const int r = g + i * kGroups;
    const int64_t row = br * bh + r;
    if (r < bh && row < num_rows) Y[row * k + col] = acc[i];
  }
}

template <typename T, typename Acc, int KT>
cudaError_t launch_tiles(const void* blocks, const void* block_col,
                         const void* row_ptr, int bh,
                         int64_t num_block_rows, int64_t num_rows,
                         int64_t num_columns, int k, const void* X, void* Y,
                         cudaStream_t stream) {
  const int64_t tiles = (static_cast<int64_t>(k) + KT - 1) / KT;
  const int64_t grid = num_block_rows * tiles;
  if (grid > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = (static_cast<size_t>(bh) * block_stride<Acc>() +
                       static_cast<size_t>(kBlockCols) * KT) *
                      sizeof(Acc);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        bsr_spmm_kernel<T, Acc, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  bsr_spmm_kernel<T, Acc, KT>
      <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
          static_cast<const T*>(blocks), static_cast<const int*>(block_col),
          static_cast<const int*>(row_ptr), bh, static_cast<int>(tiles),
          num_rows, num_columns, k, static_cast<const T*>(X),
          static_cast<Acc*>(Y));
  return cudaGetLastError();
}

template <typename T, typename Acc>
cudaError_t launch(const void* blocks, const void* block_col,
                   const void* row_ptr, int bh, int64_t num_block_rows,
                   int64_t num_rows, int64_t num_columns, int k,
                   const void* X, void* Y, cudaStream_t stream) {
  if (num_block_rows == 0 || k == 0) return cudaSuccess;
  if (k < 0 || bh < 8 || bh > kBlockCols || bh % 8 != 0)
    return cudaErrorInvalidValue;
  if (k <= 8)
    return launch_tiles<T, Acc, 8>(blocks, block_col, row_ptr, bh,
                                   num_block_rows, num_rows, num_columns, k,
                                   X, Y, stream);
  return launch_tiles<T, Acc, 32>(blocks, block_col, row_ptr, bh,
                                  num_block_rows, num_rows, num_columns, k,
                                  X, Y, stream);
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launch (0 on success).  dtype is the
// blocks' type, kFloat32, kFloat64 or kBFloat16 (dia_common.cuh); X is in
// that type and Y in its accumulator type (float32 for kBFloat16);
// block_col and row_ptr are int32; block_rows is a multiple of 8 up to
// 128.
extern "C" int bsr_spmm_launch(int dtype, int device, const void* blocks,
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

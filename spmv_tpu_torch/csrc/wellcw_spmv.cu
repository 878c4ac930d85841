// Kernels K3a, K3b and K3c: WELL-CW SpMV, y (+)= A x over chunk-window
// chunks (see cw_common.cuh for the cell addressing).
//
// Replace the Pallas kernels of spmv_tpu/ops/pallas_kernels.py:
//   K3a cw_level_kernel   <- _cw_kernel (line 1374), a fallback level;
//   K3b cw_pool_kernel    <- _cw_pool_kernel (line 1484), a pooled level;
//   K3c cw_merged_kernel  <- _cw_merged_kernel (line 1568), the merged
//                            level + stage-1 pool grid.
//
// What bounds them on an H100: bytes.  Each cell streams a value and an
// int32 index (8 bytes in float32) and gathers one x entry for 2 flops;
// x (4 MB at 1M columns) stays in the 50 MB L2, so the time is the
// value + index stream over device-memory bandwidth, plus the latency of
// the dependent index -> x loads.
//
// What this simple design does about it:
// - x is read straight from memory (no stride-d tables: on Hopper a
//   gather through L2 is cheap, and the TPU needed the tables only to
//   turn a gather into aligned slices).
// - Level chunks (K3a, and the level part of K3c): one thread per
//   (group, lane) walks its group's chunks in order and sums each
//   chunk's 8 slots in registers; a warp's 32 lanes read 128 contiguous
//   bytes of each slot.  No atomics, no shared memory.
// - Pool cells scatter to any row of their output block, so one thread
//   per (output block, lane) walks that block's pool chunks in order
//   and adds into a shared-memory column of out_rows accumulators that
//   only it touches (32 lanes per CUDA block: no bank conflicts, no
//   barriers, no atomics).
// - K3c runs both in one CUDA block per (64-group block, 32-lane slice):
//   warp 0 walks the pool chunks while warps 1-7 sum the level groups,
//   each into its own shared tile; then the block writes level + pool.
//   That gives 4 CUDA blocks per output block (512 at 1M rows), all
//   resident at once on 132 SMs.
// Every sum runs in a fixed order, so two runs give bitwise equal y.
// Sums are kept in the storage type (float or double), as the Pallas
// kernels keep them.
//
// Output: the first launch of a product writes every row < num_rows
// (accumulate = 0); later launches add (accumulate = 1).  Rows past
// num_rows are never written, so y can be an exactly num_rows buffer.
// y must not overlap x.

#include "cw_common.cuh"
#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kWarp = 32;
constexpr int kMergedRows = 64;      // groups per merged output block
constexpr int kMergedWarps = 8;

template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ y, int64_t row,
                                          T v, bool accumulate) {
  y[row] = accumulate ? y[row] + v : v;
}

// K3a: grid of ceil(num_groups * 128 / blockDim.x) blocks; thread t is
// (group t / 128, lane t % 128).
template <typename T>
__global__ void __launch_bounds__(256)
    cw_level_kernel(const T* __restrict__ value,
                    const int* __restrict__ local_index,
                    const int* __restrict__ anchor4,
                    const int* __restrict__ group_ptr, int d,
                    int64_t num_groups, int64_t num_rows,
                    int64_t num_columns, const T* __restrict__ x,
                    T* __restrict__ y, bool accumulate) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t g = t / kCwLanes;
  const int lane = static_cast<int>(t % kCwLanes);
  const int64_t row = t;
  if (g >= num_groups || row >= num_rows) return;
  T acc = T(0);
  const int end = group_ptr[g + 1];
  for (int c = group_ptr[g]; c < end; ++c) {
    acc += cw_strip<T, false>(value, local_index, __ldg(anchor4 + c), d, c,
                              lane, x, num_columns);
  }
  store_row(y, row, acc, accumulate);
}

// K3b: grid (num_blocks, 4), one warp per block: block b, lanes
// blockIdx.y * 32 + [0, 32).  Dynamic shared memory: out_rows * 32 T.
template <typename T>
__global__ void __launch_bounds__(kWarp)
    cw_pool_kernel(const T* __restrict__ value,
                   const int* __restrict__ local_index,
                   const int* __restrict__ anchor4,
                   const int* __restrict__ rowmap,
                   const int* __restrict__ block_ptr, int d, int out_rows,
                   int64_t num_rows, int64_t num_columns,
                   const T* __restrict__ x, T* __restrict__ y,
                   bool accumulate) {
  extern __shared__ __align__(16) unsigned char cw_pool_smem[];
  T* tile = reinterpret_cast<T*>(cw_pool_smem);  // [out_rows][32]
  const int l32 = threadIdx.x;
  const int lane = blockIdx.y * kWarp + l32;
  const int64_t b = blockIdx.x;
  const int64_t base_group = b * out_rows;
  for (int r = 0; r < out_rows; ++r) tile[r * kWarp + l32] = T(0);
  const int end = block_ptr[b + 1];
  for (int c = block_ptr[b]; c < end; ++c) {
    const int a4 = __ldg(anchor4 + c);
    const int64_t base = static_cast<int64_t>(c) * kCwChunk + lane;
    int loc[kCwSlots], rel[kCwSlots];
    T val[kCwSlots];
#pragma unroll
    for (int s = 0; s < kCwSlots; ++s) {
      loc[s] = local_index[base + s * kCwLanes];
      val[s] = value[base + s * kCwLanes];
      rel[s] = static_cast<int>(rowmap[base + s * kCwLanes] - base_group);
    }
#pragma unroll
    for (int s = 0; s < kCwSlots; ++s) {
      const T p = val[s] * cw_x(x, num_columns, a4, d, loc[s] >> 7, loc[s]);
      if (static_cast<unsigned>(rel[s]) < static_cast<unsigned>(out_rows))
        tile[rel[s] * kWarp + l32] += p;
    }
  }
  for (int r = 0; r < out_rows; ++r) {
    const int64_t row = (base_group + r) * kCwLanes + lane;
    if (row < num_rows) store_row(y, row, tile[r * kWarp + l32], accumulate);
  }
}

// K3c: grid (num_blocks, 4), 8 warps per block: 64-group block b, lanes
// blockIdx.y * 32 + [0, 32).  Chunk kk of block b is b * kl + kk:
// kk < 64 * cap are level chunks (group kk / cap), the rest pool chunks.
template <typename T>
__global__ void __launch_bounds__(kMergedWarps * kWarp)
    cw_merged_kernel(const T* __restrict__ value,
                     const int* __restrict__ local_index,
                     const int* __restrict__ anchor4, int d, int cap,
                     int pool_per_block, int64_t num_rows,
                     int64_t num_columns, const T* __restrict__ x,
                     T* __restrict__ y, bool accumulate) {
  __shared__ T level_tile[kMergedRows * kWarp];
  __shared__ T pool_tile[kMergedRows * kWarp];
  const int l32 = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = blockIdx.y * kWarp + l32;
  const int64_t b = blockIdx.x;
  const int lvl_per = kMergedRows * cap;
  const int64_t first = b * (lvl_per + pool_per_block);
  const bool has_pool = pool_per_block > 0;
  if (has_pool && warp == 0) {
    for (int r = 0; r < kMergedRows; ++r) pool_tile[r * kWarp + l32] = T(0);
    for (int j = 0; j < pool_per_block; ++j) {
      const int64_t c = first + lvl_per + j;
      const int a4 = __ldg(anchor4 + c);
      const int64_t base = c * kCwChunk + lane;
      int loc[kCwSlots];
      T val[kCwSlots];
#pragma unroll
      for (int s = 0; s < kCwSlots; ++s) {
        loc[s] = local_index[base + s * kCwLanes];
        val[s] = value[base + s * kCwLanes];
      }
#pragma unroll
      for (int s = 0; s < kCwSlots; ++s) {
        const int w = (loc[s] >> 7) & (8 * d - 1);
        const T p = val[s] * cw_x(x, num_columns, a4, d, w, loc[s]);
        const int r = loc[s] >> 14;
        if (r < kMergedRows) pool_tile[r * kWarp + l32] += p;
      }
    }
  } else {
    const int w0 = has_pool ? 1 : 0;
    for (int g = warp - w0; g < kMergedRows; g += kMergedWarps - w0) {
      T acc = T(0);
      for (int q = 0; q < cap; ++q) {
        const int64_t c = first + static_cast<int64_t>(g) * cap + q;
        acc += cw_strip<T, true>(value, local_index, __ldg(anchor4 + c), d,
                                 c, lane, x, num_columns);
      }
      level_tile[g * kWarp + l32] = acc;
    }
  }
  __syncthreads();
  for (int g = warp; g < kMergedRows; g += kMergedWarps) {
    const int64_t row = (b * kMergedRows + g) * kCwLanes + lane;
    if (row >= num_rows) continue;
    T v = level_tile[g * kWarp + l32];
    if (has_pool) v += pool_tile[g * kWarp + l32];
    store_row(y, row, v, accumulate);
  }
}

template <typename T>
cudaError_t level(const void* value, const void* local_index,
                  const void* anchor4, const void* group_ptr, int d,
                  int64_t num_groups, int64_t num_rows, int64_t num_columns,
                  const void* x, void* y, bool accumulate,
                  cudaStream_t stream) {
  constexpr int threads = 256;
  const int64_t blocks = (num_groups * kCwLanes + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  cw_level_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(local_index),
      static_cast<const int*>(anchor4), static_cast<const int*>(group_ptr),
      d, num_groups, num_rows, num_columns, static_cast<const T*>(x),
      static_cast<T*>(y), accumulate);
  return cudaGetLastError();
}

template <typename T>
cudaError_t pool(const void* value, const void* local_index,
                 const void* anchor4, const void* rowmap,
                 const void* block_ptr, int d, int out_rows,
                 int64_t num_blocks, int64_t num_rows, int64_t num_columns,
                 const void* x, void* y, bool accumulate,
                 cudaStream_t stream) {
  if (num_blocks == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(out_rows) * kWarp * sizeof(T);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(num_blocks), kCwLanes / kWarp);
  cw_pool_kernel<T><<<grid, kWarp, smem, stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(local_index),
      static_cast<const int*>(anchor4), static_cast<const int*>(rowmap),
      static_cast<const int*>(block_ptr), d, out_rows, num_rows,
      num_columns, static_cast<const T*>(x), static_cast<T*>(y),
      accumulate);
  return cudaGetLastError();
}

template <typename T>
cudaError_t merged(const void* value, const void* local_index,
                   const void* anchor4, int d, int cap, int pool_per_block,
                   int64_t num_blocks, int64_t num_rows,
                   int64_t num_columns, const void* x, void* y,
                   bool accumulate, cudaStream_t stream) {
  if (num_blocks == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(num_blocks), kCwLanes / kWarp);
  cw_merged_kernel<T><<<grid, kMergedWarps * kWarp, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(local_index),
      static_cast<const int*>(anchor4), d, cap, pool_per_block, num_rows,
      num_columns, static_cast<const T*>(x), static_cast<T*>(y),
      accumulate);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmv_tpu_torch

// Each returns the cudaError_t of the launch (0 on success).  dtype is
// kFloat32 or kFloat64 (dia_common.cuh); every index array is int32.

extern "C" int wellcw_level_launch(int dtype, int device, const void* value,
                                   const void* local_index,
                                   const void* anchor4,
                                   const void* group_ptr, int d,
                                   long long num_groups, long long num_rows,
                                   long long num_columns, const void* x,
                                   void* y, int accumulate, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return level<float>(value, local_index, anchor4, group_ptr, d,
                          num_groups, num_rows, num_columns, x, y,
                          accumulate != 0, s);
    case kFloat64:
      return level<double>(value, local_index, anchor4, group_ptr, d,
                           num_groups, num_rows, num_columns, x, y,
                           accumulate != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int wellcw_pool_launch(int dtype, int device, const void* value,
                                  const void* local_index,
                                  const void* anchor4, const void* rowmap,
                                  const void* block_ptr, int d, int out_rows,
                                  long long num_blocks, long long num_rows,
                                  long long num_columns, const void* x,
                                  void* y, int accumulate, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return pool<float>(value, local_index, anchor4, rowmap, block_ptr, d,
                         out_rows, num_blocks, num_rows, num_columns, x, y,
                         accumulate != 0, s);
    case kFloat64:
      return pool<double>(value, local_index, anchor4, rowmap, block_ptr, d,
                          out_rows, num_blocks, num_rows, num_columns, x, y,
                          accumulate != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int wellcw_merged_launch(int dtype, int device, const void* value,
                                    const void* local_index,
                                    const void* anchor4, int d, int cap,
                                    int pool_per_block, long long num_blocks,
                                    long long num_rows, long long num_columns,
                                    const void* x, void* y, int accumulate,
                                    void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return merged<float>(value, local_index, anchor4, d, cap,
                           pool_per_block, num_blocks, num_rows, num_columns,
                           x, y, accumulate != 0, s);
    case kFloat64:
      return merged<double>(value, local_index, anchor4, d, cap,
                            pool_per_block, num_blocks, num_rows,
                            num_columns, x, y, accumulate != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Kernels K5a and K5b: WELL SpMV, y = A x over the WELL chunks (the CSR
// spill is added after them by csr_spmv.cu with accumulate = 1).
//
// Replace the Pallas kernels of spmv_tpu/ops/pallas_kernels.py:
//   K5a well_kernel<T, false>  <- _well_kernel (line 431, through
//                                 well_spmv_padded, :474), whole x;
//   K5b well_kernel<T, true>   <- _well_seg_kernel (line 557, through
//                                 _well_seg_call, :622), segmented.
//
// What they compute.  A chunk c is 8 slots x 128 lanes and adds into
// row group_of_chunk[c] * 128 + lane:
//
//   sum_s value[c, s, lane] * x[(ws[c, s] + seg) * 128 + loc[c, s, lane]]
//
// with ws[c, s] = window_start[t, s, kk] for chunk c = t * K + kk, seg =
// segment_of_step[t] in segmented mode (K5b) and 0 in whole-x mode (K5a).
// A column at or past num_columns reads 0, as the Pallas kernels' zero-
// padded x does.  Output block b is groups [b * out_rows, (b + 1) *
// out_rows), out_rows = 8 * blocks_per_out; its steps are [step_ptr[b],
// step_ptr[b + 1]) and every chunk of them has a group in that range.
//
// What bounds them on an H100: bytes.  Each slot cell streams a value and
// an int32 index (8 bytes in float32) for 2 flops and one x gather, and
// a slot's windows track its rows, so x and y stream about once (x
// gathers hit L2).  The bound is (value + local_index + x + y) bytes over
// the device-memory rate.
//
// What this simple design does about it:
// - One CUDA block per output block, 128 threads, one per lane: each
//   slot's 128 values and indices are one coalesced 512-byte load
//   (float32), and all 16 of a chunk's loads are issued before its 8
//   dependent x gathers.
// - A shared-memory tile of out_rows x 128 sums in the value type (16 KB
//   in float32 at blocks_per_out = 4), zeroed first; the block walks its
//   steps and their chunks in storage order and adds each chunk's strip
//   into tile row group % out_rows.  Each thread touches only its own
//   lane's column, so there are no barriers and no atomics, and every
//   sum runs in a fixed order: two launches give bitwise equal y.
// - Then the tile is written out.  An output block that no step visits
//   gets zeros (the Pallas kernels never write it).
// - Not carried over: the TPU's window tables, the take_along_axis lane
//   shuffle and the segment DMA (make_async_copy).  On Hopper the gather
//   is a load, and the segment is an offset added to the column; the
//   reads go through L2.
// Segmented mode packs chunks (block, segment)-major, so a group may
// come back after another group of the block: the tile row is computed
// from each chunk's own group, never from the previous chunk's.
//
// Output: every row < num_rows is written; rows past it never are, so y
// can be an exactly num_rows buffer.  y must not overlap x.

#include <cstdint>

#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kWellSlots = 8;
constexpr int kWellLanes = 128;
constexpr int kWellChunk = kWellSlots * kWellLanes;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on sm_90

template <typename T, bool Segmented>
__global__ void __launch_bounds__(kWellLanes)
    well_kernel(const T* __restrict__ value,
                const int* __restrict__ local_index,
                const int* __restrict__ window_start,
                const int* __restrict__ group_of_chunk,
                const int* __restrict__ segment_of_step,
                const int* __restrict__ step_ptr, int k, int out_rows,
                int64_t num_rows, int64_t num_columns,
                const T* __restrict__ x, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char well_smem[];
  T* tile = reinterpret_cast<T*>(well_smem);  // [out_rows][128]
  const int lane = threadIdx.x;
  const int64_t b = blockIdx.x;
  for (int r = 0; r < out_rows; ++r) tile[r * kWellLanes + lane] = T(0);
  const int t_end = step_ptr[b + 1];
  for (int t = step_ptr[b]; t < t_end; ++t) {
    const int64_t seg = Segmented ? __ldg(segment_of_step + t) : 0;
    const int* ws_step = window_start + static_cast<int64_t>(t) * kWellSlots * k;
    for (int kk = 0; kk < k; ++kk) {
      const int64_t c = static_cast<int64_t>(t) * k + kk;
      const int64_t base = c * kWellChunk + lane;
      int loc[kWellSlots];
      T val[kWellSlots];
#pragma unroll
      for (int s = 0; s < kWellSlots; ++s) {
        loc[s] = local_index[base + s * kWellLanes];
        val[s] = value[base + s * kWellLanes];
      }
      T strip = T(0);
#pragma unroll
      for (int s = 0; s < kWellSlots; ++s) {
        const int64_t col =
            (__ldg(ws_step + s * k + kk) + seg) * kWellLanes + loc[s];
        const T xv = static_cast<uint64_t>(col) <
                             static_cast<uint64_t>(num_columns)
                         ? __ldg(x + col)
                         : T(0);
        strip += val[s] * xv;
      }
      const int r = __ldg(group_of_chunk + c) % out_rows;
      tile[r * kWellLanes + lane] += strip;
    }
  }
  for (int r = 0; r < out_rows; ++r) {
    const int64_t row = (b * out_rows + r) * kWellLanes + lane;
    if (row < num_rows) y[row] = tile[r * kWellLanes + lane];
  }
}

template <typename T, bool Segmented>
cudaError_t launch(const void* value, const void* local_index,
                   const void* window_start, const void* group_of_chunk,
                   const void* segment_of_step, const void* step_ptr, int k,
                   int out_rows, int64_t num_out_blocks, int64_t num_rows,
                   int64_t num_columns, const void* x, void* y,
                   cudaStream_t stream) {
  if (num_out_blocks == 0) return cudaSuccess;
  if (k < 1 || out_rows < 1 || num_out_blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(out_rows) * kWellLanes * sizeof(T);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        well_kernel<T, Segmented>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  well_kernel<T, Segmented>
      <<<static_cast<unsigned>(num_out_blocks), kWellLanes, smem, stream>>>(
          static_cast<const T*>(value), static_cast<const int*>(local_index),
          static_cast<const int*>(window_start),
          static_cast<const int*>(group_of_chunk),
          static_cast<const int*>(segment_of_step),
          static_cast<const int*>(step_ptr), k, out_rows, num_rows,
          num_columns, static_cast<const T*>(x), static_cast<T*>(y));
  return cudaGetLastError();
}

template <bool Segmented>
int dispatch(int dtype, int device, const void* value,
             const void* local_index, const void* window_start,
             const void* group_of_chunk, const void* segment_of_step,
             const void* step_ptr, int k, int out_rows,
             long long num_out_blocks, long long num_rows,
             long long num_columns, const void* x, void* y, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float, Segmented>(value, local_index, window_start,
                                      group_of_chunk, segment_of_step,
                                      step_ptr, k, out_rows, num_out_blocks,
                                      num_rows, num_columns, x, y, s);
    case kFloat64:
      return launch<double, Segmented>(value, local_index, window_start,
                                       group_of_chunk, segment_of_step,
                                       step_ptr, k, out_rows, num_out_blocks,
                                       num_rows, num_columns, x, y, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace spmv_tpu_torch

// Each returns the cudaError_t of the launch (0 on success).  dtype is
// kFloat32 or kFloat64 (dia_common.cuh); every index array is int32.
// segment_of_step is read only by K5b (well_seg_launch).

extern "C" int well_whole_launch(int dtype, int device, const void* value,
                                 const void* local_index,
                                 const void* window_start,
                                 const void* group_of_chunk,
                                 const void* step_ptr, int k, int out_rows,
                                 long long num_out_blocks, long long num_rows,
                                 long long num_columns, const void* x,
                                 void* y, void* stream) {
  return spmv_tpu_torch::dispatch<false>(
      dtype, device, value, local_index, window_start, group_of_chunk,
      nullptr, step_ptr, k, out_rows, num_out_blocks, num_rows, num_columns,
      x, y, stream);
}

extern "C" int well_seg_launch(int dtype, int device, const void* value,
                               const void* local_index,
                               const void* window_start,
                               const void* group_of_chunk,
                               const void* segment_of_step,
                               const void* step_ptr, int k, int out_rows,
                               long long num_out_blocks, long long num_rows,
                               long long num_columns, const void* x, void* y,
                               void* stream) {
  return spmv_tpu_torch::dispatch<true>(
      dtype, device, value, local_index, window_start, group_of_chunk,
      segment_of_step, step_ptr, k, out_rows, num_out_blocks, num_rows,
      num_columns, x, y, stream);
}

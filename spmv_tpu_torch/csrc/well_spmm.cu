// Kernels K6a and K6b: WELL SpMM, Y = A X over the WELL chunks for X of
// shape (num_columns, k) and Y of shape (num_rows, k), row-major (the CSR
// spill is added after them by csr_spmm.cu with accumulate = 1).
//
// Replace the Pallas kernels of spmv_tpu/ops/pallas_kernels.py:
//   K6a well_spmm_kernel<T, false>  <- _well_spmm_kernel (line 1079,
//                                      through well_spmm_padded, :1256),
//                                      whole x;
//   K6b well_spmm_kernel<T, true>   <- _well_seg_spmm_kernel (line 1121,
//                                      through _well_seg_spmm_call,
//                                      :1188), segmented.
//
// What they compute.  K5's sum (well_spmv.cu) for each column j of X:
// chunk c adds into row group_of_chunk[c] * 128 + lane
//
//   sum_s value[c, s, lane] * X[(ws[c, s] + seg) * 128 + loc[c, s, lane], j]
//
// with seg = segment_of_step[t] in segmented mode (K6b) and 0 in whole-x
// mode (K6a).  A column at or past num_columns reads 0, as in K5.
//
// What bounds them on an H100: bytes.  Each slot cell streams a value and
// an int32 index for 2 k flops and one gather of k contiguous X values;
// the bound is (value + local_index + X + Y) bytes over the memory rate.
//
// What this simple design does about it:
// - K5's design, one CUDA block per output block, found through
//   step_ptr, with the columns in blocks of kc along grid dimension y;
//   the block has 128 x kc threads, thread (lane, j) summing column j of
//   the block.  The kc threads of a lane load the same values and
//   indices (the first from device memory, the rest from L1) and gather
//   neighbouring values of one X row (kc of them fill 32 B at kc = 8 in
//   float32).  A thread a column, rather than a thread a lane holding kc
//   sums, keeps kc times more warps in flight on an SM whose shared
//   memory the tile fills.
// - The shared-memory tile holds out_rows x kc x 128 sums in the value
//   type ([row][column][lane]: a warp's accesses hit 32 banks), zeroed
//   first; the block walks its steps and their chunks in storage order
//   and adds each chunk's strip into tile row group % out_rows.  Each
//   thread touches only its own (lane, column) sums, so there are no
//   barriers and no atomics, and every sum runs in a fixed order: two
//   launches give bitwise equal Y, and column j sums exactly as K5 does
//   on X[:, j].
// - The tile is out_rows * kc * 128 * sizeof(T) bytes: the wrapper picks
//   kc by a shared-memory budget (ops/well_kernels.py well_column_block).
//   A narrower block leaves room for more blocks on an SM but streams the
//   values and indices once per column block.
// - Not carried over: the TPU's (rows, k, 128) X layout, the lane shuffle,
//   the segment DMA and the VMEM limits (8 MB of whole x, 12 MB of
//   segment): K6a takes any X.
//
// Output: every row < num_rows of the block's columns is written; rows
// past it never are, so Y can be an exactly (num_rows, k) buffer.  Y must
// not overlap X.

#include <cstdint>

#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kSlots = 8;
constexpr int kLanes = 128;
constexpr int kChunk = kSlots * kLanes;
constexpr int kMaxCols = 8;  // widest column block: 8 threads a lane
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on sm_90

template <typename T, bool Segmented>
__global__ void __launch_bounds__(kLanes * kMaxCols)
    well_spmm_kernel(const T* __restrict__ value,
                     const int* __restrict__ local_index,
                     const int* __restrict__ window_start,
                     const int* __restrict__ group_of_chunk,
                     const int* __restrict__ segment_of_step,
                     const int* __restrict__ step_ptr, int k, int out_rows,
                     int64_t num_rows, int64_t num_columns, int ncols,
                     int kc, const T* __restrict__ X, T* __restrict__ Y) {
  extern __shared__ __align__(16) unsigned char well_spmm_smem[];
  T* tile = reinterpret_cast<T*>(well_spmm_smem);  // [out_rows][kc][128]
  const int lane = threadIdx.x;
  const int j = threadIdx.y;  // this thread's column of the block
  const int64_t b = blockIdx.x;
  const int col_j = blockIdx.y * kc + j;
  if (col_j >= ncols) return;  // a last block narrower than kc
  for (int r = 0; r < out_rows; ++r)
    tile[(r * kc + j) * kLanes + lane] = T(0);
  const int t_end = step_ptr[b + 1];
  for (int t = step_ptr[b]; t < t_end; ++t) {
    const int64_t seg = Segmented ? __ldg(segment_of_step + t) : 0;
    const int* ws_step =
        window_start + static_cast<int64_t>(t) * kSlots * k;
    for (int kk = 0; kk < k; ++kk) {
      const int64_t c = static_cast<int64_t>(t) * k + kk;
      const int64_t base = c * kChunk + lane;
      int loc[kSlots];
      T val[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        loc[s] = local_index[base + s * kLanes];
        val[s] = value[base + s * kLanes];
      }
      T strip = T(0);
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int64_t col =
            (__ldg(ws_step + s * k + kk) + seg) * kLanes + loc[s];
        const T xv = static_cast<uint64_t>(col) <
                             static_cast<uint64_t>(num_columns)
                         ? __ldg(X + col * ncols + col_j)
                         : T(0);
        strip += val[s] * xv;
      }
      const int r = __ldg(group_of_chunk + c) % out_rows;
      tile[(r * kc + j) * kLanes + lane] += strip;
    }
  }
  for (int r = 0; r < out_rows; ++r) {
    const int64_t row = (b * out_rows + r) * kLanes + lane;
    if (row < num_rows)
      Y[row * ncols + col_j] = tile[(r * kc + j) * kLanes + lane];
  }
}

template <typename T, bool Segmented>
cudaError_t launch(const void* value, const void* local_index,
                   const void* window_start, const void* group_of_chunk,
                   const void* segment_of_step, const void* step_ptr, int k,
                   int out_rows, int64_t num_out_blocks, int64_t num_rows,
                   int64_t num_columns, int ncols, int kc, const void* X,
                   void* Y, cudaStream_t stream) {
  if (num_out_blocks == 0 || ncols == 0) return cudaSuccess;
  if (k < 1 || out_rows < 1 || ncols < 0 || kc < 1 || kc > kMaxCols ||
      num_out_blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  const int64_t ncb = (static_cast<int64_t>(ncols) + kc - 1) / kc;
  if (ncb > 65535) return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(out_rows) * kc * kLanes * sizeof(T);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        well_spmm_kernel<T, Segmented>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(num_out_blocks),
                  static_cast<unsigned>(ncb));
  const dim3 block(kLanes, kc);
  well_spmm_kernel<T, Segmented><<<grid, block, smem, stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(local_index),
      static_cast<const int*>(window_start),
      static_cast<const int*>(group_of_chunk),
      static_cast<const int*>(segment_of_step),
      static_cast<const int*>(step_ptr), k, out_rows, num_rows, num_columns,
      ncols, kc, static_cast<const T*>(X), static_cast<T*>(Y));
  return cudaGetLastError();
}

template <bool Segmented>
int dispatch(int dtype, int device, const void* value,
             const void* local_index, const void* window_start,
             const void* group_of_chunk, const void* segment_of_step,
             const void* step_ptr, int k, int out_rows,
             long long num_out_blocks, long long num_rows,
             long long num_columns, int ncols, int kc, const void* X,
             void* Y, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float, Segmented>(
          value, local_index, window_start, group_of_chunk, segment_of_step,
          step_ptr, k, out_rows, num_out_blocks, num_rows, num_columns,
          ncols, kc, X, Y, s);
    case kFloat64:
      return launch<double, Segmented>(
          value, local_index, window_start, group_of_chunk, segment_of_step,
          step_ptr, k, out_rows, num_out_blocks, num_rows, num_columns,
          ncols, kc, X, Y, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace spmv_tpu_torch

// Each returns the cudaError_t of the launch (0 on success).  dtype is
// kFloat32 or kFloat64 (dia_common.cuh); every index array is int32; k is
// the chunks per step, ncols the columns of X and Y, kc the column block
// (1..8).  segment_of_step is read only by K6b (well_seg_spmm_launch).

extern "C" int well_whole_spmm_launch(
    int dtype, int device, const void* value, const void* local_index,
    const void* window_start, const void* group_of_chunk,
    const void* step_ptr, int k, int out_rows, long long num_out_blocks,
    long long num_rows, long long num_columns, int ncols, int kc,
    const void* X, void* Y, void* stream) {
  return spmv_tpu_torch::dispatch<false>(
      dtype, device, value, local_index, window_start, group_of_chunk,
      nullptr, step_ptr, k, out_rows, num_out_blocks, num_rows, num_columns,
      ncols, kc, X, Y, stream);
}

extern "C" int well_seg_spmm_launch(
    int dtype, int device, const void* value, const void* local_index,
    const void* window_start, const void* group_of_chunk,
    const void* segment_of_step, const void* step_ptr, int k, int out_rows,
    long long num_out_blocks, long long num_rows, long long num_columns,
    int ncols, int kc, const void* X, void* Y, void* stream) {
  return spmv_tpu_torch::dispatch<true>(
      dtype, device, value, local_index, window_start, group_of_chunk,
      segment_of_step, step_ptr, k, out_rows, num_out_blocks, num_rows,
      num_columns, ncols, kc, X, Y, stream);
}

// CSR SpMV: y (+)= A x over row_ptr / column_index / value (int32
// indices).
//
// Not a TPU kernel: the JAX package sums CSR in XLA (_csr_padded,
// spmv_tpu/ops/spmv.py:42, a gather and a segment sum).  It serves the
// WELL-CW remainder (added after the chunk kernels, accumulate = 1),
// the CSR format's own path (-s csr, coo, coo-atomic; accumulate = 0),
// the hybrid's COO part (accumulate = 1) and the generic V-cycle's A, P
// and P^T.  A scatter with atomics, as index_add_ does on CUDA, would
// add in no fixed order; here each row is summed by one thread, warp or
// block in a fixed order, so two runs give bitwise equal y.
//
// What bounds it on an H100: bytes (value, column index and row pointer
// streams, and the x gather), and on a skewed matrix the longest row: a
// thread a row walked the hybrid's longest COO row (44,547 entries) for
// 3.5 ms against a 0.05 ms bound.  What the design does about it
// (csr_rows.cuh): the container lists the rows longer than max_short
// entries (DeviceCsr.long_rows, built on the host, longest first), and
// the launch's first blocks sum them, a warp a row, or a whole block a
// row past a second length, each lane over a strided subset with G
// entries' x gathers in flight while the next G entries load; the rest
// of the launch is the thread-a-row walk of the short rows, which skips
// a long row after reading its row_ptr pair.  Without long rows the
// launch is that walk alone, as before the split.  An empty row is left
// alone when accumulating.  y must not overlap x.

#include "csr_rows.cuh"
#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

// Blocks [0, lr.blocks()) sum the long rows (Split only, csr_rows.cuh);
// thread t of the later blocks takes row t.
template <typename T, bool Split>
__global__ void __launch_bounds__(kCsrThreads)
    csr_spmv_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ column_index,
                    const T* __restrict__ value, int64_t num_rows,
                    int64_t num_columns, LongRows lr, const T* __restrict__ x,
                    T* __restrict__ y, bool accumulate) {
  int64_t b = blockIdx.x;
  if constexpr (Split) {
    if (b < lr.blocks()) {
      // 4 entries' x in flight a lane
      constexpr int G = 4;
      const auto load_x = [&](int64_t c, bool ok, T(&xv)[1]) {
        xv[0] = ok ? __ldg(x + c) : T(0);
      };
      long_row<T, 1>(
          row_ptr, lr, b,
          [&](int64_t e, int64_t end, int S, T(&acc)[1]) {
            lane_sums<T, 1, G>(column_index, value, e, end, S, num_columns,
                               load_x, acc);
          },
          [&](int64_t i, const T(&s)[1]) {
            y[i] = accumulate ? y[i] + s[0] : s[0];
          });
      return;
    }
    b -= lr.blocks();
  }
  const int64_t i = b * blockDim.x + threadIdx.x;
  if (i >= num_rows) return;
  const int start = row_ptr[i];
  const int end = row_ptr[i + 1];
  if constexpr (Split) {
    if (end - start > lr.max_short) return;
  }
  if (accumulate && start == end) return;
  T acc = T(0);
  for (int j = start; j < end; ++j) {
    const int c = column_index[j];
    if (static_cast<unsigned>(c) < static_cast<uint64_t>(num_columns))
      acc += value[j] * __ldg(x + c);
  }
  y[i] = accumulate ? y[i] + acc : acc;
}

template <typename T>
cudaError_t launch(const void* row_ptr, const void* column_index,
                   const void* value, int64_t num_rows, int64_t num_columns,
                   const LongRows& lr, const void* x, void* y,
                   bool accumulate, cudaStream_t stream) {
  const int64_t blocks =
      lr.blocks() + (num_rows + kCsrThreads - 1) / kCsrThreads;
  if (blocks == 0) return cudaSuccess;
  const auto args = [&](auto kernel) {
    kernel<<<static_cast<unsigned>(blocks), kCsrThreads, 0, stream>>>(
        static_cast<const int*>(row_ptr),
        static_cast<const int*>(column_index), static_cast<const T*>(value),
        num_rows, num_columns, lr, static_cast<const T*>(x),
        static_cast<T*>(y), accumulate);
  };
  if (lr.rows != nullptr)
    args(csr_spmv_kernel<T, true>);
  else
    args(csr_spmv_kernel<T, false>);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launch (0 on success).  dtype is
// kFloat32 or kFloat64 (dia_common.cuh); long_rows is the num_long rows
// with more than max_short entries, longest first, the first num_block
// of them summed by a block each (csr_rows.cuh), or null.
extern "C" int csr_spmv_launch(int dtype, int device, const void* row_ptr,
                               const void* column_index, const void* value,
                               long long num_rows, long long num_columns,
                               const void* long_rows, long long num_long,
                               long long num_block, int max_short,
                               const void* x, void* y, int accumulate,
                               void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LongRows lr = {static_cast<const int*>(long_rows),
                       long_rows != nullptr ? num_long : 0,
                       long_rows != nullptr ? num_block : 0, max_short};
  switch (dtype) {
    case kFloat32:
      return launch<float>(row_ptr, column_index, value, num_rows,
                           num_columns, lr, x, y, accumulate != 0, s);
    case kFloat64:
      return launch<double>(row_ptr, column_index, value, num_rows,
                            num_columns, lr, x, y, accumulate != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

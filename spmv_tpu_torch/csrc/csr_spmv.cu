// CSR SpMV: y (+)= A x over row_ptr / column_index / value (int32
// indices).
//
// Not a TPU kernel: the JAX package sums CSR in XLA (_csr_padded,
// spmv_tpu/ops/spmv.py:42, a gather and a segment sum).  It serves the
// WELL-CW remainder (added after the chunk kernels, accumulate = 1) and
// plain CSR products (accumulate = 0).  A scatter with atomics, as
// index_add_ does on CUDA, would add in no fixed order; one thread per
// row sums its entries in order, so two runs give bitwise equal y.
//
// What bounds it on an H100: bytes (value, column index and row pointer
// streams, and the x gather).  This simple design walks each row in one
// thread; it suits the WELL-CW remainder (a few thousand entries over
// many mostly empty rows, where the row_ptr read dominates) and is not
// tuned for long rows (a warp per row would be).  An empty row is left
// alone when accumulating.  y must not overlap x.

#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

template <typename T>
__global__ void __launch_bounds__(256)
    csr_spmv_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ column_index,
                    const T* __restrict__ value, int64_t num_rows,
                    int64_t num_columns, const T* __restrict__ x,
                    T* __restrict__ y, bool accumulate) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= num_rows) return;
  const int start = row_ptr[i];
  const int end = row_ptr[i + 1];
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
                   const void* x, void* y, bool accumulate,
                   cudaStream_t stream) {
  constexpr int threads = 256;
  const int64_t blocks = (num_rows + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  csr_spmv_kernel<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const int*>(row_ptr),
      static_cast<const int*>(column_index), static_cast<const T*>(value),
      num_rows, num_columns, static_cast<const T*>(x), static_cast<T*>(y),
      accumulate);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launch (0 on success).  dtype is
// kFloat32 or kFloat64 (dia_common.cuh).
extern "C" int csr_spmv_launch(int dtype, int device, const void* row_ptr,
                               const void* column_index, const void* value,
                               long long num_rows, long long num_columns,
                               const void* x, void* y, int accumulate,
                               void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(row_ptr, column_index, value, num_rows,
                           num_columns, x, y, accumulate != 0, s);
    case kFloat64:
      return launch<double>(row_ptr, column_index, value, num_rows,
                            num_columns, x, y, accumulate != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

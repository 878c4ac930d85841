// CSR SpMM: Y (+)= A X over row_ptr / column_index / value (int32
// indices), X (num_columns, k) and Y (num_rows, k) row-major.
//
// Not a TPU kernel: the JAX package sums CSR in XLA (the DeviceCsr branch
// of spmm, spmv_tpu/ops/spmv.py:266-273, a gather and a segment sum).
// It serves the WELL-CW remainder of the SpMM (added after K4a-c,
// accumulate = 1) and plain CSR products (accumulate = 0).  A scatter
// with atomics, as index_add_ does on CUDA, would add in no fixed order;
// one thread per (row, column block) sums the row's entries in order, as
// csr_spmv.cu does for each column, so two runs give bitwise equal Y and
// column j sums as the SpMV of X[:, j] does.
//
// What bounds it on an H100: bytes (the value, column index and row
// pointer streams, and the X gather: kb contiguous values a row entry).
// The design is csr_spmv.cu's, with kKB = 8 column sums in registers and
// the columns in blocks of kKB along grid dimension y; each column block
// re-reads the row streams.  An empty row is left alone when
// accumulating.  Y must not overlap X.

#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kKB = 8;

template <typename T>
__global__ void __launch_bounds__(256)
    csr_spmm_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ column_index,
                    const T* __restrict__ value, int64_t num_rows,
                    int64_t num_columns, int k, const T* __restrict__ X,
                    T* __restrict__ Y, bool accumulate) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= num_rows) return;
  const int start = row_ptr[i];
  const int end = row_ptr[i + 1];
  if (accumulate && start == end) return;
  const int c0 = blockIdx.y * kKB;
  const int kc = min(kKB, k - c0);
  T acc[kKB];
#pragma unroll
  for (int j = 0; j < kKB; ++j) acc[j] = T(0);
  for (int e = start; e < end; ++e) {
    const int c = column_index[e];
    if (static_cast<unsigned>(c) >= static_cast<uint64_t>(num_columns))
      continue;
    const T v = value[e];
    const T* xr = X + static_cast<int64_t>(c) * k + c0;
#pragma unroll
    for (int j = 0; j < kKB; ++j) {
      if (j < kc) acc[j] += v * __ldg(xr + j);
    }
  }
  T* yr = Y + i * k + c0;
#pragma unroll
  for (int j = 0; j < kKB; ++j) {
    if (j < kc) yr[j] = accumulate ? yr[j] + acc[j] : acc[j];
  }
}

template <typename T>
cudaError_t launch(const void* row_ptr, const void* column_index,
                   const void* value, int64_t num_rows, int64_t num_columns,
                   int k, const void* X, void* Y, bool accumulate,
                   cudaStream_t stream) {
  constexpr int threads = 256;
  const int64_t blocks = (num_rows + threads - 1) / threads;
  if (blocks == 0 || k == 0) return cudaSuccess;
  const int64_t ncb = (static_cast<int64_t>(k) + kKB - 1) / kKB;
  if (k < 0 || ncb > 65535) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(ncb));
  csr_spmm_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const int*>(row_ptr),
      static_cast<const int*>(column_index), static_cast<const T*>(value),
      num_rows, num_columns, k, static_cast<const T*>(X), static_cast<T*>(Y),
      accumulate);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launch (0 on success).  dtype is
// kFloat32 or kFloat64 (dia_common.cuh).
extern "C" int csr_spmm_launch(int dtype, int device, const void* row_ptr,
                               const void* column_index, const void* value,
                               long long num_rows, long long num_columns,
                               int k, const void* X, void* Y, int accumulate,
                               void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(row_ptr, column_index, value, num_rows,
                           num_columns, k, X, Y, accumulate != 0, s);
    case kFloat64:
      return launch<double>(row_ptr, column_index, value, num_rows,
                            num_columns, k, X, Y, accumulate != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

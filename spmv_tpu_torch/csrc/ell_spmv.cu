// ELL SpMV: y (+)= A x over slot-major column_index / value, both
// (row_length, num_rows): slot s of row i at [s * num_rows + i].
//
// Not a TPU kernel: the JAX package sums ELL in XLA (_ell_padded,
// spmv_tpu/ops/spmv.py:52, a dense gather and a row sum).  It is written
// by hand so that the ELL format, and the ELL part of the hybrid format,
// runs a fixed-order kernel on the card: one thread a row adds its slots
// 0..L-1 in order, with no atomics, so two runs give bitwise equal y.
// Padded slots are inert (value 0 at an in-bounds column) and are read
// like any other, as JAX reads them.
//
// What bounds it on an H100: bytes (the index and value streams, read
// once each, the x gather and y).  What the design does about it:
// - Slot-major storage: the 32 rows of a warp read one contiguous run of
//   each slot (128 bytes of indices, 128 or 256 of values), through the
//   streaming path (__ldcs: read once, evict first), x through the
//   read-only path (__ldg).
// - A thread loads G slots' indices and values, then their G x values,
//   before it adds them in order, so that G gathers are in flight.
// A column outside [0, num_columns) is skipped (the host never builds
// one).  Under accumulate y[i] + sum is written, else the sum.  y must
// not overlap x.

#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ell_spmv_kernel(const int* __restrict__ column_index,
                    const T* __restrict__ value, int row_length,
                    int64_t num_rows, int64_t num_columns,
                    const T* __restrict__ x, T* __restrict__ y,
                    bool accumulate) {
  constexpr int G = 4;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= num_rows) return;
  const int* cp = column_index + i;
  const T* vp = value + i;
  T acc = T(0);
  for (int s0 = 0; s0 < row_length; s0 += G) {
    int col[G];
    T v[G];
    T xv[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const bool live = s0 + q < row_length;
      const int64_t at = static_cast<int64_t>(s0 + q) * num_rows;
      col[q] = live ? __ldcs(cp + at) : -1;
      v[q] = live ? __ldcs(vp + at) : T(0);
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const bool ok = static_cast<unsigned>(col[q]) <
                      static_cast<uint64_t>(num_columns);
      xv[q] = ok ? __ldg(x + col[q]) : T(0);
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (static_cast<unsigned>(col[q]) < static_cast<uint64_t>(num_columns))
        acc += v[q] * xv[q];
    }
  }
  y[i] = accumulate ? y[i] + acc : acc;
}

template <typename T>
cudaError_t launch(const void* column_index, const void* value,
                   int row_length, int64_t num_rows, int64_t num_columns,
                   const void* x, void* y, bool accumulate,
                   cudaStream_t stream) {
  const int64_t blocks = (num_rows + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  if (row_length < 0 || blocks > 0x7fffffff) return cudaErrorInvalidValue;
  ell_spmv_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                       stream>>>(
      static_cast<const int*>(column_index), static_cast<const T*>(value),
      row_length, num_rows, num_columns, static_cast<const T*>(x),
      static_cast<T*>(y), accumulate);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launch (0 on success).  dtype is
// kFloat32 or kFloat64 (dia_common.cuh); column_index and value are
// (row_length, num_rows), slot-major.
extern "C" int ell_spmv_launch(int dtype, int device,
                               const void* column_index, const void* value,
                               int row_length, long long num_rows,
                               long long num_columns, const void* x, void* y,
                               int accumulate, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float>(column_index, value, row_length, num_rows,
                           num_columns, x, y, accumulate != 0, s);
    case kFloat64:
      return launch<double>(column_index, value, row_length, num_rows,
                            num_columns, x, y, accumulate != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

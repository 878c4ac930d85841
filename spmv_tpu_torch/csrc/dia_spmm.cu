// Kernel K2: DIA SpMM, Y = A X for k right-hand sides.
//
// Replaces the Pallas kernel _dia_spmm_kernel
// (spmv_tpu/ops/pallas_kernels.py, def at line 710, launched by
// dia_spmm_core).  X is (num_columns, k) and Y is (num_rows, k), both
// row-major, so one row's k values are contiguous.
//
//   Y[i, c] = sum_d data[d * num_rows + i] * X[i + offsets[d], c]
//
// What bounds it on an H100: bytes, as for K1, but the diagonal stream is
// shared by all k columns: per row D diagonal values, D * k X values and
// k Y values.  The point of a multi-vector kernel is to read each
// diagonal value once for all k columns instead of once per column.
//
// What this simple design does about it: one thread per row holds the
// row's k sums in registers, in chunks of kChunk columns, and reads
// data[d, i] once per chunk, so for k <= kChunk (the main path runs k = 4)
// each diagonal value is read exactly once.  A warp's data reads are
// coalesced; its X reads cover 32 * k contiguous values per diagonal,
// fetched through L1 across the column loop.  Bounds checks on i + offset
// replace the TPU's zero-padded layout; Y never aliases X.

#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kChunk = 8;

template <typename T, typename Acc>
__global__ void __launch_bounds__(1024)
    dia_spmm_kernel(const T* __restrict__ data,
                    const int* __restrict__ offsets, int num_diagonals,
                    int64_t num_rows, int64_t num_columns, int k,
                    const T* __restrict__ X, T* __restrict__ Y) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= num_rows) return;
  for (int c0 = 0; c0 < k; c0 += kChunk) {
    const int kc = min(kChunk, k - c0);
    Acc acc[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) acc[c] = Acc(0);
    for (int d = 0; d < num_diagonals; ++d) {
      const int64_t j = i + __ldg(offsets + d);
      if (j < 0 || j >= num_columns) continue;
      const Acc a =
          to_acc<Acc>(data[static_cast<int64_t>(d) * num_rows + i]);
      const T* xr = X + j * k + c0;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (c < kc) acc[c] += a * to_acc<Acc>(xr[c]);
      }
    }
    T* yr = Y + i * k + c0;
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (c < kc) yr[c] = from_acc<T>(acc[c]);
    }
  }
}

template <typename T, typename Acc>
cudaError_t launch(const void* data, const void* offsets, int num_diagonals,
                   int64_t num_rows, int64_t num_columns, int k,
                   const void* X, void* Y, int threads,
                   cudaStream_t stream) {
  const int64_t blocks = (num_rows + threads - 1) / threads;
  if (blocks == 0 || k == 0) return cudaSuccess;
  dia_spmm_kernel<T, Acc>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
          static_cast<const T*>(data), static_cast<const int*>(offsets),
          num_diagonals, num_rows, num_columns, k,
          static_cast<const T*>(X), static_cast<T*>(Y));
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launch (0 on success).
extern "C" int dia_spmm_launch(int dtype, int device, const void* data,
                               const void* offsets, int num_diagonals,
                               long long num_rows, long long num_columns,
                               int k, const void* X, void* Y, int threads,
                               void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float, float>(data, offsets, num_diagonals, num_rows,
                                  num_columns, k, X, Y, threads, s);
    case kFloat64:
      return launch<double, double>(data, offsets, num_diagonals, num_rows,
                                    num_columns, k, X, Y, threads, s);
    case kBFloat16:
      return launch<__nv_bfloat16, float>(data, offsets, num_diagonals,
                                          num_rows, num_columns, k, X, Y,
                                          threads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

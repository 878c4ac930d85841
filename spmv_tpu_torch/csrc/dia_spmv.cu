// Kernel K1: DIA SpMV, y = A x, with an optional fused dot <x, A x>.
//
// Replaces the Pallas kernel _dia_kernel (spmv_tpu/ops/pallas_kernels.py,
// def at line 196, launched by dia_spmv_core).
//
//   y[i] = sum_k data[k * num_rows + i] * x[i + offsets[k]]
//
// What bounds it on an H100: bytes.  Each row reads D diagonal values and
// D x values and writes one y value for 2 D flops, far below the card's
// flops-per-byte balance, so the time is the diagonal stream (D * rows
// values) plus the x and y vectors over device-memory bandwidth.
//
// What this simple design does about it: one thread per row, so a warp's
// reads of data[k, i..i+31] and of x[i+off .. i+off+31] are contiguous and
// coalesced for every diagonal, each diagonal value is read exactly once,
// and the shifted x windows of neighbouring diagonals overlap and mostly
// hit L1/L2 rather than device memory.  The TPU kernel needed a lane fold,
// a sliding VMEM window and explicit DMAs to get the same effect; a GPU's
// caches do that here.  The bounds check on i + offset replaces the TPU's
// zero-padded layout.  Outputs never alias x (blocks run in no order, so
// the TPU's in-place variant has no counterpart): chained callers alternate
// between two buffers.
//
// Fused dot (with_dot): each block sums its rows' x[i] * y[i] (in the
// accumulator type, before y is rounded to storage) with warp shuffles and
// shared memory, and writes one partial to partials[blockIdx.x].  The
// wrapper sums the partials.  No atomics: the result is deterministic.

#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, typename Acc, bool WithDot>
__global__ void __launch_bounds__(1024)
    dia_spmv_kernel(const T* __restrict__ data,
                    const int* __restrict__ offsets, int num_diagonals,
                    int64_t num_rows, int64_t num_columns,
                    const T* __restrict__ x, T* __restrict__ y,
                    Acc* __restrict__ partials) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  Acc acc = Acc(0);
  if (i < num_rows) {
    for (int k = 0; k < num_diagonals; ++k) {
      const int64_t j = i + __ldg(offsets + k);
      if (j >= 0 && j < num_columns) {
        acc += to_acc<Acc>(data[static_cast<int64_t>(k) * num_rows + i]) *
               to_acc<Acc>(x[j]);
      }
    }
    y[i] = from_acc<T>(acc);
  }
  if (WithDot) {
    // Every thread takes part, rows past the end with a zero term.
    Acc term = (i < num_rows && i < num_columns) ? to_acc<Acc>(x[i]) * acc
                                                 : Acc(0);
    __shared__ Acc warp_sums[32];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    term = warp_sum(term);
    if (lane == 0) warp_sums[warp] = term;
    __syncthreads();
    if (warp == 0) {
      const int nwarps = (blockDim.x + 31) >> 5;
      term = lane < nwarps ? warp_sums[lane] : Acc(0);
      term = warp_sum(term);
      if (lane == 0) partials[blockIdx.x] = term;
    }
  }
}

template <typename T, typename Acc>
cudaError_t launch(const void* data, const void* offsets, int num_diagonals,
                   int64_t num_rows, int64_t num_columns, const void* x,
                   void* y, void* partials, int threads,
                   cudaStream_t stream) {
  const int64_t blocks = (num_rows + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  const T* d = static_cast<const T*>(data);
  const int* off = static_cast<const int*>(offsets);
  const T* xv = static_cast<const T*>(x);
  T* yv = static_cast<T*>(y);
  if (partials != nullptr) {
    dia_spmv_kernel<T, Acc, true>
        <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
            d, off, num_diagonals, num_rows, num_columns, xv, yv,
            static_cast<Acc*>(partials));
  } else {
    dia_spmv_kernel<T, Acc, false>
        <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
            d, off, num_diagonals, num_rows, num_columns, xv, yv, nullptr);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launch (0 on success).  `partials` is
// null for a plain SpMV; otherwise it holds ceil(num_rows / threads)
// accumulator-typed values (double for double data, else float).
extern "C" int dia_spmv_launch(int dtype, int device, const void* data,
                               const void* offsets, int num_diagonals,
                               long long num_rows, long long num_columns,
                               const void* x, void* y, void* partials,
                               int threads, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float, float>(data, offsets, num_diagonals, num_rows,
                                  num_columns, x, y, partials, threads, s);
    case kFloat64:
      return launch<double, double>(data, offsets, num_diagonals, num_rows,
                                    num_columns, x, y, partials, threads, s);
    case kBFloat16:
      return launch<__nv_bfloat16, float>(data, offsets, num_diagonals,
                                          num_rows, num_columns, x, y,
                                          partials, threads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* spmv_tpu_torch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

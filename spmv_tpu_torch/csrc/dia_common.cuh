// Shared helpers of the DIA kernels (dia_spmv.cu, dia_spmm.cu), and the
// codes every launcher takes (the storage type, a traffic mode).
//
// Storage types and their accumulators, as in the Pallas kernels
// (spmv_tpu/ops/pallas_kernels.py:225-229): float and double accumulate
// in their own type, bfloat16 storage accumulates in float.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace spmv_tpu_torch {

// Codes the Python wrappers pass for the storage type.
enum DtypeCode : int { kFloat32 = 0, kFloat64 = 1, kBFloat16 = 2 };

// What a CSR, ELL or WELL SpMV launch computes (csr_spmv.cu, ell_spmv.cu,
// well_spmv.cu): the product, or one of its two traffic-isolation
// variants over the same walk, each with one stream left out: the
// stream-only sum of the values (no index load, no x gather) or the
// gather-only sum of x at the indices (no value load).
enum TrafficMode : int { kFull = 0, kRegular = 1, kIrregular = 2 };

// run(std::integral_constant<int, m>()) for the TrafficMode m == mode;
// cudaErrorInvalidValue for any other mode.
template <typename Run>
int by_mode(int mode, Run run) {
  switch (mode) {
    case kFull:
      return run(std::integral_constant<int, kFull>());
    case kRegular:
      return run(std::integral_constant<int, kRegular>());
    case kIrregular:
      return run(std::integral_constant<int, kIrregular>());
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Acc, typename T>
__device__ __forceinline__ Acc to_acc(T v) {
  return static_cast<Acc>(v);
}
template <>
__device__ __forceinline__ float to_acc<float, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, typename Acc>
__device__ __forceinline__ T from_acc(Acc v) {
  return static_cast<T>(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16, float>(
    float v) {
  return __float2bfloat16(v);
}

}  // namespace spmv_tpu_torch

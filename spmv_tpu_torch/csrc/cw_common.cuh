// Shared helpers of the WELL-CW kernels (wellcw_spmv.cu, wellcw_spmm.cu):
// the cell addressing and the x gather.
//
// A chunk is 8 slots x 128 lanes; lane l of a chunk serves row
// group * 128 + l.  Cell (c, s, l) holds value[(c * 8 + s) * 128 + l]
// and reads x at column
//
//   (anchor4[c] * d + w) * 128 + (loc & 127),  loc = local_index[same]
//
// with w = loc >> 7 for levels and pools, and w = (loc >> 7) & (8 d - 1)
// for merged chunks, whose bits 14 and up carry the pool row
// (spmv_tpu/ops/spmv.py:124, :152-154).  The Pallas kernels read x from
// zero-padded stride-d tables, so a column past the end reads 0 here
// too (padding cells hold value 0 but may point past the end; clipping
// instead would turn an inf there into NaN).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace spmv_tpu_torch {

constexpr int kCwSlots = 8;
constexpr int kCwLanes = 128;
constexpr int kCwChunk = kCwSlots * kCwLanes;

__device__ __forceinline__ int64_t cw_column(int anchor4, int d, int w,
                                             int loc) {
  return (static_cast<int64_t>(anchor4) * d + w) * kCwLanes + (loc & 127);
}

template <typename T>
__device__ __forceinline__ T cw_x(const T* __restrict__ x,
                                  int64_t num_columns, int anchor4, int d,
                                  int w, int loc) {
  const int64_t col = cw_column(anchor4, d, w, loc);
  return col < num_columns ? __ldg(x + col) : T(0);
}

}  // namespace spmv_tpu_torch

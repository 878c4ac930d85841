// Shared helpers of the WELL-CW kernels (wellcw_spmv.cu, wellcw_spmm.cu):
// the cell addressing, the x gather and a level chunk's strip of X
// columns.
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

// Sum of one level chunk's 8 slots in lane `lane`, for columns [c0, c0 +
// kc) of a row-major X (num_columns, k), kc <= KB: strip[j] is column c0
// + j's chunk sum, added slot by slot in the order K3a adds them
// (wellcw_spmv.cu), so each column sums as the SpMV does.
template <typename T, int KB>
__device__ __forceinline__ void cw_strip_cols(
    const T* __restrict__ value, const int* __restrict__ local_index,
    int anchor4, int d, int64_t chunk, int lane, const T* __restrict__ X,
    int64_t num_columns, int k, int c0, int kc, T (&strip)[KB]) {
  const int64_t base = chunk * kCwChunk + lane;
  int loc[kCwSlots];
  T val[kCwSlots];
#pragma unroll
  for (int s = 0; s < kCwSlots; ++s) {
    loc[s] = local_index[base + s * kCwLanes];
    val[s] = value[base + s * kCwLanes];
  }
#pragma unroll
  for (int j = 0; j < KB; ++j) strip[j] = T(0);
#pragma unroll
  for (int s = 0; s < kCwSlots; ++s) {
    const int64_t col = cw_column(anchor4, d, loc[s] >> 7, loc[s]);
    if (col >= num_columns) continue;        // reads 0: adds nothing
    const T* xr = X + col * k + c0;
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      if (j < kc) strip[j] += val[s] * __ldg(xr + j);
    }
  }
}

}  // namespace spmv_tpu_torch

// The long rows of the CSR kernels (csr_spmv.cu, csr_spmm.cu): the roles
// of a launch's blocks, a lane's strided sum of a long row, and the fixed
// trees that add the lanes and the warps.
//
// DeviceCsr (models/device.py, csr_row_split) lists the rows with more
// than max_short entries, longest first; the first num_block of them
// take a whole block, the rest a warp.  A launch of 256-thread blocks
// runs three roles by block index, in this order:
// - blocks [0, num_block): block b sums long row b with all its threads;
// - the next ceil((num_long - num_block) / 8) blocks: warp w of block b
//   sums long row num_block + 8 (b - num_block) + w;
// - the rest: one thread a short row, as without long rows; a thread
//   that finds a long row (more than max_short entries) leaves it.
// Thread t of a long row's S threads (32 in a warp, 256 in a block) sums
// the row's entries t, t + S, t + 2S, ... in storage order, each product
// rounded and then added (no fused multiply-add, so that a plain walk in
// numpy repeats the bits); a fixed shuffle tree (offsets 16, 8, 4, 2, 1)
// adds a warp's lanes into lane 0, and in a block thread 0 adds the
// eight warps' totals in a fixed tree (offsets 4, 2, 1).  No atomics:
// two launches give the same bits, and column j of the SpMM is the SpMV
// of column j.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace spmv_tpu_torch {

constexpr int kCsrThreads = 256;
constexpr int kCsrWarps = kCsrThreads / 32;

// The long rows of a launch (rows null: none, and the launch is the
// short walk alone).
struct LongRows {
  const int* rows;     // long_rows, longest first
  int64_t num_long;    // its length
  int64_t num_block;   // its first num_block rows take a block each
  int max_short;       // a row with more entries is long

  // the launch's blocks that sum long rows
  __host__ __device__ int64_t blocks() const {
    return num_block + (num_long - num_block + kCsrWarps - 1) / kCsrWarps;
  }
};

// Where block b (< lr.blocks()) puts this thread: the long row it sums
// (-1 for a warp past the list's end), its place t among the row's S
// threads, and whether the whole block sums the row.
struct LongRole {
  int64_t r;
  int t, S;
  bool whole;
};

__device__ __forceinline__ LongRole long_role(const LongRows& lr,
                                              int64_t b) {
  if (b < lr.num_block) return {b, static_cast<int>(threadIdx.x),
                                kCsrThreads, true};
  const int64_t r = lr.num_block + (b - lr.num_block) * kCsrWarps +
                    (threadIdx.x >> 5);
  return {r < lr.num_long ? r : -1, static_cast<int>(threadIdx.x & 31), 32,
          false};
}

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// G entries of a long row from entry e on, S apart: their columns and
// values, -1 and 0 at or past end.
template <typename T, int G>
__device__ __forceinline__ void load_strided(const int* col, const T* val,
                                             int64_t e, int64_t end, int S,
                                             int (&c)[G], T (&v)[G]) {
#pragma unroll
  for (int q = 0; q < G; ++q) {
    const int64_t j = e + static_cast<int64_t>(q) * S;
    const bool live = j < end;
    c[q] = live ? __ldg(col + j) : -1;
    v[q] = live ? __ldg(val + j) : T(0);
  }
}

// The lane's column sums over entries e, e + S, ... < end of a long row:
// acc[j] for the kc <= KB columns of X at Xc (X's rows k apart), G
// entries' X rows in flight while the next G entries load.  A column
// outside [0, num_columns) is skipped.
template <typename T, int KB, int G, typename LoadRow>
__device__ __forceinline__ void lane_sums(const int* __restrict__ col,
                                          const T* __restrict__ val,
                                          int64_t e, int64_t end, int S,
                                          int64_t num_columns,
                                          LoadRow load_row_of,
                                          T (&acc)[KB]) {
#pragma unroll
  for (int j = 0; j < KB; ++j) acc[j] = T(0);
  int c[G];
  T v[G];
  load_strided<T, G>(col, val, e, end, S, c, v);
  for (; e < end; e += static_cast<int64_t>(G) * S) {
    T xv[G][KB];
    bool ok[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      ok[q] = c[q] >= 0 && c[q] < num_columns;
      load_row_of(ok[q] ? c[q] : 0, ok[q], xv[q]);
    }
    int nc[G];
    T nv[G];
    load_strided<T, G>(col, val, e + static_cast<int64_t>(G) * S, end, S,
                       nc, nv);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (!ok[q]) continue;
#pragma unroll
      for (int j = 0; j < KB; ++j) acc[j] += mul_rn(v[q], xv[q][j]);
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      c[q] = nc[q];
      v[q] = nv[q];
    }
  }
}

// The warp's sums into lane 0 (the other lanes hold partial sums).
template <typename T, int KB>
__device__ __forceinline__ void warp_sums(T (&s)[KB]) {
#pragma unroll
  for (int j = 0; j < KB; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s[j] += __shfl_down_sync(0xffffffffu, s[j], off);
  }
}

// The block's sums into thread 0, from each warp's lane 0; every thread
// of the block calls it.
template <typename T, int KB>
__device__ __forceinline__ void block_sums(T (&s)[KB]) {
  __shared__ T part[kCsrWarps][KB];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < KB; ++j) part[warp][j] = s[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int off = kCsrWarps / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int w = 0; w < off; ++w) {
#pragma unroll
        for (int j = 0; j < KB; ++j) part[w][j] += part[w + off][j];
      }
    }
#pragma unroll
    for (int j = 0; j < KB; ++j) s[j] = part[0][j];
  }
}

// A long row's sums, in the thread that writes them (thread 0 of a
// block, lane 0 of a warp): calls write(i, s) there.  lane_sums_of(e,
// end, S, acc) sums a lane's entries.
template <typename T, int KB, typename Sums, typename Write>
__device__ __forceinline__ void long_row(const int* __restrict__ row_ptr,
                                         const LongRows& lr, int64_t b,
                                         Sums lane_sums_of, Write write) {
  const LongRole role = long_role(lr, b);
  if (role.r < 0) return;   // a whole warp past the list's end
  const int64_t i = __ldg(lr.rows + role.r);
  const int64_t start = __ldg(row_ptr + i);
  const int64_t end = __ldg(row_ptr + i + 1);
  T s[KB];
  lane_sums_of(start + role.t, end, role.S, s);
  warp_sums<T, KB>(s);
  if (role.whole) block_sums<T, KB>(s);
  if ((role.whole ? threadIdx.x : threadIdx.x & 31) == 0) write(i, s);
}

}  // namespace spmv_tpu_torch

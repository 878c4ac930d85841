// CSR SpMM: Y (+)= A X over row_ptr / column_index / value (int32
// indices), X (num_columns, k) and Y (num_rows, k) row-major.
//
// Not a TPU kernel: the JAX package sums CSR in XLA (the DeviceCsr branch
// of spmm, spmv_tpu/ops/spmv.py:266-273, a gather and a segment sum).
// It serves the WELL-CW remainder of the SpMM (added after K4a-c,
// accumulate = 1), the hybrid's COO part (accumulate = 1) and plain CSR
// products (accumulate = 0).  A scatter with atomics, as index_add_ does
// on CUDA, would add in no fixed order; each (row, column block) is
// summed by one thread, warp or block in the order csr_spmv.cu sums each
// column, so two runs give bitwise equal Y and column j is the SpMV of
// X[:, j] bit for bit.
//
// What bounds it on an H100: bytes (the value and column index streams,
// the X gather of kb contiguous values an entry, and Y), for a thin
// matrix the latency of its chain of dependent loads, and on a skewed
// matrix the longest row (the hybrid's COO part at k = 8 took 9.8 ms a
// thread a row, its longest row 44,547 entries).  The WELL-CW remainder
// of the bench leg holds 2,030 entries in 1,723 of its 1M rows: a
// thread for every row would read the whole row_ptr to find them.  What
// the design does about it:
// - The container lists the short rows that own an entry
//   (DeviceCsr.row_list, built on the host; null where every row owns
//   one, and then thread i takes row i and leaves it if it is long), and
//   one thread takes each listed row and column block of kb <= 8
//   columns, its sums in registers.
// - It lists the long rows apart (DeviceCsr.long_rows, longest first):
//   the launch's first blocks sum them, a warp or a block a row, a lane
//   holding its kb column sums over a strided subset of the row, then a
//   fixed shuffle tree and block tree a column (csr_rows.cuh).
// - A thread loads the next G entries' columns and values while the X
//   rows of these G are in flight (K4c's walk), and the old Y row, under
//   accumulate, before the walk, so that its latency hides under it.
// - X rows and Y rows move 16 bytes at a time where X's rows and the
//   column block are whole 16-byte runs and X and Y are aligned
//   (spmm_rows.cuh), else one value at a time.
// - Output: with a row list, a product's first launch (accumulate = 0)
//   zeroes Y (cudaMemsetAsync, zero_y) and then writes the listed and
//   the long rows, so a row with no entry holds +0.0, the sum of no
//   entry; under accumulate such a row is not written.  Without a list
//   every row is written.
// A column outside [0, num_columns) is skipped.  Y must not overlap X.

#include "csr_rows.cuh"
#include "dia_common.cuh"
#include "spmm_rows.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kThreads = kCsrThreads;

// grid (lr.blocks() + ceil(num_listed / 256), ceil(k / kb)): blocks
// [0, lr.blocks()) sum the long rows (Split only, csr_rows.cuh); thread
// t of the later blocks owns row row_list[t] (row t without a list); y
// is the column block of kb <= KB columns.
template <typename T, int KB, bool Vec, bool Split>
__global__ void __launch_bounds__(kThreads)
    csr_spmm_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ row_list,
                    const int* __restrict__ column_index,
                    const T* __restrict__ value, int64_t num_listed,
                    int64_t num_columns, LongRows lr, int k, int kb,
                    const T* __restrict__ X, T* __restrict__ Y,
                    bool accumulate) {
  // 32 words of X in flight (4 entries at k = 8 in float32): 16 and 64
  // words were 5% and 10% slower on the whole bench matrix, and a floor
  // of four CTAs an SM (64 registers) no faster
  constexpr int W = KB * static_cast<int>(sizeof(T)) / 4;
  constexpr int G = 32 / W < 8 ? 32 / W : 8;
  int64_t b = blockIdx.x;
  if constexpr (Split) {
    if (b < lr.blocks()) {
      const int c0 = blockIdx.y * kb;
      const int kc = min(kb, k - c0);
      const T* Xc = X + c0;
      const auto load_x = [&](int64_t c, bool ok, T(&xv)[KB]) {
        load_row<T, KB, Vec>(Xc + c * k, ok ? kc : 0, xv);
      };
      long_row<T, KB>(
          row_ptr, lr, b,
          [&](int64_t e, int64_t end, int S, T(&acc)[KB]) {
            lane_sums<T, KB, G>(column_index, value, e, end, S,
                                num_columns, load_x, acc);
          },
          [&](int64_t i, const T(&s)[KB]) {
            T* yr = Y + i * k + c0;
            T out[KB];
            load_row<T, KB, Vec, false>(yr, accumulate ? kc : 0, out);
#pragma unroll
            for (int j = 0; j < KB; ++j)
              out[j] = accumulate ? out[j] + s[j] : s[j];
            store_row<T, KB, Vec>(yr, kc, out);
          });
      return;
    }
    b -= lr.blocks();
  }
  const int64_t t = b * blockDim.x + threadIdx.x;
  if (t >= num_listed) return;
  const int64_t i = row_list != nullptr ? __ldg(row_list + t) : t;
  const int start = __ldg(row_ptr + i);
  const int len = __ldg(row_ptr + i + 1) - start;
  if constexpr (Split) {
    if (len > lr.max_short) return;
  }
  if (accumulate && len == 0) return;
  const int c0 = blockIdx.y * kb;
  const int kc = min(kb, k - c0);
  const T* Xc = X + c0;
  T* yr = Y + i * k + c0;
  T out[KB];
  load_row<T, KB, Vec, false>(yr, accumulate ? kc : 0, out);
  T acc[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) acc[j] = T(0);
  const int* cp = column_index + start;
  const T* vp = value + start;
  int col[G];
  T v[G];
  load_cells<T, G, 1>(cp, vp, 0, len, col, v);
  for (int e = 0; e < len; e += G) {
    T xv[G][KB];
    bool ok[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      // -1 past the row's end; outside [0, num_columns): skipped
      ok[q] = col[q] >= 0 && col[q] < num_columns;
      const int64_t c = ok[q] ? col[q] : 0;
      load_row<T, KB, Vec>(Xc + c * k, ok[q] ? kc : 0, xv[q]);
    }
    int next_col[G];
    T next_v[G];
    load_cells<T, G, 1>(cp, vp, e + G, len, next_col, next_v);
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (!ok[q]) continue;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (j < kc) acc[j] += v[q] * xv[q][j];
      }
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      col[q] = next_col[q];
      v[q] = next_v[q];
    }
  }
#pragma unroll
  for (int j = 0; j < KB; ++j) out[j] = accumulate ? out[j] + acc[j] : acc[j];
  store_row<T, KB, Vec>(yr, kc, out);
}

// Every argument of a launch, passed on as it is.
struct Args {
  const void* row_ptr;
  const void* row_list;
  const void* column_index;
  const void* value;
  int64_t num_listed, num_rows, num_columns;
  LongRows lr;
  int k, kb;
  const void* X;
  void* Y;
  bool zero_y, accumulate;
};

template <typename T>
cudaError_t launch(const Args& a, bool vector_x, cudaStream_t stream) {
  if (a.num_rows == 0 || a.k == 0) return cudaSuccess;
  if (column_blocks(a.k, a.kb) == 0) return cudaErrorInvalidValue;
  if (a.zero_y) {
    cudaError_t e = cudaMemsetAsync(
        a.Y, 0, static_cast<size_t>(a.num_rows) * a.k * sizeof(T), stream);
    if (e != cudaSuccess) return e;
  }
  const int64_t blocks =
      a.lr.blocks() + (a.num_listed + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(blocks), column_blocks(a.k, a.kb));
  return by_width<T>(a.k, a.kb, vector_x, a.X, a.Y, [&](auto w, auto vec) {
    constexpr int KB = decltype(w)::value;
    constexpr bool V = decltype(vec)::value;
    const auto args = [&](auto kernel) {
      kernel<<<grid, kThreads, 0, stream>>>(
          static_cast<const int*>(a.row_ptr),
          static_cast<const int*>(a.row_list),
          static_cast<const int*>(a.column_index),
          static_cast<const T*>(a.value), a.num_listed, a.num_columns, a.lr,
          a.k, a.kb, static_cast<const T*>(a.X), static_cast<T*>(a.Y),
          a.accumulate);
    };
    if (a.lr.rows != nullptr)
      args(csr_spmm_kernel<T, KB, V, true>);
    else
      args(csr_spmm_kernel<T, KB, V, false>);
    return cudaGetLastError();
  });
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launch (0 on success).  dtype is
// kFloat32 or kFloat64 (dia_common.cuh); row_list is the num_listed short
// rows that own an entry, ascending, or null (num_listed = num_rows);
// long_rows is the num_long rows with more than max_short entries,
// longest first, the first num_block of them summed by a block each
// (csr_rows.cuh), or null; kb is the column-block width, at most 8;
// vector_x asks for 16-byte X and Y loads (k and kb whole 16-byte runs,
// X and Y aligned); zero_y zeroes Y before the rows are written.
extern "C" int csr_spmm_launch(int dtype, int device, const void* row_ptr,
                               const void* row_list,
                               const void* column_index, const void* value,
                               long long num_listed, long long num_rows,
                               long long num_columns, const void* long_rows,
                               long long num_long, long long num_block,
                               int max_short, int k, int kb, int vector_x,
                               int zero_y, const void* X, void* Y,
                               int accumulate, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LongRows lr = {static_cast<const int*>(long_rows),
                       long_rows != nullptr ? num_long : 0,
                       long_rows != nullptr ? num_block : 0, max_short};
  const Args a = {row_ptr, row_list, column_index, value, num_listed,
                  num_rows, num_columns, lr, k, kb, X, Y, zero_y != 0,
                  accumulate != 0};
  switch (dtype) {
    case kFloat32:
      return launch<float>(a, vector_x != 0, s);
    case kFloat64:
      return launch<double>(a, vector_x != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

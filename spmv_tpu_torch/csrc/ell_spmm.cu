// ELL SpMM: Y (+)= A X over slot-major column_index / value, both
// (row_length, num_rows), X (num_columns, k) and Y (num_rows, k)
// row-major.
//
// Not a TPU kernel: the JAX package sums ELL in XLA (the DeviceEll
// branch of spmm, spmv_tpu/ops/spmv.py:274-276, a gather of X rows and a
// sum over the slots).  It is written by hand, as ell_spmv.cu is, so
// that the format's own SpMM runs a fixed-order kernel: one thread a
// (row, column block) adds the row's slots 0..L-1 in order for each
// column, as ell_spmv.cu does for one column, so two runs give bitwise
// equal Y and column j sums as the SpMV of X[:, j] does.
//
// What bounds it on an H100: bytes (the index and value streams once,
// the X gather of kb contiguous values a slot, Y once).  What the design
// does about it:
// - A thread holds its row's kb <= 8 column sums in registers
//   (spmm_rows.cuh), so the slot streams are read once a column block
//   (once in all for k <= 8); column blocks of 8 lie on the grid's y.
// - Slot-major storage: a warp's 32 rows read one contiguous run of a
//   slot, through the streaming path (__ldcs).
// - A thread loads G slots' indices and values, then their G X rows, so
//   that G gathers are in flight (G * kb words: 32 at kb = 8 in float32).
// - X rows and Y rows move 16 bytes at a time where X's rows and the
//   column block are whole 16-byte runs and X and Y are aligned
//   (spmm_rows.cuh's Vec path, spmm_plan in ops/_launch.py), else one
//   value at a time.
// A column outside [0, num_columns) is skipped.  Every row of the
// column block is written: under accumulate its old value plus the sum.
// Y must not overlap X.

#include "dia_common.cuh"
#include "spmm_rows.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kThreads = 256;

// grid (ceil(num_rows / 256), ceil(k / kb)); thread t of x owns row t, y
// is the column block of kb <= KB columns.
template <typename T, int KB, bool Vec>
__global__ void __launch_bounds__(kThreads)
    ell_spmm_kernel(const int* __restrict__ column_index,
                    const T* __restrict__ value, int row_length,
                    int64_t num_rows, int64_t num_columns, int k, int kb,
                    const T* __restrict__ X, T* __restrict__ Y,
                    bool accumulate) {
  constexpr int W = KB * static_cast<int>(sizeof(T)) / 4;
  constexpr int G = 32 / W < 8 ? 32 / W : 8;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= num_rows) return;
  const int c0 = blockIdx.y * kb;
  const int kc = min(kb, k - c0);
  const T* Xc = X + c0;
  T* yr = Y + i * k + c0;
  T out[KB];
  load_row<T, KB, Vec, false>(yr, accumulate ? kc : 0, out);
  T acc[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) acc[j] = T(0);
  const int* cp = column_index + i;
  const T* vp = value + i;
  for (int s0 = 0; s0 < row_length; s0 += G) {
    int col[G];
    T v[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const bool live = s0 + q < row_length;
      const int64_t at = static_cast<int64_t>(s0 + q) * num_rows;
      col[q] = live ? __ldcs(cp + at) : -1;
      v[q] = live ? __ldcs(vp + at) : T(0);
    }
    T xv[G][KB];
    bool ok[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      // -1 past the row's end; outside [0, num_columns): skipped
      ok[q] = col[q] >= 0 && col[q] < num_columns;
      const int64_t c = ok[q] ? col[q] : 0;
      load_row<T, KB, Vec>(Xc + c * k, ok[q] ? kc : 0, xv[q]);
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (!ok[q]) continue;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (j < kc) acc[j] += v[q] * xv[q][j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KB; ++j) out[j] = accumulate ? out[j] + acc[j] : acc[j];
  store_row<T, KB, Vec>(yr, kc, out);
}

// Every argument of a launch, passed on as it is.
struct Args {
  const void* column_index;
  const void* value;
  int row_length;
  int64_t num_rows, num_columns;
  int k, kb;
  const void* X;
  void* Y;
  bool accumulate;
};

template <typename T>
cudaError_t launch(const Args& a, bool vector_x, cudaStream_t stream) {
  if (a.num_rows == 0 || a.k == 0) return cudaSuccess;
  const int64_t blocks = (a.num_rows + kThreads - 1) / kThreads;
  if (column_blocks(a.k, a.kb) == 0 || a.row_length < 0 ||
      blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), column_blocks(a.k, a.kb));
  return by_width<T>(a.k, a.kb, vector_x, a.X, a.Y, [&](auto w, auto vec) {
    ell_spmm_kernel<T, decltype(w)::value, decltype(vec)::value>
        <<<grid, kThreads, 0, stream>>>(
            static_cast<const int*>(a.column_index),
            static_cast<const T*>(a.value), a.row_length, a.num_rows,
            a.num_columns, a.k, a.kb, static_cast<const T*>(a.X),
            static_cast<T*>(a.Y), a.accumulate);
    return cudaGetLastError();
  });
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launch (0 on success).  dtype is
// kFloat32 or kFloat64 (dia_common.cuh); column_index and value are
// (row_length, num_rows), slot-major; kb is the column-block width, at
// most 8; vector_x asks for 16-byte X and Y moves (k and kb whole
// 16-byte runs, X and Y aligned).
extern "C" int ell_spmm_launch(int dtype, int device,
                               const void* column_index, const void* value,
                               int row_length, long long num_rows,
                               long long num_columns, int k, int kb,
                               int vector_x, const void* X, void* Y,
                               int accumulate, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a = {column_index, value, row_length, num_rows, num_columns,
                  k, kb, X, Y, accumulate != 0};
  switch (dtype) {
    case kFloat32:
      return launch<float>(a, vector_x != 0, s);
    case kFloat64:
      return launch<double>(a, vector_x != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

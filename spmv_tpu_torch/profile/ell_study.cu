// Variants of the ELL SpMV for the measurements of profile/ell_study.py:
// none of them is on a path of the port.  The file includes the kernel
// itself (csrc/ell_spmv.cu, so its kernel and ell_rows are here, built
// with the -D settings of a sweep) and adds:
// - ell_study_rows_launch: that kernel at R rows a thread (1, 2 or 4);
// - ell_study_before_launch: the kernel before the redesign (a thread a
//   row, rounds of 4 slots: loads, gathers and adds in turn), as it was,
//   over the slot-major buffers or over a copy cut into slices of 32
//   rows, each slice's slots contiguous (slot s of row i at (i / 32) 32 L
//   + 32 s + i % 32);
// - ell_study_layout_launch: the redesigned kernel's rows (ell_rows, R
//   rows a thread) over the slot-major buffers or over slices of h rows;
// - ell_study_gather_launch: the x gathers of an ELL launch without its
//   index and value streams: slot s of row i gathers x at a hash of (i,
//   s) below num_columns where s < length[i] (a byte a row), else x[0],
//   as the padding slots do, and y is their sum;
// - ell_study_hybrid_launch: a hybrid SpMV in one launch: a thread sums
//   its rows' ELL slots and then adds each row's short COO entries (the
//   CSR kernel's short walk), the long COO rows on warps and blocks as in
//   csr_spmv.cu, whose writer sums the row's ELL slots first, so y_i =
//   ell_sum + coo_sum as the two launches give.

#include "csr_rows.cuh"
#include "ell_spmv.cu"

namespace spmv_tpu_torch {
namespace {

constexpr int kStudyThreads = 256;

// The kernel before the redesign, as it was; Slice > 0 reads a copy cut
// into slices of Slice rows.
template <typename T, int Slice>
__global__ void __launch_bounds__(kStudyThreads)
    before_kernel(const int* __restrict__ column_index,
                  const T* __restrict__ value, int row_length,
                  int64_t num_rows, int64_t num_columns,
                  const T* __restrict__ x, T* __restrict__ y,
                  bool accumulate) {
  constexpr int G = 4;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= num_rows) return;
  int64_t base = i, stride = num_rows;
  if constexpr (Slice > 0) {
    base = (i / Slice) * Slice * row_length + i % Slice;
    stride = Slice;
  }
  const int* cp = column_index + base;
  const T* vp = value + base;
  T acc = T(0);
  for (int s0 = 0; s0 < row_length; s0 += G) {
    int col[G];
    T v[G];
    T xv[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const bool live = s0 + q < row_length;
      const int64_t at = static_cast<int64_t>(s0 + q) * stride;
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

// ell_rows over slot-major buffers (slice 0) or slices of `slice` rows
// (a multiple of R).
template <typename T, int R, int L>
__global__ void __launch_bounds__(kStudyThreads)
    layout_kernel(const int* __restrict__ column_index,
                  const T* __restrict__ value, int row_length,
                  int64_t num_rows, int64_t num_columns, int64_t slice,
                  const T* __restrict__ x, T* __restrict__ y) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kStudyThreads + threadIdx.x) * R;
  if (i >= num_rows) return;
  const int64_t base =
      slice ? (i / slice) * slice * row_length + i % slice : i;
  const int64_t stride = slice ? slice : num_rows;
  T acc[R];
  ell_rows<T, R, L>(column_index + base, value + base, row_length, stride,
                    num_columns, x, acc);
#pragma unroll
  for (int r = 0; r < R; ++r) y[i + r] = acc[r];
}

__device__ __forceinline__ uint32_t mix(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ull;
  k ^= k >> 33;
  return static_cast<uint32_t>(k);
}

// A thread a row, L slots in flight.
template <typename T, int L>
__global__ void __launch_bounds__(kStudyThreads)
    gather_kernel(const uint8_t* __restrict__ length, int64_t num_rows,
                  int64_t num_columns, const T* __restrict__ x,
                  T* __restrict__ y) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kStudyThreads + threadIdx.x;
  if (i >= num_rows) return;
  const int n = length[i];
  T xv[L];
#pragma unroll
  for (int s = 0; s < L; ++s) {
    const int64_t c =
        s < n ? mix(static_cast<uint64_t>(i) * L + s) %
                    static_cast<uint32_t>(num_columns)
              : 0;
    xv[s] = __ldg(x + c);
  }
  T acc = T(0);
#pragma unroll
  for (int s = 0; s < L; ++s) acc += xv[s];
  y[i] = acc;
}

// Blocks [0, lr.blocks()) sum the COO part's long rows (their writer
// adds the row's ELL sum first); thread t of the later blocks takes rows
// R t .. R t + R - 1.
template <typename T, int R, int L>
__global__ void __launch_bounds__(kCsrThreads)
    hybrid_kernel(const int* __restrict__ ell_index,
                  const T* __restrict__ ell_value, int row_length,
                  const int* __restrict__ row_ptr,
                  const int* __restrict__ coo_index,
                  const T* __restrict__ coo_value, int64_t num_rows,
                  int64_t num_columns, LongRows lr, const T* __restrict__ x,
                  T* __restrict__ y) {
  int64_t b = blockIdx.x;
  if (b < lr.blocks()) {
    constexpr int G = 4;
    const auto load_x = [&](int64_t c, bool ok, T(&xv)[1]) {
      xv[0] = ok ? __ldg(x + c) : T(0);
    };
    long_row<T, 1>(
        row_ptr, lr, b,
        [&](int64_t e, int64_t end, int S, T(&acc)[1]) {
          lane_sums<T, 1, G>(coo_index, coo_value, e, end, S, num_columns,
                             load_x, acc);
        },
        [&](int64_t i, const T(&s)[1]) {
          T ell[1];
          ell_rows<T, 1, 0>(ell_index + i, ell_value + i, row_length,
                            num_rows, num_columns, x, ell);
          y[i] = ell[0] + s[0];
        });
    return;
  }
  b -= lr.blocks();
  const int64_t i = (b * kCsrThreads + threadIdx.x) * R;
  if (i >= num_rows) return;
  T acc[R];
  ell_rows<T, R, L>(ell_index + i, ell_value + i, row_length, num_rows,
                    num_columns, x, acc);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int start = row_ptr[i + r];
    const int end = row_ptr[i + r + 1];
    if (end - start > lr.max_short) continue;   // a long row's block
    if (start == end) {
      y[i + r] = acc[r];
      continue;
    }
    T coo = T(0);
    for (int j = start; j < end; ++j) {
      const int c = coo_index[j];
      if (static_cast<unsigned>(c) < static_cast<uint64_t>(num_columns))
        coo += coo_value[j] * __ldg(x + c);
    }
    y[i + r] = acc[r] + coo;
  }
}

}  // namespace
}  // namespace spmv_tpu_torch

using namespace spmv_tpu_torch;

// The kernel at R rows a thread: dtype as ell_spmv_launch's, R of 1, 2
// or 4 with R values at most 16 bytes, num_rows a multiple of R and both
// buffers aligned to R values.
extern "C" int ell_study_rows_launch(int dtype, const void* column_index,
                                     const void* value, int row_length,
                                     int slots, int rows_per_thread,
                                     long long num_rows,
                                     long long num_columns, const void* x,
                                     void* y, void* stream) {
  const int R = rows_per_thread;
  const int size = dtype == kFloat64 ? 8 : 4;
  if (!(R == 1 || R == 2 || R == 4) || R * size > 16 || num_rows % R ||
      reinterpret_cast<uintptr_t>(column_index) % (4 * R) ||
      reinterpret_cast<uintptr_t>(value) % (R * size) ||
      (slots != 0 && slots != row_length) || slots > kMaxSlots)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto t, auto r) {
    using T = decltype(t);
    return launch_rows<T, decltype(r)::value>(column_index, value,
                                              row_length, slots, num_rows,
                                              num_columns, x, y, false, s);
  };
  if (dtype == kFloat64)
    return R == 1 ? go(double(), std::integral_constant<int, 1>())
                  : go(double(), std::integral_constant<int, 2>());
  if (R == 1) return go(float(), std::integral_constant<int, 1>());
  if (R == 2) return go(float(), std::integral_constant<int, 2>());
  return go(float(), std::integral_constant<int, 4>());
}

// float32: the kernel before the redesign, slice 0 or 32.
extern "C" int ell_study_before_launch(const void* column_index,
                                       const void* value, int row_length,
                                       long long num_rows,
                                       long long num_columns, int slice,
                                       const void* x, void* y,
                                       void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((num_rows + kStudyThreads - 1) / kStudyThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto kernel) {
    kernel<<<blocks, kStudyThreads, 0, s>>>(
        static_cast<const int*>(column_index),
        static_cast<const float*>(value), row_length, num_rows, num_columns,
        static_cast<const float*>(x), static_cast<float*>(y), false);
    return cudaGetLastError();
  };
  if (slice == 0) return go(before_kernel<float, 0>);
  if (slice == 32) return go(before_kernel<float, 32>);
  return cudaErrorInvalidValue;
}

// float32: ell_rows at R rows a thread (1, 2 or 4) over slot-major
// buffers (slice 0) or slices of `slice` rows.
extern "C" int ell_study_layout_launch(const void* column_index,
                                       const void* value, int row_length,
                                       int slots, int rows_per_thread,
                                       long long num_rows,
                                       long long num_columns,
                                       long long slice, const void* x,
                                       void* y, void* stream) {
  const int R = rows_per_thread;
  if (num_rows % R != 0 || (slice && slice % R != 0) ||
      (slots != 0 && slots != row_length))
    return cudaErrorInvalidValue;
  const int64_t per = static_cast<int64_t>(kStudyThreads) * R;
  const unsigned blocks = static_cast<unsigned>((num_rows + per - 1) / per);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto r, auto l) {
    layout_kernel<float, decltype(r)::value, decltype(l)::value>
        <<<blocks, kStudyThreads, 0, s>>>(
            static_cast<const int*>(column_index),
            static_cast<const float*>(value), row_length, num_rows,
            num_columns, slice, static_cast<const float*>(x),
            static_cast<float*>(y));
    return cudaGetLastError();
  };
  return by_slots(slots, [&](auto l) {
    if (R == 1) return go(std::integral_constant<int, 1>(), l);
    if (R == 2) return go(std::integral_constant<int, 2>(), l);
    return go(std::integral_constant<int, 4>(), l);
  });
}

// float32, slots 5 or 6 (the study's shapes).
extern "C" int ell_study_gather_launch(const void* length, int slots,
                                       long long num_rows,
                                       long long num_columns, const void* x,
                                       void* y, void* stream) {
  const unsigned blocks =
      static_cast<unsigned>((num_rows + kStudyThreads - 1) / kStudyThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto l) {
    gather_kernel<float, decltype(l)::value><<<blocks, kStudyThreads, 0, s>>>(
        static_cast<const uint8_t*>(length), num_rows, num_columns,
        static_cast<const float*>(x), static_cast<float*>(y));
    return cudaGetLastError();
  };
  if (slots == 5) return go(std::integral_constant<int, 5>());
  if (slots == 6) return go(std::integral_constant<int, 6>());
  return cudaErrorInvalidValue;
}

// float32; the COO part's arrays and long rows as csr_spmv_launch takes
// them (long_rows not null).
extern "C" int ell_study_hybrid_launch(
    const void* ell_index, const void* ell_value, int row_length, int slots,
    int rows_per_thread, const void* row_ptr, const void* coo_index,
    const void* coo_value, long long num_rows, long long num_columns,
    const void* long_rows, long long num_long, long long num_block,
    int max_short, const void* x, void* y, void* stream) {
  const int R = rows_per_thread;
  if (num_rows % R != 0 || long_rows == nullptr ||
      (slots != 0 && slots != row_length))
    return cudaErrorInvalidValue;
  const LongRows lr = {static_cast<const int*>(long_rows), num_long,
                       num_block, max_short};
  const int64_t per = static_cast<int64_t>(kCsrThreads) * R;
  const unsigned blocks =
      static_cast<unsigned>(lr.blocks() + (num_rows + per - 1) / per);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto r, auto l) {
    hybrid_kernel<float, decltype(r)::value, decltype(l)::value>
        <<<blocks, kCsrThreads, 0, s>>>(
            static_cast<const int*>(ell_index),
            static_cast<const float*>(ell_value), row_length,
            static_cast<const int*>(row_ptr),
            static_cast<const int*>(coo_index),
            static_cast<const float*>(coo_value), num_rows, num_columns, lr,
            static_cast<const float*>(x), static_cast<float*>(y));
    return cudaGetLastError();
  };
  return by_slots(slots, [&](auto l) {
    if (R == 1) return go(std::integral_constant<int, 1>(), l);
    if (R == 2) return go(std::integral_constant<int, 2>(), l);
    return go(std::integral_constant<int, 4>(), l);
  });
}

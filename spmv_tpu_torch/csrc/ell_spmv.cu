// ELL SpMV: y (+)= A x over slot-major column_index / value, both
// (row_length, num_rows): slot s of row i at [s * num_rows + i].
//
// Not a TPU kernel: the JAX package sums ELL in XLA (_ell_padded,
// spmv_tpu/ops/spmv.py:52, a dense gather and a row sum).  It is written
// by hand so that the ELL format, and the ELL part of the hybrid format,
// runs a fixed-order kernel on the card: each row's slots 0..L-1 are
// added in order by one thread, with no atomics, so two runs give
// bitwise equal y.  Padded slots are inert (value 0 at an in-bounds
// column) and are read like any other, as JAX reads them.
//
// What bounds it on an H100: bytes (the index and value streams, read
// once each, the x gather and y).  What the design does about it:
// - Two trips to memory a thread: every slot's index and value loads are
//   issued, then every slot's x gather, then the adds in slot order.
//   The row length is a template argument up to kMaxSlots (5 at a 2-D
//   stencil, 6 at the hybrid's ELL part; ell_spmv_plan, ops/_launch.py
//   picks it), so every slot is in flight at once; a longer row is
//   walked kMaxSlots slots a round.  At poisson2d(4096²) this streams at
//   the card's triad rate (PERF.md).
// - One row a thread.  ell_rows also sums R consecutive rows with one 8-
//   or 16-byte load of each slot's R indices and R values (the study of
//   profile/ell_study.cu launches it so): on the H100 that tied at the
//   stencil and lost 2-4% at the hybrid's gathers (PERF.md), so the
//   kernel takes R = 1.
// - Slot-major storage: a warp's 32 rows read one contiguous run of each
//   slot (128 bytes of indices), through the streaming path (__ldcs:
//   read once, evict first); x through the read-only path (__ldg).
// Each row keeps the earlier design's arithmetic: its sum starts at 0 and
// adds v * x (one fused multiply-add) slot by slot, so y, and the ELL
// SpMM's columns (ell_spmm.cu), keep their bits.  A column outside
// [0, num_columns) is skipped (the host never builds one).  Under
// accumulate y[i] + sum is written, else the sum.  y must not overlap x.
//
// The traffic-isolation variants (--traffic-split; the JAX package's
// _ell_regular / _ell_irregular, spmv_tpu/ops/traffic.py:83, :87, in
// XLA) are modes of this kernel (Mode, a TrafficMode of dia_common.cuh):
// the same template row length, rows to threads and slot order, with one
// stream left out.  kRegular sums each row's slot values and loads no
// index and no x; kIrregular sums x at each row's slot indices (0 outside
// [0, num_columns)) and loads no value.

#include <type_traits>

#include "dia_common.cuh"

// Threads a block and the blocks an SM the register budget is set for
// (__launch_bounds__): the study's sweep builds others (PERF.md).
#ifndef ELL_SPMV_THREADS
#define ELL_SPMV_THREADS 256
#endif
#ifndef ELL_SPMV_MIN_BLOCKS
#define ELL_SPMV_MIN_BLOCKS 1
#endif

namespace spmv_tpu_torch {
namespace {

constexpr int kThreads = ELL_SPMV_THREADS;
constexpr int kMaxSlots = 8;   // longer rows: rounds of kMaxSlots slots

// R consecutive values from p (aligned to R values) through the
// streaming path, in one load.
template <typename T, int R>
__device__ __forceinline__ void stream_load(const T* p, T (&o)[R]) {
  if constexpr (R == 1) {
    o[0] = __ldcs(p);
  } else if constexpr (R == 2) {
    using V = typename std::conditional<
        std::is_same<T, int>::value, int2,
        typename std::conditional<std::is_same<T, float>::value, float2,
                                  double2>::type>::type;
    const V v = __ldcs(reinterpret_cast<const V*>(p));
    o[0] = v.x;
    o[1] = v.y;
  } else {
    static_assert(R == 4 && sizeof(T) == 4, "16-byte loads at most");
    using V = typename std::conditional<std::is_same<T, int>::value, int4,
                                        float4>::type;
    const V v = __ldcs(reinterpret_cast<const V*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
}

// The sums of R consecutive rows whose slot s lies at cp / vp + s *
// stride (L slots; L = 0: row_length slots, kMaxSlots a round).  Every
// slot of a round is loaded, then gathered, then added in slot order.
// Mode kRegular loads and adds the values alone, kIrregular the x
// gathers alone.
template <typename T, int R, int L, int Mode = kFull>
__device__ __forceinline__ void ell_rows(const int* __restrict__ cp,
                                         const T* __restrict__ vp,
                                         int row_length, int64_t stride,
                                         int64_t num_columns,
                                         const T* __restrict__ x,
                                         T (&acc)[R]) {
  constexpr int G = L > 0 ? L : kMaxSlots;
  const int len = L > 0 ? L : row_length;
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = T(0);
  for (int s0 = 0; s0 < len; s0 += G) {
    int col[G][R];
    T v[G][R];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (L > 0 || s0 + q < len) {
        const int64_t at = static_cast<int64_t>(s0 + q) * stride;
        if constexpr (Mode != kRegular) stream_load<int, R>(cp + at, col[q]);
        if constexpr (Mode != kIrregular) stream_load<T, R>(vp + at, v[q]);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          col[q][r] = -1;
          v[q][r] = T(0);
        }
      }
    }
    if constexpr (Mode == kRegular) {
#pragma unroll
      for (int q = 0; q < G; ++q) {
        if (L > 0 || s0 + q < len) {
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] += v[q][r];
        }
      }
      continue;
    }
    T xv[G][R];
#pragma unroll
    for (int q = 0; q < G; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool ok = static_cast<unsigned>(col[q][r]) <
                        static_cast<uint64_t>(num_columns);
        xv[q][r] = ok ? __ldg(x + col[q][r]) : T(0);
      }
    }
#pragma unroll
    for (int q = 0; q < G; ++q) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (static_cast<unsigned>(col[q][r]) <
            static_cast<uint64_t>(num_columns)) {
          if constexpr (Mode == kFull)
            acc[r] += v[q][r] * xv[q][r];
          else
            acc[r] += xv[q][r];
        }
      }
    }
  }
}

// Thread t takes rows R t .. R t + R - 1 (num_rows a multiple of R and
// both buffers aligned to R values where R > 1; the port launches R = 1).
template <typename T, int R, int L, int Mode = kFull>
__global__ void __launch_bounds__(kThreads, ELL_SPMV_MIN_BLOCKS)
    ell_spmv_kernel(const int* __restrict__ column_index,
                    const T* __restrict__ value, int row_length,
                    int64_t num_rows, int64_t num_columns,
                    const T* __restrict__ x, T* __restrict__ y,
                    bool accumulate) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * R;
  if (i >= num_rows) return;
  T acc[R];
  ell_rows<T, R, L, Mode>(column_index + i, value + i, row_length, num_rows,
                          num_columns, x, acc);
#pragma unroll
  for (int r = 0; r < R; ++r)
    y[i + r] = accumulate ? y[i + r] + acc[r] : acc[r];
}

// launch(std::integral_constant<int, L>) for slots L in [1, kMaxSlots],
// or L = 0 (the rounds).
template <typename Launch>
cudaError_t by_slots(int slots, Launch launch) {
  switch (slots) {
#define ELL_SLOTS_CASE(n) \
  case n:                 \
    return launch(std::integral_constant<int, n>());
    ELL_SLOTS_CASE(0)
    ELL_SLOTS_CASE(1)
    ELL_SLOTS_CASE(2)
    ELL_SLOTS_CASE(3)
    ELL_SLOTS_CASE(4)
    ELL_SLOTS_CASE(5)
    ELL_SLOTS_CASE(6)
    ELL_SLOTS_CASE(7)
    ELL_SLOTS_CASE(8)
#undef ELL_SLOTS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int R, int Mode = kFull>
cudaError_t launch_rows(const void* column_index, const void* value,
                        int row_length, int slots, int64_t num_rows,
                        int64_t num_columns, const void* x, void* y,
                        bool accumulate, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * R;
  const int64_t blocks = (num_rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  return by_slots(slots, [&](auto l) {
    ell_spmv_kernel<T, R, decltype(l)::value, Mode>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            static_cast<const int*>(column_index),
            static_cast<const T*>(value), row_length, num_rows, num_columns,
            static_cast<const T*>(x), static_cast<T*>(y), accumulate);
    return cudaGetLastError();
  });
}

// slots is 0 (the rounds) or the row length, at most kMaxSlots.
template <typename T, int Mode>
cudaError_t launch(const void* column_index, const void* value,
                   int row_length, int slots, int64_t num_rows,
                   int64_t num_columns, const void* x, void* y,
                   bool accumulate, cudaStream_t stream) {
  if (row_length < 0 || (slots != 0 && slots != row_length) ||
      slots > kMaxSlots)
    return cudaErrorInvalidValue;
  if (num_rows == 0) return cudaSuccess;
  return launch_rows<T, 1, Mode>(column_index, value, row_length, slots,
                                 num_rows, num_columns, x, y, accumulate,
                                 stream);
}

template <int Mode>
int dispatch(int dtype, int device, const void* column_index,
             const void* value, int row_length, int slots, long long num_rows,
             long long num_columns, const void* x, void* y, int accumulate,
             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float, Mode>(column_index, value, row_length, slots,
                                 num_rows, num_columns, x, y,
                                 accumulate != 0, s);
    case kFloat64:
      return launch<double, Mode>(column_index, value, row_length, slots,
                                  num_rows, num_columns, x, y,
                                  accumulate != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launch (0 on success).  dtype is
// kFloat32 or kFloat64 (dia_common.cuh); column_index and value are
// (row_length, num_rows), slot-major; slots is ell_spmv_plan's
// (ops/_launch.py): the template row length, or 0 for the rounds.  mode
// is a TrafficMode (dia_common.cuh): kFull for the product, kRegular
// (reads no column_index and no x) or kIrregular (reads no value) for a
// traffic-isolation variant.
extern "C" int ell_spmv_launch(int dtype, int device,
                               const void* column_index, const void* value,
                               int row_length, int slots, long long num_rows,
                               long long num_columns, const void* x, void* y,
                               int accumulate, int mode, void* stream) {
  using namespace spmv_tpu_torch;
  return by_mode(mode, [&](auto m) {
    return dispatch<decltype(m)::value>(dtype, device, column_index, value,
                                        row_length, slots, num_rows,
                                        num_columns, x, y, accumulate,
                                        stream);
  });
}

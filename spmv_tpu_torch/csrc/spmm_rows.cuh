// Shared helpers of the SpMM kernels that hold a row's column sums in
// registers (wellcw_spmm.cu, csr_spmm.cu, ell_spmm.cu): a row of X or Y
// in 16-byte or scalar moves, a run of cells' columns and values, and the
// dispatch on the column-block width.
//
// X is (num_columns, k) and Y (num_rows, k), row-major; a thread holds
// the kb <= KB columns [c0, c0 + kb) of one row, KB a template width.
// Where X's rows and every column block are whole 16-byte runs and X and
// Y are 16-byte aligned (Vec), a row's values move 16 bytes at a time
// (two loads at kb = 8 in float32), else one value at a time.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace spmv_tpu_torch {

constexpr int kSpmmMaxKB = 8;        // columns a thread holds at most

// kb <= KB values of one row of X (Ro: through the read-only path) or Y,
// columns [0, kc) of xr (the rest 0): with Vec, 16-byte loads (xr and kc
// aligned to them), else one load a value.
template <typename T, int KB, bool Vec, bool Ro = true>
__device__ __forceinline__ void load_row(const T* xr, int kc, T (&v)[KB]) {
  if constexpr (Vec) {
    using V = typename std::conditional<sizeof(T) == 4, float4,
                                        double2>::type;
    constexpr int W = 16 / sizeof(T);
    static_assert(KB % W == 0, "a 16-byte load of X values");
#pragma unroll
    for (int j0 = 0; j0 < KB; j0 += W) {
      V q = {};
      if (j0 < kc) {
        const V* p = reinterpret_cast<const V*>(xr + j0);
        q = Ro ? __ldg(p) : *p;
      }
      v[j0] = q.x;
      v[j0 + 1] = q.y;
      if constexpr (W == 4) {
        v[j0 + 2] = q.z;
        v[j0 + 3] = q.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < KB; ++j)
      v[j] = j < kc ? (Ro ? __ldg(xr + j) : xr[j]) : T(0);
  }
}

// Columns [0, kc) of out to a row of Y (kc <= KB): with Vec, 16-byte
// stores (yr and kc aligned to them), else one store a value.
template <typename T, int KB, bool Vec>
__device__ __forceinline__ void store_row(T* yr, int kc, const T (&out)[KB]) {
  if constexpr (Vec) {
    constexpr int W = 16 / sizeof(T);
#pragma unroll
    for (int j0 = 0; j0 < KB; j0 += W) {
      if (j0 >= kc) continue;
      if constexpr (W == 4) {
        *reinterpret_cast<float4*>(yr + j0) =
            make_float4(out[j0], out[j0 + 1], out[j0 + 2], out[j0 + 3]);
      } else {
        *reinterpret_cast<double2*>(yr + j0) =
            make_double2(out[j0], out[j0 + 1]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      if (j < kc) yr[j] = out[j];
    }
  }
}

// G cells of a run from cell e on (cell i at cp[Stride i], vp[Stride i]):
// their columns and values, -1 and 0 past the run's length.
template <typename T, int G, int Stride>
__device__ __forceinline__ void load_cells(const int* cp, const T* vp,
                                           int e, int len, int (&col)[G],
                                           T (&v)[G]) {
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const bool live = e + i < len;
    col[i] = live ? __ldg(cp + (e + i) * Stride) : -1;
    v[i] = live ? __ldg(vp + (e + i) * Stride) : T(0);
  }
}

// Grid dimension of ceil(k / kb) column blocks, or 0 if it cannot be.
inline unsigned column_blocks(int k, int kb) {
  if (k <= 0 || kb <= 0) return 0;
  const int64_t n = (static_cast<int64_t>(k) + kb - 1) / kb;
  return n > 65535 ? 0 : static_cast<unsigned>(n);
}

// The template width KB of a column block of kb columns (0: too wide).
inline int template_width(int kb) {
  if (kb <= 1) return 1;
  if (kb <= 2) return 2;
  if (kb <= 4) return 4;
  return kb <= kSpmmMaxKB ? kSpmmMaxKB : 0;
}

// Calls launch(KB, Vec), KB the template width of kb and Vec whether
// X and Y move 16 bytes at a time: vector_x asks for it, and it needs
// rows and column blocks of whole 16-byte runs and aligned X and Y.
template <typename T, typename Launch>
cudaError_t by_width(int k, int kb, bool vector_x, const void* X,
                     const void* Y, Launch launch) {
  const auto vec = [&](auto w) -> cudaError_t {
    constexpr int KB = decltype(w)::value;
    if (!vector_x) return launch(w, std::false_type());
    if constexpr ((KB * sizeof(T)) % 16 == 0) {
      const bool ok = (k * sizeof(T)) % 16 == 0 &&
                      (kb * sizeof(T)) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(Y) % 16 == 0;
      if (ok) return launch(w, std::true_type());
    }
    return cudaErrorInvalidValue;
  };
  switch (template_width(kb)) {
    case 1:
      return vec(std::integral_constant<int, 1>());
    case 2:
      return vec(std::integral_constant<int, 2>());
    case 4:
      return vec(std::integral_constant<int, 4>());
    case kSpmmMaxKB:
      return vec(std::integral_constant<int, kSpmmMaxKB>());
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace spmv_tpu_torch

// Kernels K6a and K6b: WELL SpMM, Y = A X in one launch: the live slots
// of the WELL chunks, then the CSR spill, for X of shape (num_columns, k)
// and Y of shape (num_rows, k), both row-major.
//
// Replace the Pallas kernels of spmv_tpu/ops/pallas_kernels.py:
//   K6a well_spmm_kernel<T, false, ...>  <- _well_spmm_kernel (line 1079,
//                                           through well_spmm_padded,
//                                           :1256), whole x;
//   K6b well_spmm_kernel<T, true, ...>   <- _well_seg_spmm_kernel (line
//                                           1121, through
//                                           _well_seg_spmm_call, :1188),
//                                           segmented.
// The JAX package adds the spill after them in XLA (well_spmm, :1337).
//
// What they compute.  K5's sum (well_spmv.cu) for each column j of X:
// chunk c adds into row group_of_chunk[c] * 128 + lane
//
//   sum over the slots s of slot_mask[c]:
//       value[c, s, lane] * X[(ws[c, s] + seg) * 128 + loc[c, s, lane], j]
//
// with seg = segment_of_step[t] in segmented mode (K6b) and 0 in whole-x
// mode (K6a); then each row adds its spill entries.  A slot whose mask
// bit is clear is not read (an inf or NaN in X under it does not reach
// Y, where the Pallas kernels give 0 * inf = NaN: K5's stated
// deviation).  A column at or past num_columns reads 0.
//
// What bounds them on an H100: bytes.  Each live slot cell streams a
// value and an int32 index once for all the columns of a column block,
// and gathers kb contiguous X values (one 32-byte sector at kb = 8 in
// float32) for 2 kb flops; X and Y stream about once, because a slot's
// windows track its rows.  The bound is the live slots' value + index,
// the chunk metadata, the spill, X and Y over the device-memory rate.
//
// What the design does about it:
// - One CUDA block of 4 warps per (output block, column block of kb <=
//   8 columns): the value + index stream is read once from device memory
//   for kb columns, and only the slots whose mask bit is set, with the
//   streaming cache hint (__ldcs).  Above 8 columns the column blocks go
//   along grid dimension y and each reads the stream again.
// - Thread l owns lane l of the block's rows and holds the kb column
//   sums of one row in registers; the 4 warps take each chunk together,
//   one lane a thread, as K4a walks its rows.  A warp a chunk with 4
//   lanes a thread and 16-byte value and index loads (K5's walk) needed
//   about 200 registers a thread and was 1.5x slower at poisson2d(1024^2)
//   and (4096^2), k = 8 (PERF.md, section 6).
// - Occupancy moves K6 most, as it moved K4a: a thread issues one slot's
//   X loads at a time (8 values), and the float32 kernels keep to 64
//   registers, so that 8 blocks share an SM and poisson2d(1024^2)'s 1,024
//   blocks run in one wave.  At 80 registers (two slots' loads at a time,
//   no bound) they took 0.067 and 0.789 ms at poisson2d(1024^2) and
//   (4096^2), at 64 with two slots (spilling) 0.053 and 0.723, at 48
//   (spilling) 0.068 and 0.888, at 64 with one slot 0.047 and 0.661.
// - A cell's kb X values are one row of X: where X's rows, the column
//   block and the X and Y pointers are whole 16-byte runs, 16-byte loads
//   (two at kb = 8 in float32), else one load a value (the wrapper's
//   x_vector_loads).  Across a warp they are contiguous for a stencil.
// - The sums stay in registers while the block walks the chunks of one
//   tile row, and go to Y when the row changes.  Segmented mode packs
//   chunks (block, segment)-major, so a group may come back after
//   another: a warp remembers in shared memory which rows it has written
//   (one byte a row), and a thread reads such a row back from Y (its only
//   writer; the lines sit in the L2) before it adds more.  No shared tile
//   (out_rows x 128 x kb sums would be 128 KB at out_rows 32), so many
//   blocks share an SM.
// - The block stages the metadata of up to 128 chunks at a time in shared
//   memory, as K5 does: each chunk's mask byte, and for a chunk with live
//   slots the window row (window start + segment) of each live slot and
//   its tile row; the branches on them are uniform.
// - Then thread l adds lane l's spill entries ([spill_ptr[b * 128 + l],
//   spill_ptr[b * 128 + l + 1]), in the host's (tile row, column) order)
//   to its rows, each row read back from Y once, and writes zeros to the
//   rows no chunk reached and no entry has; it touches only its own rows,
//   so no barrier.  An output block that no step visits is written all
//   the same.
// - Every sum runs in a fixed order, with no atomics: per row the live
//   slots in slot order into a strip (fused multiply-adds), the strips in
//   storage order into the row, then the spill entries in order, the
//   lane's first product rounded before it is added, as K5 adds it.  So
//   two launches give bitwise equal Y, and column j sums as K5 does on
//   X[:, j].  Sums are kept in the storage type (float or double).
// - Not carried over: the TPU's (rows, k, 128) X layout, the lane
//   shuffle, the segment DMA and the VMEM limits (8 MB of whole x, 12 MB
//   of segment): K6a takes any X.
//
// Output: every row < num_rows of the block's columns is written; rows
// past it never are, so Y can be an exactly (num_rows, k) buffer.  Y must
// not overlap X.

#include <cstdint>
#include <type_traits>

#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kSlots = 8;
constexpr int kLanes = 128;
constexpr int kChunk = kSlots * kLanes;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // = kLanes
static_assert(kThreads == kLanes, "thread l adds lane l's spill");
constexpr int kKB = 8;                 // widest column block
// chunks whose metadata a block stages at once: one a thread
constexpr int kStage = kThreads;
// the staged metadata: window rows, tile rows and mask bytes
constexpr size_t kStageBytes =
    kStage * (kSlots * sizeof(int) + sizeof(int) + 1);
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on sm_90
// blocks an SM of the float32, one-lane kernels: 64 registers a thread
constexpr int kFloatBlocks = 8;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

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

// Columns [0, kc) of one row of Y, 16-byte stores with Vec.
template <typename T, int KB, bool Vec>
__device__ __forceinline__ void store_row(T* yr, int kc, const T (&v)[KB]) {
  if constexpr (Vec) {
    constexpr int W = 16 / sizeof(T);
#pragma unroll
    for (int j0 = 0; j0 < KB; j0 += W) {
      if (j0 >= kc) continue;
      if constexpr (W == 4) {
        *reinterpret_cast<float4*>(yr + j0) =
            make_float4(v[j0], v[j0 + 1], v[j0 + 2], v[j0 + 3]);
      } else {
        *reinterpret_cast<double2*>(yr + j0) = make_double2(v[j0], v[j0 + 1]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < KB; ++j) {
      if (j < kc) yr[j] = v[j];
    }
  }
}

// Grid (num_out_blocks, ceil(ncols / kb)): block (b, y) is output block b
// (groups [b * out_rows, (b + 1) * out_rows), its chunks [step_ptr[b] *
// K, step_ptr[b + 1] * K)) and columns y * kb + [0, kc), kc <= kb <= KB;
// thread l owns lane l of every tile row.  Dynamic shared memory:
// kStageBytes + 4 * out_rows.
template <typename T, bool Segmented, int KB, bool Vec>
__global__ void __launch_bounds__(kThreads,
                                  sizeof(T) == 4 ? kFloatBlocks : 1)
    well_spmm_kernel(const T* __restrict__ value,
                     const int* __restrict__ local_index,
                     const int* __restrict__ window_start,
                     const int* __restrict__ group_of_chunk,
                     const int* __restrict__ segment_of_step,
                     const int* __restrict__ step_ptr,
                     const uint8_t* __restrict__ slot_mask,
                     const int* __restrict__ spill_ptr,
                     const int* __restrict__ spill_row,
                     const int* __restrict__ spill_col,
                     const T* __restrict__ spill_value, int k, int out_rows,
                     int64_t num_rows, int64_t num_columns, int ncols,
                     int kb, const T* __restrict__ X, T* __restrict__ Y) {
  // slots whose X loads are issued together: 8 values a thread
  constexpr int G = 8 / KB;
  extern __shared__ __align__(16) unsigned char well_spmm_smem[];
  int* s_window = reinterpret_cast<int*>(well_spmm_smem);  // [kStage][8]
  int* s_row = s_window + kStage * kSlots;                  // [kStage]
  uint8_t* s_mask = reinterpret_cast<uint8_t*>(s_row + kStage);
  // [kWarps][out_rows]: whether the warp has written its lanes of a row
  uint8_t* written = s_mask + kStage + (threadIdx.x / 32) * out_rows;
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const int c0 = blockIdx.y * kb;
  const int kc = min(kb, ncols - c0);
  const T* Xc = X + c0;
  T* Yc = Y + c0;
  const int64_t row0 = b * out_rows * kLanes + tid;  // tile row 0's
  // lane tid's spill run, read first so that its latency hides under
  // the chunks
  int e = 0, e_end = 0;
  if (spill_ptr != nullptr) {
    e = __ldg(spill_ptr + b * kLanes + tid);
    e_end = __ldg(spill_ptr + b * kLanes + tid + 1);
  }
  for (int r = tid % 32; r < out_rows; r += 32) written[r] = 0;
  __syncwarp();
  T acc[KB];
  int cur = -1;  // the tile row whose sums acc holds
  const int64_t c_end = static_cast<int64_t>(step_ptr[b + 1]) * k;
  for (int64_t cs = static_cast<int64_t>(step_ptr[b]) * k; cs < c_end;
       cs += kStage) {
    const int n = static_cast<int>(
        c_end - cs < kStage ? c_end - cs : static_cast<int64_t>(kStage));
    __syncthreads();  // every warp is done with the previous stage
    if (tid < n) {
      const int64_t c = cs + tid;
      const unsigned m = slot_mask[c];
      s_mask[tid] = static_cast<uint8_t>(m);
      if (m != 0) {
        const int64_t t = c / k;
        const int kk = static_cast<int>(c - t * k);
        const int seg = Segmented ? segment_of_step[t] : 0;
        const int* ws = window_start + t * kSlots * k + kk;
#pragma unroll
        for (int s = 0; s < kSlots; ++s)
          s_window[tid * kSlots + s] = (m & (1u << s)) ? ws[s * k] + seg : 0;
        s_row[tid] = group_of_chunk[c] % out_rows;
      }
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const unsigned m = s_mask[j];
      if (m == 0) continue;  // uniform: inert padding costs its byte
      const int64_t base = (cs + j) * kChunk + tid;
      T val[kSlots];
      int loc[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (m & (1u << s)) {
          val[s] = __ldcs(value + base + s * kLanes);
          loc[s] = __ldcs(local_index + base + s * kLanes);
        }
      }
      const int* wrow = s_window + j * kSlots;
      T strip[KB];
#pragma unroll
      for (int jj = 0; jj < KB; ++jj) strip[jj] = T(0);
#pragma unroll
      for (int s0 = 0; s0 < kSlots; s0 += G) {
        T xv[G][KB];
#pragma unroll
        for (int s = 0; s < G; ++s) {
          if (!(m & (1u << (s0 + s)))) continue;
          const int64_t col =
              static_cast<int64_t>(wrow[s0 + s]) * kLanes + loc[s0 + s];
          const bool ok = static_cast<uint64_t>(col) <
                          static_cast<uint64_t>(num_columns);
          load_row<T, KB, Vec>(Xc + (ok ? col : 0) * ncols, ok ? kc : 0,
                               xv[s]);
        }
#pragma unroll
        for (int s = 0; s < G; ++s) {
          if (!(m & (1u << (s0 + s)))) continue;
#pragma unroll
          for (int jj = 0; jj < KB; ++jj)
            strip[jj] = fma_rn(val[s0 + s], xv[s][jj], strip[jj]);
        }
      }
      const int r = s_row[j];
      if (r != cur) {  // uniform
        if (cur >= 0 && row0 + cur * kLanes < num_rows)
          store_row<T, KB, Vec>(Yc + (row0 + cur * kLanes) * ncols, kc, acc);
        const int64_t row = row0 + r * kLanes;
        const bool again = written[r] != 0;
        __syncwarp();
        written[r] = 1;  // every lane of the warp writes the same byte
        load_row<T, KB, Vec, false>(Yc + row * ncols,
                                    again && row < num_rows ? kc : 0, acc);
        cur = r;
      }
#pragma unroll
      for (int jj = 0; jj < KB; ++jj) acc[jj] += strip[jj];
    }
  }
  if (cur >= 0 && row0 + cur * kLanes < num_rows)
    store_row<T, KB, Vec>(Yc + (row0 + cur * kLanes) * ncols, kc, acc);
  // the spill: the thread's own rows and flags, so no barrier
  bool first = true;  // the lane's first spill product, as K5 adds it
  for (int r = 0; r < out_rows; ++r) {
    const int64_t row = row0 + static_cast<int64_t>(r) * kLanes;
    if (row >= num_rows) break;
    const bool again = written[r] != 0;
    const bool has = e < e_end && __ldg(spill_row + e) == r;
    if (again && !has) continue;
    T a[KB];
    load_row<T, KB, Vec, false>(Yc + row * ncols, again ? kc : 0, a);
    for (; e < e_end && __ldg(spill_row + e) == r; ++e) {
      const int col = __ldg(spill_col + e);
      const bool ok = static_cast<uint64_t>(static_cast<uint32_t>(col)) <
                      static_cast<uint64_t>(num_columns);
      T xv[KB];
      load_row<T, KB, Vec>(Xc + static_cast<int64_t>(ok ? col : 0) * ncols,
                           ok ? kc : 0, xv);
      const T v = __ldg(spill_value + e);
#pragma unroll
      for (int jj = 0; jj < KB; ++jj)
        a[jj] = first ? a[jj] + mul_rn(v, xv[jj]) : fma_rn(v, xv[jj], a[jj]);
      first = false;
    }
    store_row<T, KB, Vec>(Yc + row * ncols, kc, a);
  }
}

// Every argument of a K6 launch, passed on as it is.
struct SpmmArgs {
  const void* value;
  const void* local_index;
  const void* window_start;
  const void* group_of_chunk;
  const void* segment_of_step;
  const void* step_ptr;
  const void* slot_mask;
  const void* spill_ptr;
  const void* spill_row;
  const void* spill_col;
  const void* spill_value;
  int k, out_rows;
  int64_t num_out_blocks, num_rows, num_columns;
  int ncols, kb;
  const void* X;
  void* Y;
};

// Grid dimension of ceil(ncols / kb) column blocks, or 0 if it cannot be.
unsigned column_blocks(int ncols, int kb) {
  if (ncols <= 0 || kb <= 0 || kb > kKB) return 0;
  const int64_t n = (static_cast<int64_t>(ncols) + kb - 1) / kb;
  return n > 65535 ? 0 : static_cast<unsigned>(n);
}

// The template width KB of a column block of kb columns.
int template_width(int kb) {
  return kb <= 1 ? 1 : kb <= 2 ? 2 : kb <= 4 ? 4 : kKB;
}

template <typename T, bool Segmented, int KB, bool Vec>
cudaError_t launch_kb(const SpmmArgs& a, cudaStream_t stream) {
  const auto kernel = well_spmm_kernel<T, Segmented, KB, Vec>;
  const size_t smem = kStageBytes + static_cast<size_t>(kWarps) * a.out_rows;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(a.num_out_blocks),
                  column_blocks(a.ncols, a.kb));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.value), static_cast<const int*>(a.local_index),
      static_cast<const int*>(a.window_start),
      static_cast<const int*>(a.group_of_chunk),
      static_cast<const int*>(a.segment_of_step),
      static_cast<const int*>(a.step_ptr),
      static_cast<const uint8_t*>(a.slot_mask),
      static_cast<const int*>(a.spill_ptr),
      static_cast<const int*>(a.spill_row),
      static_cast<const int*>(a.spill_col),
      static_cast<const T*>(a.spill_value), a.k, a.out_rows, a.num_rows,
      a.num_columns, a.ncols, a.kb, static_cast<const T*>(a.X),
      static_cast<T*>(a.Y));
  return cudaGetLastError();
}

// 16-byte X and Y loads need 16-byte rows and column blocks and aligned
// X and Y; a width of fewer than 16 bytes takes them one at a time.
template <typename T, bool Segmented, int KB>
cudaError_t launch_vec(const SpmmArgs& a, bool vector_x,
                       cudaStream_t stream) {
  if (!vector_x) return launch_kb<T, Segmented, KB, false>(a, stream);
  if constexpr ((KB * sizeof(T)) % 16 == 0) {
    const bool ok = (a.ncols * sizeof(T)) % 16 == 0 &&
                    (a.kb * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.X) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.Y) % 16 == 0;
    if (ok) return launch_kb<T, Segmented, KB, true>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T, bool Segmented>
cudaError_t launch(const SpmmArgs& a, bool vector_x, cudaStream_t stream) {
  if (a.num_out_blocks == 0 || a.ncols == 0) return cudaSuccess;
  if (a.k < 1 || a.out_rows < 1 || a.num_out_blocks > 0x7fffffff ||
      column_blocks(a.ncols, a.kb) == 0 ||
      (a.spill_ptr != nullptr &&
       (a.spill_row == nullptr || a.spill_col == nullptr ||
        a.spill_value == nullptr)))
    return cudaErrorInvalidValue;
  switch (template_width(a.kb)) {
    case 1:
      return launch_vec<T, Segmented, 1>(a, vector_x, stream);
    case 2:
      return launch_vec<T, Segmented, 2>(a, vector_x, stream);
    case 4:
      return launch_vec<T, Segmented, 4>(a, vector_x, stream);
    default:
      return launch_vec<T, Segmented, kKB>(a, vector_x, stream);
  }
}

template <bool Segmented>
int dispatch(int dtype, int device, const SpmmArgs& a, int vector_x,
             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float, Segmented>(a, vector_x != 0, s);
    case kFloat64:
      return launch<double, Segmented>(a, vector_x != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace spmv_tpu_torch

// Each returns the cudaError_t of the launch (0 on success).  dtype is
// kFloat32 or kFloat64 (dia_common.cuh); every index array is int32 and
// slot_mask is uint8; k is the chunks per step, ncols the columns of X
// and Y, kb the column block (1..8), vector_x whether X and Y move 16
// bytes at a time (refused where they cannot).  segment_of_step is read
// only by K6b (well_seg_spmm_launch).
// The four spill arrays are all null where the matrix has no spill.

extern "C" int well_whole_spmm_launch(
    int dtype, int device, const void* value, const void* local_index,
    const void* window_start, const void* group_of_chunk,
    const void* step_ptr, const void* slot_mask, const void* spill_ptr,
    const void* spill_row, const void* spill_col, const void* spill_value,
    int k, int out_rows, long long num_out_blocks, long long num_rows,
    long long num_columns, int ncols, int kb, int vector_x, const void* X,
    void* Y, void* stream) {
  const spmv_tpu_torch::SpmmArgs a = {
      value, local_index, window_start, group_of_chunk, nullptr, step_ptr,
      slot_mask, spill_ptr, spill_row, spill_col, spill_value, k, out_rows,
      num_out_blocks, num_rows, num_columns, ncols, kb, X, Y};
  return spmv_tpu_torch::dispatch<false>(dtype, device, a, vector_x,
                                         stream);
}

extern "C" int well_seg_spmm_launch(
    int dtype, int device, const void* value, const void* local_index,
    const void* window_start, const void* group_of_chunk,
    const void* segment_of_step, const void* step_ptr, const void* slot_mask,
    const void* spill_ptr, const void* spill_row, const void* spill_col,
    const void* spill_value, int k, int out_rows, long long num_out_blocks,
    long long num_rows, long long num_columns, int ncols, int kb,
    int vector_x, const void* X, void* Y, void* stream) {
  const spmv_tpu_torch::SpmmArgs a = {
      value, local_index, window_start, group_of_chunk, segment_of_step,
      step_ptr, slot_mask, spill_ptr, spill_row, spill_col, spill_value, k,
      out_rows, num_out_blocks, num_rows, num_columns, ncols, kb, X, Y};
  return spmv_tpu_torch::dispatch<true>(dtype, device, a, vector_x,
                                        stream);
}

// Kernels K5a and K5b: WELL SpMV, y = A x in one launch: the live slots
// of the WELL chunks, then the CSR spill, added in lane order.
//
// Replace the Pallas kernels of spmv_tpu/ops/pallas_kernels.py:
//   K5a well_kernel<T, false>  <- _well_kernel (line 431, through
//                                 well_spmv_padded, :474), whole x;
//   K5b well_kernel<T, true>   <- _well_seg_kernel (line 557, through
//                                 _well_seg_call, :622), segmented.
// The JAX package adds the spill after them in XLA (well_spmv, :682).
//
// What they compute.  A chunk c is 8 slots x 128 lanes and adds into
// row group_of_chunk[c] * 128 + lane:
//
//   sum over the slots s of slot_mask[c]:
//       value[c, s, lane] * x[(ws[c, s] + seg) * 128 + loc[c, s, lane]]
//
// with ws[c, s] = window_start[t, s, kk] for chunk c = t * K + kk, seg =
// segment_of_step[t] in segmented mode (K5b) and 0 in whole-x mode (K5a).
// Bit s of slot_mask[c] is set iff slot s holds a nonzero value; a slot
// whose bit is clear is not read at all (so an inf or NaN in x under it
// does not reach y, where the Pallas kernels give 0 * inf = NaN: a
// stated deviation).  A column at or past num_columns reads 0, as the
// Pallas kernels' zero-padded x does.  Output block b is groups
// [b * out_rows, (b + 1) * out_rows), out_rows = 8 * blocks_per_out; its
// chunks are [step_ptr[b] * K, step_ptr[b + 1] * K), all in that range.
// Then lane l of block b adds its spill entries [spill_ptr[b * 128 + l],
// spill_ptr[b * 128 + l + 1]): value * x[column] into tile row
// spill_row, in the host's (tile row, column) order.
//
// What bounds them on an H100: bytes.  Each live slot cell streams a
// value and an int32 index (8 bytes in float32) for 2 flops and one x
// gather, and a slot's windows track its rows, so x and y stream about
// once (x gathers hit L2).  The bound is the live slots' value + index,
// the chunk metadata (a mask byte a chunk; a window start a live slot, a
// group a live chunk), the spill, x and y over the device-memory rate.
// A stencil fills 5 of a chunk's 8 slots: the other 3 are zeros in
// value and index, 37.5% of the full container's stream.
//
// What the design does about it:
// - One CUDA block of 4 warps per output block.  A warp takes a whole
//   chunk, each thread 4 neighbouring lanes, so each live slot's values
//   and indices are one 16-byte load a thread (a 512-byte load a warp in
//   float32), with the streaming cache hint (__ldcs: read once, evict
//   first, so x's lines stay in L2); all of a chunk's live loads are
//   issued before its x gathers.  One lane a thread (4-byte loads), with
//   or without chunk c + 1's loads issued before chunk c's gathers, was
//   slower at poisson2d(4096^2) (PERF.md, section 6).
// - Warp w owns the tile rows r with r % 4 == w and takes, in storage
//   order, the chunks that add into them, so two warps never touch one
//   tile element and no atomics are needed.
// - The block stages the metadata of up to 128 chunks at a time in
//   shared memory, one chunk a thread: its mask byte, and for a chunk
//   with live slots the window row (window start + segment) of each live
//   slot and its tile row.  The warps then read a chunk's mask from
//   shared memory, so the branches on it are uniform, and a chunk with
//   mask 0 (inert padding) costs its one byte.
// - A shared-memory tile of out_rows x 128 sums in the value type (16 KB
//   in float32 at blocks_per_out = 4), zeroed first; each chunk's strip
//   (its live slots summed in slot order) adds into tile row group %
//   out_rows.  After a barrier, thread l adds lane l's spill entries
//   into its column, in order.  Their pointers are read at the block's
//   start and the first entry's product before the barrier, so that the
//   fold's latency hides under the chunks.  Every tile element is summed by one thread in a
//   fixed order: two launches give bitwise equal y.
// - Then the tile is written out.  An output block that no step visits
//   still adds its spill entries and writes its rows (zeros where it has
//   none); the Pallas kernels never write it.
// - Not carried over: the TPU's window tables, the take_along_axis lane
//   shuffle and the segment DMA (make_async_copy).  On Hopper the gather
//   is a load, and the segment is an offset added to the column; the
//   reads go through L2.
// Segmented mode packs chunks (block, segment)-major, so a group may
// come back after another group of the block: the tile row is computed
// from each chunk's own group, never from the previous chunk's.
//
// Output: every row < num_rows is written; rows past it never are, so y
// can be an exactly num_rows buffer.  y must not overlap x.
//
// The traffic-isolation variants (--traffic-split; the JAX package's
// _well_regular / _well_irregular, spmv_tpu/ops/traffic.py:112, :119, in
// XLA) are modes of these kernels (Mode, a TrafficMode of
// dia_common.cuh): the same blocks, staging, slot_mask and step walk,
// tile and spill fold, with one stream left out.  kRegular sums the live
// slots' values and the spill's values, and reads no local_index, no
// window_start, no spill column and no x; kIrregular sums x at the live
// slots' columns and the spill's columns, and reads no value.  Both read
// the live slots only, as the product does, where the JAX variants
// gather every stored slot: the gather-only sum leaves out the x
// gathers of the all-zero slots (a stated deviation).

#include <cstdint>
#include <type_traits>

#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kWellSlots = 8;
constexpr int kWellLanes = 128;
constexpr int kWellChunk = kWellSlots * kWellLanes;
constexpr int kWarps = 4;                  // warps a block
constexpr int kThreads = 32 * kWarps;      // = kWellLanes
constexpr int kQuad = kWellLanes / 32;     // lanes a thread
static_assert(kThreads == kWellLanes, "thread l adds lane l's spill");
// chunks whose metadata a block stages at once: one a thread
constexpr int kStage = kThreads;
// the staged metadata: window rows, tile rows and mask bytes
constexpr size_t kStageBytes =
    kStage * (kWellSlots * sizeof(int) + sizeof(int) + 1);
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on sm_90

// 4 neighbouring lanes of one slot row, 16-byte aligned, read once.
__device__ __forceinline__ void load_quad(const float* p, float (&v)[kQuad]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load_quad(const double* p,
                                          double (&v)[kQuad]) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcs(reinterpret_cast<const double2*>(p + 2));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void load_quad(const int* p, int (&v)[kQuad]) {
  const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

template <typename T, bool Segmented, int Mode>
__global__ void __launch_bounds__(kThreads)
    well_kernel(const T* __restrict__ value,
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
                int64_t num_rows, int64_t num_columns,
                const T* __restrict__ x, T* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char well_smem[];
  T* tile = reinterpret_cast<T*>(well_smem);  // [out_rows][128]
  int* s_window = reinterpret_cast<int*>(tile + out_rows * kWellLanes);
  int* s_row = s_window + kStage * kWellSlots;  // [kStage]
  uint8_t* s_mask = reinterpret_cast<uint8_t*>(s_row + kStage);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int quad = (tid % 32) * kQuad;  // this thread's first lane
  const int64_t b = blockIdx.x;
  // lane tid's spill run, read first so that its latency hides under
  // the chunks
  int e = 0, e_end = 0;
  if (spill_ptr != nullptr) {
    e = __ldg(spill_ptr + b * kWellLanes + tid);
    e_end = __ldg(spill_ptr + b * kWellLanes + tid + 1);
  }
  for (int r = 0; r < out_rows; ++r) tile[r * kWellLanes + tid] = T(0);
  const int64_t c_end = static_cast<int64_t>(step_ptr[b + 1]) * k;
  for (int64_t c0 = static_cast<int64_t>(step_ptr[b]) * k; c0 < c_end;
       c0 += kStage) {
    const int n = static_cast<int>(
        c_end - c0 < kStage ? c_end - c0 : static_cast<int64_t>(kStage));
    __syncthreads();  // every warp is done with the previous stage
    if (tid < n) {
      const int64_t c = c0 + tid;
      const unsigned m = slot_mask[c];
      s_mask[tid] = static_cast<uint8_t>(m);
      if (m != 0) {
        if constexpr (Mode != kRegular) {
          const int64_t t = c / k;
          const int kk = static_cast<int>(c - t * k);
          const int seg = Segmented ? segment_of_step[t] : 0;
          const int* ws = window_start + t * kWellSlots * k + kk;
#pragma unroll
          for (int s = 0; s < kWellSlots; ++s)
            s_window[tid * kWellSlots + s] =
                (m & (1u << s)) ? ws[s * k] + seg : 0;
        }
        s_row[tid] = group_of_chunk[c] % out_rows;
      }
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const unsigned m = s_mask[j];
      if (m == 0 || s_row[j] % kWarps != warp) continue;  // warp-uniform
      const int64_t base = (c0 + j) * kWellChunk + quad;
      T val[kWellSlots][kQuad];
      int loc[kWellSlots][kQuad];
#pragma unroll
      for (int s = 0; s < kWellSlots; ++s) {
        if (m & (1u << s)) {
          if constexpr (Mode != kIrregular)
            load_quad(value + base + s * kWellLanes, val[s]);
          if constexpr (Mode != kRegular)
            load_quad(local_index + base + s * kWellLanes, loc[s]);
        }
      }
      const int* wrow = s_window + j * kWellSlots;
      T strip[kQuad] = {};
#pragma unroll
      for (int s = 0; s < kWellSlots; ++s) {
        if (m & (1u << s)) {
          if constexpr (Mode == kRegular) {
#pragma unroll
            for (int q = 0; q < kQuad; ++q) strip[q] += val[s][q];
            continue;
          }
          const int64_t w0 = static_cast<int64_t>(wrow[s]) * kWellLanes;
#pragma unroll
          for (int q = 0; q < kQuad; ++q) {
            const int64_t col = w0 + loc[s][q];
            const T xv = static_cast<uint64_t>(col) <
                                 static_cast<uint64_t>(num_columns)
                             ? __ldg(x + col)
                             : T(0);
            if constexpr (Mode == kFull)
              strip[q] += val[s][q] * xv;
            else
              strip[q] += xv;
          }
        }
      }
      T* trow = tile + s_row[j] * kWellLanes + quad;
#pragma unroll
      for (int q = 0; q < kQuad; ++q) trow[q] += strip[q];
    }
  }
  // the lane's first spill product, fetched before the barrier so that it
  // overlaps the other warps' chunks
  T first = T(0);
  int first_row = 0;
  if (e < e_end) {
    if constexpr (Mode == kFull) {
      const int col = __ldg(spill_col + e);
      first_row = __ldg(spill_row + e);
      first = __ldg(spill_value + e) *
              (static_cast<uint64_t>(static_cast<uint32_t>(col)) <
                       static_cast<uint64_t>(num_columns)
                   ? __ldg(x + col)
                   : T(0));
    } else if constexpr (Mode == kRegular) {
      first_row = __ldg(spill_row + e);
      first = __ldg(spill_value + e);
    } else {
      const int col = __ldg(spill_col + e);
      first_row = __ldg(spill_row + e);
      first = static_cast<uint64_t>(static_cast<uint32_t>(col)) <
                      static_cast<uint64_t>(num_columns)
                  ? __ldg(x + col)
                  : T(0);
    }
  }
  __syncthreads();  // the chunks' sums are in the tile
  if (e < e_end) tile[first_row * kWellLanes + tid] += first;
  for (++e; e < e_end; ++e) {
    if constexpr (Mode == kRegular) {
      tile[__ldg(spill_row + e) * kWellLanes + tid] += __ldg(spill_value + e);
    } else {
      const int col = __ldg(spill_col + e);
      const T xv = static_cast<uint64_t>(static_cast<uint32_t>(col)) <
                           static_cast<uint64_t>(num_columns)
                       ? __ldg(x + col)
                       : T(0);
      if constexpr (Mode == kFull)
        tile[__ldg(spill_row + e) * kWellLanes + tid] +=
            __ldg(spill_value + e) * xv;
      else
        tile[__ldg(spill_row + e) * kWellLanes + tid] += xv;
    }
  }
  for (int r = 0; r < out_rows; ++r) {
    const int64_t row = (b * out_rows + r) * kWellLanes + tid;
    if (row < num_rows) y[row] = tile[r * kWellLanes + tid];
  }
}

template <typename T, bool Segmented, int Mode>
cudaError_t launch(const void* value, const void* local_index,
                   const void* window_start, const void* group_of_chunk,
                   const void* segment_of_step, const void* step_ptr,
                   const void* slot_mask, const void* spill_ptr,
                   const void* spill_row, const void* spill_col,
                   const void* spill_value, int k, int out_rows,
                   int64_t num_out_blocks, int64_t num_rows,
                   int64_t num_columns, const void* x, void* y,
                   cudaStream_t stream) {
  if (num_out_blocks == 0) return cudaSuccess;
  if (k < 1 || out_rows < 1 || num_out_blocks > 0x7fffffff)
    return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(out_rows) * kWellLanes * sizeof(T) + kStageBytes;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        well_kernel<T, Segmented, Mode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  well_kernel<T, Segmented, Mode>
      <<<static_cast<unsigned>(num_out_blocks), kThreads, smem, stream>>>(
          static_cast<const T*>(value), static_cast<const int*>(local_index),
          static_cast<const int*>(window_start),
          static_cast<const int*>(group_of_chunk),
          static_cast<const int*>(segment_of_step),
          static_cast<const int*>(step_ptr),
          static_cast<const uint8_t*>(slot_mask),
          static_cast<const int*>(spill_ptr),
          static_cast<const int*>(spill_row),
          static_cast<const int*>(spill_col),
          static_cast<const T*>(spill_value), k, out_rows, num_rows,
          num_columns, static_cast<const T*>(x), static_cast<T*>(y));
  return cudaGetLastError();
}

template <bool Segmented, int Mode>
int dispatch(int dtype, int device, const void* value,
             const void* local_index, const void* window_start,
             const void* group_of_chunk, const void* segment_of_step,
             const void* step_ptr, const void* slot_mask,
             const void* spill_ptr, const void* spill_row,
             const void* spill_col, const void* spill_value, int k,
             int out_rows, long long num_out_blocks, long long num_rows,
             long long num_columns, const void* x, void* y, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return launch<float, Segmented, Mode>(
          value, local_index, window_start, group_of_chunk, segment_of_step,
          step_ptr, slot_mask, spill_ptr, spill_row, spill_col, spill_value,
          k, out_rows, num_out_blocks, num_rows, num_columns, x, y, s);
    case kFloat64:
      return launch<double, Segmented, Mode>(
          value, local_index, window_start, group_of_chunk, segment_of_step,
          step_ptr, slot_mask, spill_ptr, spill_row, spill_col, spill_value,
          k, out_rows, num_out_blocks, num_rows, num_columns, x, y, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace spmv_tpu_torch

// Each returns the cudaError_t of the launch (0 on success).  dtype is
// kFloat32 or kFloat64 (dia_common.cuh); every index array is int32 and
// slot_mask is uint8; value and local_index start on 16-byte boundaries.
// segment_of_step is read only by K5b (well_seg_launch).  The four spill
// arrays are all null where the matrix has no spill.  mode is a
// TrafficMode (dia_common.cuh): kFull for the product, kRegular (reads no
// local_index, window_start, segment_of_step, spill_col and no x) or
// kIrregular (reads no value and no spill_value) for a traffic-isolation
// variant.

extern "C" int well_whole_launch(
    int dtype, int device, const void* value, const void* local_index,
    const void* window_start, const void* group_of_chunk,
    const void* step_ptr, const void* slot_mask, const void* spill_ptr,
    const void* spill_row, const void* spill_col, const void* spill_value,
    int k, int out_rows, long long num_out_blocks, long long num_rows,
    long long num_columns, const void* x, void* y, int mode, void* stream) {
  using namespace spmv_tpu_torch;
  return by_mode(mode, [&](auto m) {
    return dispatch<false, decltype(m)::value>(
        dtype, device, value, local_index, window_start, group_of_chunk,
        nullptr, step_ptr, slot_mask, spill_ptr, spill_row, spill_col,
        spill_value, k, out_rows, num_out_blocks, num_rows, num_columns, x,
        y, stream);
  });
}

extern "C" int well_seg_launch(
    int dtype, int device, const void* value, const void* local_index,
    const void* window_start, const void* group_of_chunk,
    const void* segment_of_step, const void* step_ptr, const void* slot_mask,
    const void* spill_ptr, const void* spill_row, const void* spill_col,
    const void* spill_value, int k, int out_rows, long long num_out_blocks,
    long long num_rows, long long num_columns, const void* x, void* y,
    int mode, void* stream) {
  using namespace spmv_tpu_torch;
  return by_mode(mode, [&](auto m) {
    return dispatch<true, decltype(m)::value>(
        dtype, device, value, local_index, window_start, group_of_chunk,
        segment_of_step, step_ptr, slot_mask, spill_ptr, spill_row,
        spill_col, spill_value, k, out_rows, num_out_blocks, num_rows,
        num_columns, x, y, stream);
  });
}

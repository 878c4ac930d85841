// Kernels K4a, K4b and K4c: WELL-CW SpMM, Y (+)= A X for k right-hand
// sides over chunk-window chunks (see cw_common.cuh for the cell
// addressing).  X is (num_columns, k) and Y is (num_rows, k), both
// row-major, as for K2 and the JAX package's spmm.
//
// Replace the Pallas kernels of spmv_tpu/ops/pallas_kernels.py:
//   K4a cw_merged_spmm_kernel <- _cw_merged_spmm_kernel (line 1653), the
//                                merged level + stage-1 pool grid;
//   K4b cw_level_spmm_kernel  <- _cw_spmm_kernel (line 1875), a fallback
//                                level;
//   K4c cw_pool_spmm_kernel   <- _cw_pool_spmm_kernel (line 1920), a
//                                pooled level (fallback pool, tail pools).
// They compute what K3a-c (wellcw_spmv.cu) compute, for each column of X.
//
// What bounds them on an H100: bytes.  The value + index stream (8 bytes
// a cell in float32) is read once for all the columns of a column block;
// each cell then gathers kb contiguous X values (one 32-byte sector at
// kb = 8 in float32) and adds 2 kb flops.  X (33.6 MB at 1M columns and
// k = 8 in float32) still fits the 50 MB L2 beside the stream, so the
// time is the stream plus the X and Y traffic, and the latency of the
// dependent index -> X loads.  The TPU's per-RHS stride tables
// (_cw_tables3) are not built: X is read straight from memory.
//
// What this simple design does about it:
// - Columns go in blocks of kb (grid dimension y for K4b, z for K4a and
//   K4c); every column block re-reads its part's value + index stream,
//   so kb is as wide as registers and shared memory allow.  The wrapper
//   (ops/wellcw_kernels.py, column_block) picks kb and passes it to
//   every launch.  A level thread (K4b, and the level warps of K4a) keeps
//   kb <= kKB = 8 sums in registers.  The pool tiles hold rows x kb x 32
//   accumulators in dynamic shared memory, kb from a byte budget per
//   kernel and dtype; above 48 KB the launcher opts in with
//   cudaFuncSetAttribute.  Every k >= 1 is accepted.
// - Level chunks: one thread per (group, lane, column block) walks its
//   group's chunks in order; each chunk's 8 slots are summed per column
//   into a strip, then added to the column's sum, in the order K3a adds
//   them (cw_strip_cols), so column j of Y sums as the SpMV of X[:, j].
// - Pool cells: one warp per (output block, 32-lane slice, column block)
//   walks the block's pool chunks in order and adds into a shared tile
//   [rows][kb][32] whose column l32 only thread l32 touches (no bank
//   conflicts, barriers or atomics).  The X values of a group of slots
//   are all loaded before any is added (cw_pool_add), so their gather
//   latencies overlap as K3b's do; the column count of a block is a
//   template width KB in {1, 2, 4, 8} (kb <= KB, the rest predicated
//   off), so those loads unroll into registers.
// - K4a, one CUDA block per (64-group block, lane slice, column block):
//   warp 0 walks the pool chunks into the shared tile while warps 1-7 sum
//   the level groups in registers and write them to Y (y = level, or
//   y + level with accumulate); after __syncthreads() the block adds the
//   pool tile: y = (y_old + level) + pool.  Without accumulate that is
//   K3c's level + pool.  No level tile is kept, so the shared memory is
//   the pool tile alone.  Where a thread reads Y back (that add, and
//   K4c's accumulate), it loads a batch of rows before storing any
//   (store_tile_rows), so the loads' latencies overlap.
// Every sum runs in a fixed order, so two runs give bitwise equal Y.
// Sums are kept in the storage type (float or double).
//
// Output: the first launch of a product writes every row < num_rows
// (accumulate = 0); later launches add (accumulate = 1).  Rows past
// num_rows are never written, so Y can be an exactly (num_rows, k)
// buffer.  Y must not overlap X.

#include "cw_common.cuh"
#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kWarp = 32;
constexpr int kMergedRows = 64;      // groups per merged output block
constexpr int kMergedWarps = 8;
constexpr int kKB = 8;               // columns a level thread holds
constexpr int kLevelThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB, a block's most on sm_90

template <typename T>
__device__ __forceinline__ void store_cols(T* __restrict__ yr, const T* acc,
                                           int kc, bool accumulate) {
#pragma unroll
  for (int j = 0; j < kKB; ++j) {
    if (j < kc) yr[j] = accumulate ? yr[j] + acc[j] : acc[j];
  }
}

// Adds one pool chunk's 8 cells of lane l32 to the tile [rows][kb][32]:
// cell s goes to tile row rel[s] (skipped outside [0, rows)) and reads X
// at its column (0 past the end), columns [c0, c0 + kc), kc <= kb <= KB.
// The slots go in groups of G, each group's X loads issued before its
// adds, in slot order.
template <typename T, int KB, bool Merged>
__device__ __forceinline__ void cw_pool_add(
    T* tile, int kb, int rows, int l32, const int (&loc)[kCwSlots],
    const T (&val)[kCwSlots], const int (&rel)[kCwSlots], int anchor4,
    int d, const T* __restrict__ X, int64_t num_columns, int k, int c0,
    int kc) {
  constexpr int G = KB >= 8 ? 4 : kCwSlots;
#pragma unroll
  for (int s0 = 0; s0 < kCwSlots; s0 += G) {
    T xv[G][KB];
#pragma unroll
    for (int s = 0; s < G; ++s) {
      int w = loc[s0 + s] >> 7;
      if (Merged) w &= 8 * d - 1;
      const int64_t col = cw_column(anchor4, d, w, loc[s0 + s]);
      const bool ok = col < num_columns &&
          static_cast<unsigned>(rel[s0 + s]) < static_cast<unsigned>(rows);
      const T* xr = X + (ok ? col : 0) * k + c0;
#pragma unroll
      for (int j = 0; j < KB; ++j)
        xv[s][j] = (ok && j < kc) ? __ldg(xr + j) : T(0);
    }
#pragma unroll
    for (int s = 0; s < G; ++s) {
      if (static_cast<unsigned>(rel[s0 + s]) >= static_cast<unsigned>(rows))
        continue;
      T* tr = tile + static_cast<int64_t>(rel[s0 + s]) * kb * kWarp + l32;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (j < kc) tr[j * kWarp] += val[s0 + s] * xv[s][j];
      }
    }
  }
}

// Writes tile rows [0, n) of this thread to Y: row_of(i) is tile row i's
// Y row (skipped at num_rows and past), tile_of(i) its tile column; y =
// tile, or y + tile with accumulate, columns [c0, c0 + kc), kc <= KB.
// The Y values of R rows are loaded before any is stored, so their
// latencies overlap.
template <typename T, int KB, typename RowOf, typename TileOf>
__device__ __forceinline__ void store_tile_rows(
    T* __restrict__ Y, int64_t num_rows, int k, int c0, int kc, int n,
    bool accumulate, RowOf row_of, TileOf tile_of) {
  constexpr int R = KB >= 8 ? 4 : 8;
  for (int i0 = 0; i0 < n; i0 += R) {
    T yv[R][KB];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t row = row_of(i0 + i);
      const bool ok = accumulate && i0 + i < n && row < num_rows;
#pragma unroll
      for (int j = 0; j < KB; ++j)
        yv[i][j] = (ok && j < kc) ? Y[row * k + c0 + j] : T(0);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int64_t row = row_of(i0 + i);
      if (i0 + i >= n || row >= num_rows) continue;
      const T* tr = tile_of(i0 + i);
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (j < kc)
          Y[row * k + c0 + j] =
              accumulate ? yv[i][j] + tr[j * kWarp] : tr[j * kWarp];
      }
    }
  }
}

// K4b: grid (ceil(num_groups * 128 / 256), ceil(k / kb)); thread t of
// x is (group t / 128, lane t % 128), y is the column block of kb <= kKB
// columns.
template <typename T>
__global__ void __launch_bounds__(kLevelThreads)
    cw_level_spmm_kernel(const T* __restrict__ value,
                         const int* __restrict__ local_index,
                         const int* __restrict__ anchor4,
                         const int* __restrict__ group_ptr, int d,
                         int64_t num_groups, int64_t num_rows,
                         int64_t num_columns, int k, int kb,
                         const T* __restrict__ X, T* __restrict__ Y,
                         bool accumulate) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t g = t / kCwLanes;
  const int lane = static_cast<int>(t % kCwLanes);
  const int64_t row = t;
  if (g >= num_groups || row >= num_rows) return;
  const int c0 = blockIdx.y * kb;
  const int kc = min(kb, k - c0);
  T acc[kKB];
#pragma unroll
  for (int j = 0; j < kKB; ++j) acc[j] = T(0);
  const int end = group_ptr[g + 1];
  for (int c = group_ptr[g]; c < end; ++c) {
    T strip[kKB];
    cw_strip_cols<T, false, kKB>(value, local_index, __ldg(anchor4 + c), d,
                                 c, lane, X, num_columns, k, c0, kc, strip);
#pragma unroll
    for (int j = 0; j < kKB; ++j) acc[j] += strip[j];
  }
  store_cols(Y + row * k + c0, acc, kc, accumulate);
}

// K4c: grid (num_blocks, 4, ceil(k / kb)), one warp per block: output
// block b, lanes blockIdx.y * 32 + [0, 32), columns blockIdx.z * kb +
// [0, kb), kb <= KB.  Dynamic shared memory: out_rows * kb * 32 T.
template <typename T, int KB>
__global__ void __launch_bounds__(kWarp)
    cw_pool_spmm_kernel(const T* __restrict__ value,
                        const int* __restrict__ local_index,
                        const int* __restrict__ anchor4,
                        const int* __restrict__ rowmap,
                        const int* __restrict__ block_ptr, int d,
                        int out_rows, int64_t num_rows, int64_t num_columns,
                        int k, int kb, const T* __restrict__ X,
                        T* __restrict__ Y, bool accumulate) {
  extern __shared__ __align__(16) unsigned char cw_pool_spmm_smem[];
  T* tile = reinterpret_cast<T*>(cw_pool_spmm_smem);  // [out_rows][kb][32]
  const int l32 = threadIdx.x;
  const int lane = blockIdx.y * kWarp + l32;
  const int64_t b = blockIdx.x;
  const int c0 = blockIdx.z * kb;
  const int kc = min(kb, k - c0);
  const int64_t base_group = b * out_rows;
  for (int i = 0; i < out_rows * kb; ++i) tile[i * kWarp + l32] = T(0);
  const int end = block_ptr[b + 1];
  for (int c = block_ptr[b]; c < end; ++c) {
    const int a4 = __ldg(anchor4 + c);
    const int64_t base = static_cast<int64_t>(c) * kCwChunk + lane;
    int loc[kCwSlots], rel[kCwSlots];
    T val[kCwSlots];
#pragma unroll
    for (int s = 0; s < kCwSlots; ++s) {
      loc[s] = local_index[base + s * kCwLanes];
      val[s] = value[base + s * kCwLanes];
      rel[s] = static_cast<int>(rowmap[base + s * kCwLanes] - base_group);
    }
    cw_pool_add<T, KB, false>(tile, kb, out_rows, l32, loc, val, rel, a4, d,
                              X, num_columns, k, c0, kc);
  }
  store_tile_rows<T, KB>(
      Y, num_rows, k, c0, kc, out_rows, accumulate,
      [&](int r) { return (base_group + r) * kCwLanes + lane; },
      [&](int r) { return tile + static_cast<int64_t>(r) * kb * kWarp + l32; });
}

// K4a: grid (num_blocks, 4, ceil(k / kb)), 8 warps per block: 64-group
// block b, lanes blockIdx.y * 32 + [0, 32), columns blockIdx.z * kb +
// [0, kb), kb <= KB <= kKB.  Chunk kk of block b is b * kl + kk: kk <
// 64 * cap are level chunks (group kk / cap), the rest pool chunks.
// Dynamic shared memory: 64 * kb * 32 T when the grid has pool chunks.
template <typename T, int KB>
__global__ void __launch_bounds__(kMergedWarps * kWarp)
    cw_merged_spmm_kernel(const T* __restrict__ value,
                          const int* __restrict__ local_index,
                          const int* __restrict__ anchor4, int d, int cap,
                          int pool_per_block, int64_t num_rows,
                          int64_t num_columns, int k, int kb,
                          const T* __restrict__ X, T* __restrict__ Y,
                          bool accumulate) {
  extern __shared__ __align__(16) unsigned char cw_merged_spmm_smem[];
  T* tile = reinterpret_cast<T*>(cw_merged_spmm_smem);  // [64][kb][32]
  const int l32 = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = blockIdx.y * kWarp + l32;
  const int64_t b = blockIdx.x;
  const int c0 = blockIdx.z * kb;
  const int kc = min(kb, k - c0);
  const int lvl_per = kMergedRows * cap;
  const int64_t first = b * (lvl_per + pool_per_block);
  const bool has_pool = pool_per_block > 0;
  if (has_pool && warp == 0) {
    for (int i = 0; i < kMergedRows * kb; ++i) tile[i * kWarp + l32] = T(0);
    for (int q = 0; q < pool_per_block; ++q) {
      const int64_t c = first + lvl_per + q;
      const int a4 = __ldg(anchor4 + c);
      const int64_t base = c * kCwChunk + lane;
      int loc[kCwSlots], rel[kCwSlots];
      T val[kCwSlots];
#pragma unroll
      for (int s = 0; s < kCwSlots; ++s) {
        loc[s] = local_index[base + s * kCwLanes];
        val[s] = value[base + s * kCwLanes];
        rel[s] = loc[s] >> 14;
      }
      cw_pool_add<T, KB, true>(tile, kb, kMergedRows, l32, loc, val, rel,
                               a4, d, X, num_columns, k, c0, kc);
    }
  } else {
    const int w0 = has_pool ? 1 : 0;
    for (int g = warp - w0; g < kMergedRows; g += kMergedWarps - w0) {
      T acc[kKB];
#pragma unroll
      for (int j = 0; j < kKB; ++j) acc[j] = T(0);
      for (int q = 0; q < cap; ++q) {
        const int64_t c = first + static_cast<int64_t>(g) * cap + q;
        T strip[kKB];
        cw_strip_cols<T, true, kKB>(value, local_index, __ldg(anchor4 + c),
                                    d, c, lane, X, num_columns, k, c0, kc,
                                    strip);
#pragma unroll
        for (int j = 0; j < kKB; ++j) acc[j] += strip[j];
      }
      const int64_t row = (b * kMergedRows + g) * kCwLanes + lane;
      if (row < num_rows) store_cols(Y + row * k + c0, acc, kc, accumulate);
    }
  }
  if (!has_pool) return;
  __syncthreads();     // the level sums are in Y, the pool sums in tile
  // warp w adds the pool sums of groups w, w + 8, ..., w + 56
  store_tile_rows<T, KB>(
      Y, num_rows, k, c0, kc, kMergedRows / kMergedWarps, true,
      [&](int i) {
        return (b * kMergedRows + warp + i * kMergedWarps) * kCwLanes + lane;
      },
      [&](int i) { return tile + (warp + i * kMergedWarps) * kb * kWarp + l32; });
}

// Grid dimension of ceil(k / kb) column blocks, or 0 if it cannot be.
unsigned column_blocks(int k, int kb) {
  if (k <= 0 || kb <= 0) return 0;
  const int64_t n = (static_cast<int64_t>(k) + kb - 1) / kb;
  return n > 65535 ? 0 : static_cast<unsigned>(n);
}

// The template width KB of a column block of kb columns (0: too wide).
int template_width(int kb) {
  return kb <= 1 ? 1 : kb <= 2 ? 2 : kb <= 4 ? 4 : kb <= kKB ? kKB : 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t level(const void* value, const void* local_index,
                  const void* anchor4, const void* group_ptr, int d,
                  int64_t num_groups, int64_t num_rows, int64_t num_columns,
                  int k, int kb, const void* X, void* Y, bool accumulate,
                  cudaStream_t stream) {
  const int64_t blocks =
      (num_groups * kCwLanes + kLevelThreads - 1) / kLevelThreads;
  if (blocks == 0 || k == 0) return cudaSuccess;
  const unsigned ncb = column_blocks(k, kb);
  if (ncb == 0 || kb > kKB) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), ncb);
  cw_level_spmm_kernel<T><<<grid, kLevelThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(local_index),
      static_cast<const int*>(anchor4), static_cast<const int*>(group_ptr),
      d, num_groups, num_rows, num_columns, k, kb,
      static_cast<const T*>(X), static_cast<T*>(Y), accumulate);
  return cudaGetLastError();
}

template <typename T, int KB>
cudaError_t pool_kb(const void* value, const void* local_index,
                    const void* anchor4, const void* rowmap,
                    const void* block_ptr, int d, int out_rows,
                    int64_t num_blocks, int64_t num_rows,
                    int64_t num_columns, int k, int kb, const void* X,
                    void* Y, bool accumulate, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(out_rows) * kb * kWarp * sizeof(T);
  cudaError_t e = allow_smem(cw_pool_spmm_kernel<T, KB>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(num_blocks), kCwLanes / kWarp,
                  column_blocks(k, kb));
  cw_pool_spmm_kernel<T, KB><<<grid, kWarp, smem, stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(local_index),
      static_cast<const int*>(anchor4), static_cast<const int*>(rowmap),
      static_cast<const int*>(block_ptr), d, out_rows, num_rows,
      num_columns, k, kb, static_cast<const T*>(X), static_cast<T*>(Y),
      accumulate);
  return cudaGetLastError();
}

template <typename T>
cudaError_t pool(const void* value, const void* local_index,
                 const void* anchor4, const void* rowmap,
                 const void* block_ptr, int d, int out_rows,
                 int64_t num_blocks, int64_t num_rows, int64_t num_columns,
                 int k, int kb, const void* X, void* Y, bool accumulate,
                 cudaStream_t stream) {
  if (num_blocks == 0 || k == 0) return cudaSuccess;
  if (column_blocks(k, kb) == 0 || out_rows <= 0)
    return cudaErrorInvalidValue;
  switch (template_width(kb)) {
    case 1:
      return pool_kb<T, 1>(value, local_index, anchor4, rowmap, block_ptr,
                           d, out_rows, num_blocks, num_rows, num_columns, k,
                           kb, X, Y, accumulate, stream);
    case 2:
      return pool_kb<T, 2>(value, local_index, anchor4, rowmap, block_ptr,
                           d, out_rows, num_blocks, num_rows, num_columns, k,
                           kb, X, Y, accumulate, stream);
    case 4:
      return pool_kb<T, 4>(value, local_index, anchor4, rowmap, block_ptr,
                           d, out_rows, num_blocks, num_rows, num_columns, k,
                           kb, X, Y, accumulate, stream);
    case kKB:
      return pool_kb<T, kKB>(value, local_index, anchor4, rowmap, block_ptr,
                             d, out_rows, num_blocks, num_rows, num_columns,
                             k, kb, X, Y, accumulate, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int KB>
cudaError_t merged_kb(const void* value, const void* local_index,
                      const void* anchor4, int d, int cap,
                      int pool_per_block, int64_t num_blocks,
                      int64_t num_rows, int64_t num_columns, int k, int kb,
                      const void* X, void* Y, bool accumulate,
                      cudaStream_t stream) {
  const size_t smem = pool_per_block > 0
      ? static_cast<size_t>(kMergedRows) * kb * kWarp * sizeof(T) : 0;
  cudaError_t e = allow_smem(cw_merged_spmm_kernel<T, KB>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(num_blocks), kCwLanes / kWarp,
                  column_blocks(k, kb));
  cw_merged_spmm_kernel<T, KB><<<grid, kMergedWarps * kWarp, smem, stream>>>(
      static_cast<const T*>(value), static_cast<const int*>(local_index),
      static_cast<const int*>(anchor4), d, cap, pool_per_block, num_rows,
      num_columns, k, kb, static_cast<const T*>(X), static_cast<T*>(Y),
      accumulate);
  return cudaGetLastError();
}

template <typename T>
cudaError_t merged(const void* value, const void* local_index,
                   const void* anchor4, int d, int cap, int pool_per_block,
                   int64_t num_blocks, int64_t num_rows,
                   int64_t num_columns, int k, int kb, const void* X,
                   void* Y, bool accumulate, cudaStream_t stream) {
  if (num_blocks == 0 || k == 0) return cudaSuccess;
  if (column_blocks(k, kb) == 0) return cudaErrorInvalidValue;
  switch (template_width(kb)) {
    case 1:
      return merged_kb<T, 1>(value, local_index, anchor4, d, cap,
                             pool_per_block, num_blocks, num_rows,
                             num_columns, k, kb, X, Y, accumulate, stream);
    case 2:
      return merged_kb<T, 2>(value, local_index, anchor4, d, cap,
                             pool_per_block, num_blocks, num_rows,
                             num_columns, k, kb, X, Y, accumulate, stream);
    case 4:
      return merged_kb<T, 4>(value, local_index, anchor4, d, cap,
                             pool_per_block, num_blocks, num_rows,
                             num_columns, k, kb, X, Y, accumulate, stream);
    case kKB:
      return merged_kb<T, kKB>(value, local_index, anchor4, d, cap,
                               pool_per_block, num_blocks, num_rows,
                               num_columns, k, kb, X, Y, accumulate, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace spmv_tpu_torch

// Each returns the cudaError_t of the launch (0 on success).  dtype is
// kFloat32 or kFloat64 (dia_common.cuh); every index array is int32; kb
// is the column-block width, at most 8.

extern "C" int wellcw_level_spmm_launch(int dtype, int device,
                                        const void* value,
                                        const void* local_index,
                                        const void* anchor4,
                                        const void* group_ptr, int d,
                                        long long num_groups,
                                        long long num_rows,
                                        long long num_columns, int k,
                                        int kb, const void* X, void* Y,
                                        int accumulate, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return level<float>(value, local_index, anchor4, group_ptr, d,
                          num_groups, num_rows, num_columns, k, kb, X, Y,
                          accumulate != 0, s);
    case kFloat64:
      return level<double>(value, local_index, anchor4, group_ptr, d,
                           num_groups, num_rows, num_columns, k, kb, X, Y,
                           accumulate != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int wellcw_pool_spmm_launch(int dtype, int device,
                                       const void* value,
                                       const void* local_index,
                                       const void* anchor4,
                                       const void* rowmap,
                                       const void* block_ptr, int d,
                                       int out_rows, long long num_blocks,
                                       long long num_rows,
                                       long long num_columns, int k, int kb,
                                       const void* X, void* Y,
                                       int accumulate, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return pool<float>(value, local_index, anchor4, rowmap, block_ptr, d,
                         out_rows, num_blocks, num_rows, num_columns, k, kb,
                         X, Y, accumulate != 0, s);
    case kFloat64:
      return pool<double>(value, local_index, anchor4, rowmap, block_ptr, d,
                          out_rows, num_blocks, num_rows, num_columns, k,
                          kb, X, Y, accumulate != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int wellcw_merged_spmm_launch(int dtype, int device,
                                         const void* value,
                                         const void* local_index,
                                         const void* anchor4, int d, int cap,
                                         int pool_per_block,
                                         long long num_blocks,
                                         long long num_rows,
                                         long long num_columns, int k,
                                         int kb, const void* X, void* Y,
                                         int accumulate, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return merged<float>(value, local_index, anchor4, d, cap,
                           pool_per_block, num_blocks, num_rows, num_columns,
                           k, kb, X, Y, accumulate != 0, s);
    case kFloat64:
      return merged<double>(value, local_index, anchor4, d, cap,
                            pool_per_block, num_blocks, num_rows,
                            num_columns, k, kb, X, Y, accumulate != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

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
// What the design does about it:
// - Columns go in blocks of kb (grid dimension y for K4a and K4b, z for
//   K4c); every column block re-reads its part's value + index stream,
//   so kb is as wide as registers and shared memory allow.  The wrapper
//   (ops/wellcw_kernels.py, column_block) picks kb and passes it to
//   every launch.  A level thread (K4a, K4b) keeps kb <= kKB = 8 sums in
//   registers.  K4c's pool tiles hold rows x kb x 32 accumulators in
//   dynamic shared memory, kb from a byte budget per dtype; above 48 KB
//   the launcher opts in with cudaFuncSetAttribute.  Every k >= 1 is
//   accepted.
// - Level chunks: one thread per (group, lane, column block) walks its
//   group's chunks in order; each chunk's 8 slots are summed per column
//   into a strip, then added to the column's sum, in the order K3a adds
//   them (cw_strip_cols), so column j of Y sums as the SpMV of X[:, j].
// - K4c's pool cells: one warp per (output block, 32-lane slice, column
//   block) walks the block's pool chunks in order and adds into a shared
//   tile [rows][kb][32] whose column l32 only thread l32 touches (no bank
//   conflicts, barriers or atomics).  The X values of a group of slots
//   are all loaded before any is added (cw_pool_add), so their gather
//   latencies overlap as K3b's do; the column count of a block is a
//   template width KB in {1, 2, 4, 8} (kb <= KB, the rest predicated
//   off), so those loads unroll into registers.  Where a thread reads Y
//   back (K4c's accumulate), it loads a batch of rows before storing any
//   (store_tile_rows), so the loads' latencies overlap.
// - K4a, one thread per row of the merged grid and column block (1M
//   threads at the bench leg's 1M rows: several waves, as K3a's grid):
//   the thread sums its group's cap level chunks in registers as K4b
//   does, then its own pool cells from a host-built pool list
//   (models/device.py, merged_pool_list: each row's cells of the pool
//   chunks in storage order, their value and column), and writes y =
//   (y_old + level) + pool, the Pallas kernel's order: no shared tile,
//   no warp walking a block's pool alone, no barrier and no Y read-back
//   without accumulate.  Where X's rows and the column block are whole
//   16-byte runs and X and Y are aligned, a cell's kb X values are
//   16-byte loads (two at kb = 8 in float32), else one load a value.
//   The level part reads the container's int16 copy of its indices
//   (w * 128 + lane < 1024 d, and a merged grid has d <= 16).
// Every sum runs in a fixed order, so two runs give bitwise equal Y.
// Sums are kept in the storage type (float or double).
//
// Output: the first launch of a product writes every row < num_rows
// (accumulate = 0); later launches add (accumulate = 1).  Rows past
// num_rows are never written, so Y can be an exactly (num_rows, k)
// buffer.  Y must not overlap X.

#include <type_traits>

#include "cw_common.cuh"
#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kWarp = 32;
constexpr int kMergedRows = 64;      // groups per merged output block
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
template <typename T, int KB>
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
      const int64_t col =
          cw_column(anchor4, d, loc[s0 + s] >> 7, loc[s0 + s]);
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
    cw_strip_cols<T, kKB>(value, local_index, __ldg(anchor4 + c), d, c,
                          lane, X, num_columns, k, c0, kc, strip);
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
    cw_pool_add<T, KB>(tile, kb, out_rows, l32, loc, val, rel, a4, d,
                              X, num_columns, k, c0, kc);
  }
  store_tile_rows<T, KB>(
      Y, num_rows, k, c0, kc, out_rows, accumulate,
      [&](int r) { return (base_group + r) * kCwLanes + lane; },
      [&](int r) { return tile + static_cast<int64_t>(r) * kb * kWarp + l32; });
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

// K4a: grid (ceil(num_groups * 128 / 256), ceil(k / kb)); thread t of x
// owns row t of the merged grid (group g = t / 128 of block b = g / 64,
// tile row r = g % 64, lane t % 128), y is the column block of kb <= KB
// columns.  Level chunk q of group g is b * kl + r * cap + q of the grid
// and g * cap + q of level_index, the level chunks' int16 indices.  With
// a pool list (pool_ptr not null) the row's pool cells are [e, e_end) =
// pool_ptr[i .. i + 1], i = (b * 128 + lane) * 64 + r.  The time goes
// to the dependent index -> X gathers, so rows in flight count more than
// loads in flight a row: a thread loads G slots' X values at a time (16
// values), and in float32 the kernel keeps to 64 registers so that four
// CTAs share an SM (two CTAs at 82 registers, or three with four slots'
// X loads at a time, measured slower).
template <typename T, int KB, bool Vec>
__global__ void __launch_bounds__(kLevelThreads, sizeof(T) == 4 ? 4 : 1)
    cw_merged_spmm_kernel(const T* __restrict__ value,
                          const int16_t* __restrict__ level_index,
                          const int* __restrict__ anchor4,
                          const int* __restrict__ pool_ptr,
                          const int* __restrict__ pool_col,
                          const T* __restrict__ pool_value, int d, int cap,
                          int kl, int64_t num_groups, int64_t num_rows,
                          int64_t num_columns, int k, int kb,
                          const T* __restrict__ X, T* __restrict__ Y,
                          bool accumulate) {
  constexpr int G = 16 / KB < kCwSlots ? 16 / KB : kCwSlots;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t g = row / kCwLanes;
  const int lane = static_cast<int>(row % kCwLanes);
  if (g >= num_groups || row >= num_rows) return;
  const int64_t b = g / kMergedRows;
  const int r = static_cast<int>(g % kMergedRows);
  const int c0 = blockIdx.y * kb;
  const int kc = min(kb, k - c0);
  // the pool run's pointers first, so that their latency hides under the
  // level chunks
  int e = 0, e_end = 0;
  if (pool_ptr != nullptr) {
    const int64_t i = (b * kCwLanes + lane) * kMergedRows + r;
    e = __ldg(pool_ptr + i);
    e_end = __ldg(pool_ptr + i + 1);
  }
  // the group's level chunks, walked by pointer (few 64-bit temporaries:
  // the float32 kernel runs at its register cap)
  const int64_t first = b * kl + static_cast<int64_t>(r) * cap;
  const T* vp = value + first * kCwChunk + lane;
  const int16_t* ip = level_index + g * cap * kCwChunk + lane;
  const int* ap = anchor4 + first;
  const T* Xc = X + c0;
  T acc[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) acc[j] = T(0);
  for (int q = 0; q < cap; ++q, vp += kCwChunk, ip += kCwChunk) {
    const int a4 = __ldg(ap + q);
    int loc[kCwSlots];
    T val[kCwSlots];
#pragma unroll
    for (int s = 0; s < kCwSlots; ++s) {
      val[s] = __ldcs(vp + s * kCwLanes);
      loc[s] = __ldcs(ip + s * kCwLanes);
    }
    T strip[KB];
#pragma unroll
    for (int j = 0; j < KB; ++j) strip[j] = T(0);
#pragma unroll
    for (int s0 = 0; s0 < kCwSlots; s0 += G) {
      T xv[G][KB];
      bool ok[G];
#pragma unroll
      for (int s = 0; s < G; ++s) {
        const int l = loc[s0 + s];
        const int64_t col = cw_column(a4, d, (l >> 7) & (8 * d - 1), l);
        ok[s] = col < num_columns;   // past the end: reads 0, adds nothing
        load_row<T, KB, Vec>(Xc + (ok[s] ? col : 0) * k, ok[s] ? kc : 0,
                             xv[s]);
      }
#pragma unroll
      for (int s = 0; s < G; ++s) {
        if (!ok[s]) continue;
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          if (j < kc) strip[j] += val[s0 + s] * xv[s][j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < KB; ++j) acc[j] += strip[j];
  }
  T pool[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) pool[j] = T(0);
  for (; e < e_end; e += G) {
    int col[G];
    T v[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const bool live = e + i < e_end;
      col[i] = live ? __ldg(pool_col + e + i) : -1;
      v[i] = live ? __ldg(pool_value + e + i) : T(0);
    }
    T xv[G][KB];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      // a column past the end reads 0 (the cell adds v * 0, as the tile
      // of the Pallas kernel's pool does)
      const bool ok = col[i] >= 0 && col[i] < num_columns;
      load_row<T, KB, Vec>(Xc + static_cast<int64_t>(ok ? col[i] : 0) * k,
                           ok ? kc : 0, xv[i]);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (e + i >= e_end) continue;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (j < kc) pool[j] += v[i] * xv[i][j];
      }
    }
  }
  // y = (y_old + level) + pool, or level + pool: the Pallas kernel's order
  T* yr = Y + row * k + c0;
  T old[KB];
  load_row<T, KB, Vec, false>(yr, accumulate ? kc : 0, old);
  T out[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) {
    T t = accumulate ? old[j] + acc[j] : acc[j];
    out[j] = pool_ptr != nullptr ? t + pool[j] : t;
  }
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

// Every argument of a K4a launch, passed on as it is.
struct MergedArgs {
  const void* value;
  const void* level_index;
  const void* anchor4;
  const void* pool_ptr;
  const void* pool_col;
  const void* pool_value;
  int d, cap, kl;
  int64_t num_groups, num_rows, num_columns;
  int k, kb;
  const void* X;
  void* Y;
  bool accumulate;
};

template <typename T, int KB, bool Vec>
cudaError_t merged_kb(const MergedArgs& a, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(
                      (a.num_groups * kCwLanes + kLevelThreads - 1) /
                      kLevelThreads),
                  column_blocks(a.k, a.kb));
  cw_merged_spmm_kernel<T, KB, Vec><<<grid, kLevelThreads, 0, stream>>>(
      static_cast<const T*>(a.value),
      static_cast<const int16_t*>(a.level_index),
      static_cast<const int*>(a.anchor4),
      static_cast<const int*>(a.pool_ptr),
      static_cast<const int*>(a.pool_col),
      static_cast<const T*>(a.pool_value), a.d, a.cap, a.kl, a.num_groups,
      a.num_rows, a.num_columns, a.k, a.kb, static_cast<const T*>(a.X),
      static_cast<T*>(a.Y), a.accumulate);
  return cudaGetLastError();
}

// 16-byte X and Y loads need 16-byte rows and column blocks and aligned
// X and Y; a width of fewer than 16 bytes takes them one at a time.
template <typename T, int KB>
cudaError_t merged_vec(const MergedArgs& a, bool vector_x,
                       cudaStream_t stream) {
  if (!vector_x) return merged_kb<T, KB, false>(a, stream);
  if constexpr ((KB * sizeof(T)) % 16 == 0) {
    const bool ok = (a.k * sizeof(T)) % 16 == 0 &&
                    (a.kb * sizeof(T)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.X) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a.Y) % 16 == 0;
    if (ok) return merged_kb<T, KB, true>(a, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t merged(const MergedArgs& a, bool vector_x, cudaStream_t stream) {
  if (a.num_groups == 0 || a.k == 0) return cudaSuccess;
  if (column_blocks(a.k, a.kb) == 0 || a.cap <= 0 || a.kl < 64 * a.cap ||
      (a.pool_ptr != nullptr &&
       (a.pool_col == nullptr || a.pool_value == nullptr)))
    return cudaErrorInvalidValue;
  switch (template_width(a.kb)) {
    case 1:
      return merged_vec<T, 1>(a, vector_x, stream);
    case 2:
      return merged_vec<T, 2>(a, vector_x, stream);
    case 4:
      return merged_vec<T, 4>(a, vector_x, stream);
    case kKB:
      return merged_vec<T, kKB>(a, vector_x, stream);
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

// K4a: level_index is the level chunks' int16 indices; pool_ptr,
// pool_col and pool_value the pool list, or null where the grid has no
// pool chunks; vector_x asks for 16-byte X and Y loads (k and kb whole
// 16-byte runs, X and Y aligned).
extern "C" int wellcw_merged_spmm_launch(
    int dtype, int device, const void* value, const void* level_index,
    const void* anchor4, const void* pool_ptr, const void* pool_col,
    const void* pool_value, int d, int cap, int kl, long long num_groups,
    long long num_rows, long long num_columns, int k, int kb, int vector_x,
    const void* X, void* Y, int accumulate, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MergedArgs a = {value, level_index, anchor4, pool_ptr, pool_col,
                        pool_value, d, cap, kl, num_groups, num_rows,
                        num_columns, k, kb, X, Y, accumulate != 0};
  switch (dtype) {
    case kFloat32:
      return merged<float>(a, vector_x != 0, s);
    case kFloat64:
      return merged<double>(a, vector_x != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

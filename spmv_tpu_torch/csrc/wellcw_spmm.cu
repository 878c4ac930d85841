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
// - Columns go in blocks of kb <= 8 (grid dimension y), a thread's sums
//   in registers; every column block re-reads its part's stream, so kb
//   is as wide as registers allow.  The wrapper (ops/wellcw_kernels.py,
//   column_block) picks kb and passes it to every launch; every k >= 1 is
//   accepted.  Where X's rows and the column block are whole 16-byte
//   runs and X and Y are aligned, a cell's kb X values are 16-byte loads
//   (two at kb = 8 in float32), else one load a value (spmm_rows.cuh).
// - Level chunks (K4a's level part and K4b): one thread per (group,
//   lane, column block) walks its group's chunks in order through one
//   device function, add_level_chunks: values and indices stream with
//   the evict-first hint, G slots' X rows in flight at a time; each
//   chunk's 8 slots are summed per column into a strip, then added to
//   the column's sum, in the order K3a adds them, so column j of Y sums
//   as the SpMV of X[:, j].  Both read the level's int16 copy of its
//   indices where it has one (w * 128 + lane < 1024 d: d <= 32, and a
//   merged grid has d <= 16); K4b reads the int32 local_index of a level
//   of d > 32.  In float32 both keep to 64 registers, four CTAs an SM.
// - K4c, a pool, one thread per row that owns a pool cell and column
//   block: the thread sums its run of a host-built row list
//   (models/device.py, pool_row_list: each row's cells in storage order,
//   chunk then slot, their value and column) in registers and writes y
//   or y_old + sum, the order of the Pallas kernel's tile.  So the cell
//   stream is read once for all kb columns, and only the rows that own a
//   cell are read and written.  At the bench leg's tail pool, 39.5K of
//   the 1M rows own cells, and the 8,192 rows of one group of each of
//   its 64 blocks own about 124 zero-valued padding cells each: so the
//   list lies in slices of 32 rows, longest runs first
//   (sliced_row_list), so a warp's lanes read neighbouring cells, and a
//   thread walks its run G cells at a time, the next G cells' list
//   entries loaded while the X rows of these are in flight: a long run
//   is a chain of list load -> X load, which set the time (0.066 ms
//   without the overlap, 0.024 with it; without it, more cells in
//   flight, the sliced layout and CTAs of 32-256 threads each changed it
//   by 10% or less).  Without
//   accumulate, Y is zeroed first (cudaMemsetAsync) and the rows with no
//   cell stay 0; with accumulate they are not written, so a -0.0 there
//   stays -0.0 (the Pallas kernel's tile adds +0.0 there and gives +0.0):
//   a stated deviation.
// - K4a, one thread per row of the merged grid and column block (1M
//   threads at the bench leg's 1M rows: several waves, as K3a's grid):
//   the thread sums its group's cap level chunks in registers as K4b
//   does, then its own pool cells from a host-built pool list
//   (models/device.py, merged_pool_list: each row's cells of the pool
//   chunks in storage order, their value and column), and writes y =
//   (y_old + level) + pool, the Pallas kernel's order: no shared tile,
//   no warp walking a block's pool alone, no barrier and no Y read-back
//   without accumulate.
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
#include "spmm_rows.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kWarp = 32;
constexpr int kMergedRows = 64;      // groups per merged output block
constexpr int kLevelThreads = 256;
// K4c: one warp a CTA, so that the slices of the longest runs spread
// over the SMs (bench leg, cold L2: 0.0233 ms; CTAs of 64 threads 0.0242,
// of 256 0.0313)
constexpr int kPoolThreads = 32;

// The n level chunks of one group in lane `lane`, added into acc: chunk
// q's slot s holds its value at vp[q * 1024 + s * 128] and its index at
// ip[q * 1024 + s * 128] (IdxT int16_t for an int16 copy, int for the
// container's local_index), its anchor at ap[q].
// Merged decodes a cell's window slot as a merged grid's level chunk
// does, (l >> 7) & (8 d - 1), else as a level's, l >> 7.  The values
// and indices stream once (__ldcs: evict first, so X's lines stay in the
// L2); a chunk's 8 slots are summed into a strip slot by slot, G slots'
// X rows loaded at a time (16 values), and the strip then added to acc:
// the order K3a adds a chunk in, so column j of Y sums as the SpMV of
// X[:, j].  A column past the end reads 0 and adds nothing.
template <typename T, int KB, bool Vec, bool Merged, typename IdxT>
__device__ __forceinline__ void add_level_chunks(
    const T* vp, const IdxT* ip, const int* ap, int n, int d,
    const T* Xc, int64_t num_columns, int k, int kc, T (&acc)[KB]) {
  constexpr int G = 16 / KB < kCwSlots ? 16 / KB : kCwSlots;
  // n counts down and ap walks: K4a measured 4% faster than with a
  // chunk index (0.144 against 0.151 ms at the bench leg), K4b within 1%
  for (; n > 0; --n, ++ap, vp += kCwChunk, ip += kCwChunk) {
    const int a4 = __ldg(ap);
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
        const int w = Merged ? (l >> 7) & (8 * d - 1) : l >> 7;
        const int64_t col = cw_column(a4, d, w, l);
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
}

// K4b: grid (ceil(num_groups * 128 / 256), ceil(k / kb)); thread t of x
// owns row t (group g = t / 128, lane t % 128), y is the column block of
// kb <= KB columns.  Group g's chunks are [group_ptr[g], group_ptr[g +
// 1]) of the level, walked as K4a walks its level chunks; then y = y_old
// + sum (accumulate) or sum.  In float32 it keeps to 64 registers, four
// CTAs an SM, as K4a does (48 bytes spill there; three CTAs at 80
// registers, no spill, measured 1.5% slower at the bench leg).
template <typename T, int KB, bool Vec, typename IdxT>
__global__ void __launch_bounds__(kLevelThreads, sizeof(T) == 4 ? 4 : 1)
    cw_level_spmm_kernel(const T* __restrict__ value,
                         const IdxT* __restrict__ local_index,
                         const int* __restrict__ anchor4,
                         const int* __restrict__ group_ptr, int d,
                         int64_t num_groups, int64_t num_rows,
                         int64_t num_columns, int k, int kb,
                         const T* __restrict__ X, T* __restrict__ Y,
                         bool accumulate) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t g = row / kCwLanes;
  const int lane = static_cast<int>(row % kCwLanes);
  if (g >= num_groups || row >= num_rows) return;
  const int c0 = blockIdx.y * kb;
  const int kc = min(kb, k - c0);
  const int first = __ldg(group_ptr + g);
  const int n = __ldg(group_ptr + g + 1) - first;
  const int64_t cell = static_cast<int64_t>(first) * kCwChunk + lane;
  T acc[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) acc[j] = T(0);
  add_level_chunks<T, KB, Vec, false>(value + cell, local_index + cell,
                                      anchor4 + first, n, d, X + c0,
                                      num_columns, k, kc, acc);
  T* yr = Y + row * k + c0;
  T out[KB];
  load_row<T, KB, Vec, false>(yr, accumulate ? kc : 0, out);
#pragma unroll
  for (int j = 0; j < KB; ++j) out[j] = accumulate ? out[j] + acc[j] : acc[j];
  store_row<T, KB, Vec>(yr, kc, out);
}

// K4c: grid (ceil(num_listed / 32), ceil(k / kb)); thread t of x owns
// listed row t, Y row list_rows[t], and its list_len[t] cells in storage
// order, cell i at list_slice[t / 32] + 32 i + t % 32 (a warp's slice
// of 32 rows lies slot-major, so its lanes read neighbouring cells); y
// is the column block of kb <= KB columns.  A row of the bench leg's
// tail may hold 128 cells, a chain of list load -> X load -> add: the
// thread loads the X rows of G cells at a time, and the list entries of
// the next G while they are in flight.  Then it writes y = y_old + sum
// (accumulate) or sum.
template <typename T, int KB, bool Vec>
__global__ void __launch_bounds__(kPoolThreads)
    cw_pool_spmm_kernel(const int* __restrict__ list_rows,
                        const int* __restrict__ list_len,
                        const int* __restrict__ list_slice,
                        const int* __restrict__ list_col,
                        const T* __restrict__ list_value,
                        int64_t num_listed, int64_t num_rows,
                        int64_t num_columns, int k, int kb,
                        const T* __restrict__ X, T* __restrict__ Y,
                        bool accumulate) {
  // 64 words of X in flight (8 cells at k = 8 in float32): 16 words
  // were 1.6x slower, 32 1.1x (bench leg, cold L2)
  constexpr int W = KB * static_cast<int>(sizeof(T)) / 4;
  constexpr int G = 64 / W < kCwSlots ? 64 / W : kCwSlots;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t >= num_listed) return;
  const int64_t row = __ldg(list_rows + t);
  if (row >= num_rows) return;
  const int c0 = blockIdx.y * kb;
  const int kc = min(kb, k - c0);
  const T* Xc = X + c0;
  T acc[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) acc[j] = T(0);
  const int len = __ldg(list_len + t);
  const int* cp = list_col + __ldg(list_slice + t / kWarp) + t % kWarp;
  const T* vp = list_value + (cp - list_col);
  int col[G];
  T v[G];
  load_cells<T, G, kWarp>(cp, vp, 0, len, col, v);
  for (int e = 0; e < len; e += G) {
    T xv[G][KB];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      // a column past the end reads 0 (the cell adds v * 0, as the tile
      // of the Pallas kernel's pool does)
      const bool ok = col[i] >= 0 && col[i] < num_columns;
      load_row<T, KB, Vec>(Xc + static_cast<int64_t>(ok ? col[i] : 0) * k,
                           ok ? kc : 0, xv[i]);
    }
    int next_col[G];
    T next_v[G];
    load_cells<T, G, kWarp>(cp, vp, e + G, len, next_col, next_v);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if (e + i >= len) continue;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (j < kc) acc[j] += v[i] * xv[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      col[i] = next_col[i];
      v[i] = next_v[i];
    }
  }
  T* yr = Y + row * k + c0;
  T out[KB];
  load_row<T, KB, Vec, false>(yr, accumulate ? kc : 0, out);
#pragma unroll
  for (int j = 0; j < KB; ++j) out[j] = accumulate ? out[j] + acc[j] : acc[j];
  store_row<T, KB, Vec>(yr, kc, out);
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
  // the group's level chunks (few 64-bit temporaries: the float32
  // kernel runs at its register cap)
  const int64_t first = b * kl + static_cast<int64_t>(r) * cap;
  const T* Xc = X + c0;
  T acc[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) acc[j] = T(0);
  add_level_chunks<T, KB, Vec, true>(value + first * kCwChunk + lane,
                                     level_index + g * cap * kCwChunk + lane,
                                     anchor4 + first, cap, d, Xc,
                                     num_columns, k, kc, acc);
  T pool[KB];
#pragma unroll
  for (int j = 0; j < KB; ++j) pool[j] = T(0);
  for (; e < e_end; e += G) {
    int col[G];
    T v[G];
    load_cells<T, G, 1>(pool_col, pool_value, e, e_end, col, v);
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
  store_row<T, KB, Vec>(yr, kc, out);
}

// Every argument of a K4b launch, passed on as it is.
struct LevelArgs {
  const void* value;
  const void* local_index;
  int index_bits;
  const void* anchor4;
  const void* group_ptr;
  int d;
  int64_t num_groups, num_rows, num_columns;
  int k, kb;
  const void* X;
  void* Y;
  bool accumulate;
};

template <typename T>
cudaError_t level(const LevelArgs& a, bool vector_x, cudaStream_t stream) {
  const int64_t blocks =
      (a.num_groups * kCwLanes + kLevelThreads - 1) / kLevelThreads;
  if (blocks == 0 || a.k == 0) return cudaSuccess;
  if (column_blocks(a.k, a.kb) == 0 ||
      (a.index_bits != 16 && a.index_bits != 32))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), column_blocks(a.k, a.kb));
  return by_width<T>(a.k, a.kb, vector_x, a.X, a.Y, [&](auto w, auto vec) {
    constexpr int KB = decltype(w)::value;
    constexpr bool Vec = decltype(vec)::value;
    const auto run = [&](auto* index) {
      using IdxT = std::remove_const_t<std::remove_pointer_t<
          decltype(index)>>;
      cw_level_spmm_kernel<T, KB, Vec, IdxT>
          <<<grid, kLevelThreads, 0, stream>>>(
              static_cast<const T*>(a.value), index,
              static_cast<const int*>(a.anchor4),
              static_cast<const int*>(a.group_ptr), a.d, a.num_groups,
              a.num_rows, a.num_columns, a.k, a.kb,
              static_cast<const T*>(a.X), static_cast<T*>(a.Y),
              a.accumulate);
    };
    if (a.index_bits == 16)
      run(static_cast<const int16_t*>(a.local_index));
    else
      run(static_cast<const int*>(a.local_index));
    return cudaGetLastError();
  });
}

// Every argument of a K4c launch, passed on as it is.
struct PoolArgs {
  const void* list_rows;
  const void* list_len;
  const void* list_slice;
  const void* list_col;
  const void* list_value;
  int64_t num_listed, num_rows, num_columns;
  int k, kb;
  const void* X;
  void* Y;
  bool accumulate;
};

template <typename T>
cudaError_t pool(const PoolArgs& a, bool vector_x, cudaStream_t stream) {
  if (a.num_rows == 0 || a.k == 0) return cudaSuccess;
  if (column_blocks(a.k, a.kb) == 0) return cudaErrorInvalidValue;
  if (!a.accumulate) {
    cudaError_t e = cudaMemsetAsync(
        a.Y, 0, static_cast<size_t>(a.num_rows) * a.k * sizeof(T), stream);
    if (e != cudaSuccess) return e;
  }
  if (a.num_listed == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(
                      (a.num_listed + kPoolThreads - 1) / kPoolThreads),
                  column_blocks(a.k, a.kb));
  return by_width<T>(a.k, a.kb, vector_x, a.X, a.Y, [&](auto w, auto vec) {
    cw_pool_spmm_kernel<T, decltype(w)::value, decltype(vec)::value>
        <<<grid, kPoolThreads, 0, stream>>>(
            static_cast<const int*>(a.list_rows),
            static_cast<const int*>(a.list_len),
            static_cast<const int*>(a.list_slice),
            static_cast<const int*>(a.list_col),
            static_cast<const T*>(a.list_value), a.num_listed, a.num_rows,
            a.num_columns, a.k, a.kb, static_cast<const T*>(a.X),
            static_cast<T*>(a.Y), a.accumulate);
    return cudaGetLastError();
  });
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

template <typename T>
cudaError_t merged(const MergedArgs& a, bool vector_x, cudaStream_t stream) {
  if (a.num_groups == 0 || a.k == 0) return cudaSuccess;
  if (column_blocks(a.k, a.kb) == 0 || a.cap <= 0 || a.kl < 64 * a.cap ||
      (a.pool_ptr != nullptr &&
       (a.pool_col == nullptr || a.pool_value == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(
                      (a.num_groups * kCwLanes + kLevelThreads - 1) /
                      kLevelThreads),
                  column_blocks(a.k, a.kb));
  return by_width<T>(a.k, a.kb, vector_x, a.X, a.Y, [&](auto w, auto vec) {
    cw_merged_spmm_kernel<T, decltype(w)::value, decltype(vec)::value>
        <<<grid, kLevelThreads, 0, stream>>>(
            static_cast<const T*>(a.value),
            static_cast<const int16_t*>(a.level_index),
            static_cast<const int*>(a.anchor4),
            static_cast<const int*>(a.pool_ptr),
            static_cast<const int*>(a.pool_col),
            static_cast<const T*>(a.pool_value), a.d, a.cap, a.kl,
            a.num_groups, a.num_rows, a.num_columns, a.k, a.kb,
            static_cast<const T*>(a.X), static_cast<T*>(a.Y), a.accumulate);
    return cudaGetLastError();
  });
}

}  // namespace
}  // namespace spmv_tpu_torch

// Each returns the cudaError_t of the launch (0 on success).  dtype is
// kFloat32 or kFloat64 (dia_common.cuh); every index array is int32 but
// K4a's level_index and K4b's int16 copy; kb is the column-block width,
// at most 8.

// K4b: local_index is the level's int16 copy (index_bits 16) or its
// int32 local_index (32); vector_x asks for 16-byte X and Y loads (k and
// kb whole 16-byte runs, X and Y aligned).
extern "C" int wellcw_level_spmm_launch(
    int dtype, int device, const void* value, const void* local_index,
    int index_bits, const void* anchor4, const void* group_ptr, int d,
    long long num_groups, long long num_rows, long long num_columns, int k,
    int kb, int vector_x, const void* X, void* Y, int accumulate,
    void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LevelArgs a = {value, local_index, index_bits, anchor4, group_ptr,
                       d, num_groups, num_rows, num_columns, k, kb, X, Y,
                       accumulate != 0};
  switch (dtype) {
    case kFloat32:
      return level<float>(a, vector_x != 0, s);
    case kFloat64:
      return level<double>(a, vector_x != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// K4c: list_rows, list_len, list_slice, list_col and list_value are the
// pool's row list in slices of 32 rows (num_listed rows); vector_x asks
// for 16-byte X and Y loads (k and kb whole 16-byte runs, X and Y
// aligned).  Without accumulate, Y's num_rows rows are zeroed first.
extern "C" int wellcw_pool_spmm_launch(
    int dtype, int device, const void* list_rows, const void* list_len,
    const void* list_slice, const void* list_col, const void* list_value,
    long long num_listed, long long num_rows, long long num_columns, int k,
    int kb, int vector_x, const void* X, void* Y, int accumulate,
    void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PoolArgs a = {list_rows, list_len, list_slice, list_col,
                      list_value, num_listed, num_rows, num_columns, k,
                      kb, X, Y, accumulate != 0};
  switch (dtype) {
    case kFloat32:
      return pool<float>(a, vector_x != 0, s);
    case kFloat64:
      return pool<double>(a, vector_x != 0, s);
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

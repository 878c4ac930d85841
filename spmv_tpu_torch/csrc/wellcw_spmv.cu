// Kernels K3a, K3b and K3c: WELL-CW SpMV, y (+)= A x over chunk-window
// chunks (see cw_common.cuh for the cell addressing).
//
// Replace the Pallas kernels of spmv_tpu/ops/pallas_kernels.py:
//   K3a cw_level_kernel   <- _cw_kernel (line 1374), a fallback level;
//   K3b cw_pool_kernel    <- _cw_pool_kernel (line 1484), a pooled level;
//   K3c cw_merged_kernel  <- _cw_merged_kernel (line 1568), the merged
//                            level + stage-1 pool grid.
//
// What bounds them on an H100: bytes.  Each cell streams a value and an
// index (8 bytes in float32 with an int32 index; a pool cell also its
// int32 rowmap) and gathers one x entry for 2 flops; x (4 MB at 1M
// columns) stays in the 50 MB L2, so the time is the chunk stream over
// device-memory bandwidth, as long as enough of it is in flight while
// the dependent index -> x gathers wait on the L2.
//
// K3a, one thread per (group, lane): the thread walks its group's
// chunks in order, sums each chunk's 8 slots in slot order into a strip,
// then the strips in chunk order; a warp's 32 lanes read 128 contiguous
// bytes of each slot's values, with the streaming cache hint (__ldcs:
// read once, evict first, so x's lines stay in the L2).  A level's
// local_index is w * 128 + lane < 1024 d, so for d <= 32 the container
// keeps an int16 copy and K3a reads that: 6 bytes a float32 cell instead
// of 8, a quarter less stream, the same columns and sums.  (A warp a
// chunk with 16-byte loads, K5's design, measured no faster here: the
// 1-lane walk already keeps enough of the stream in flight.)  x is read
// straight from memory (no stride-d tables: a gather through the L2 is
// cheap on Hopper, and the TPU needed the tables only to turn a gather
// into aligned slices).
//
// K3b and K3c, a chunk stream copied in bulk (Hopper):
// - One output block (64 groups for K3c, out_rows for K3b; a slice of
//   `lanes` of its 128 lanes where the (rows x 128) tile would not fit
//   shared memory) belongs to one thread-block cluster of C CTAs.  The
//   kernels take C = 1, 2 or 4; the host picks 1 or 2, so that the grid
//   covers the card's SMs (ops/wellcw_kernels.py, cluster_size).  The
//   block's chunks are split into C fixed contiguous ranges, one a CTA.
// - In each CTA one producer thread keeps `stages` chunks in flight: a
//   chunk's value, local_index and (pools) rowmap rows are 1-D bulk
//   copies (cp.async.bulk, 16-byte aligned by construction) into a ring
//   in shared memory, completing on the stage's "full" mbarrier, read
//   once with an L2 evict-first hint so that x stays in the L2.  The
//   host sizes the ring at up to 48 KB and two CTAs an SM, so that at
//   least 32 KB of stream are in flight on every SM whatever the
//   gathers do.
// - Consumer thread t owns lane t of the slice.  It takes the chunks
//   kBatch at a time: it waits on their stages, reads its lane's 8 slots
//   of each into registers, frees the stages (one arrival a warp on
//   "empty"), issues all their x gathers at once (kBatch x 8 loads in
//   flight a thread), then adds into its own column of the CTA's (rows
//   x lanes) tile in shared memory, chunk by chunk: a
//   level chunk's strip into its group's row, a pool cell into its row
//   (local_index >> 14 for K3c, rowmap - the block's first group for
//   K3b).  No two threads touch one accumulator: no atomics and no
//   barrier inside the walk, and the pool chunks are spread over all
//   consumers like the level chunks.
// - A K3c CTA first bulk-copies its block's part of x (the host's
//   x_window, up to `window` columns) into shared memory and gathers from
//   there; a column outside it is read from device memory.  The ring and
//   the tile leave the L1 too small to hold x's block window, and the
//   gathers through it cost K3c about a quarter more time.
// - With accumulate, the producer asks the L2 for the y rows its CTA
//   adds to before the walk, so that the epilogue does not wait on
//   device memory.
// - Then the cluster synchronises, and CTA rank r adds rows
//   [r R / C, (r + 1) R / C) of the C tiles, read through distributed
//   shared memory in rank order, and writes those rows of y once,
//   kRowBatch rows a thread at a time so that their reads overlap.
// Every sum runs in a fixed order (chunks in storage order within a
// CTA, slots in order, tiles in rank order), so two launches with the
// same cluster size give bitwise equal y.  Sums are kept in the storage
// type (float or double), as the Pallas kernels keep them.
//
// Output: the first launch of a product writes every row < num_rows
// (accumulate = 0); later launches add (accumulate = 1).  Rows past
// num_rows are never written, so y can be an exactly num_rows buffer.
// y must not overlap x.

#include <cooperative_groups.h>

#include "cw_common.cuh"
#include "dia_common.cuh"
#include "mbarrier.cuh"

namespace spmv_tpu_torch {
namespace {

namespace cg = cooperative_groups;

constexpr int kWarp = 32;
constexpr int kMergedRows = 64;      // groups per merged output block
constexpr int kMaxStages = 8;        // the ring's most stages
constexpr int kBatch = 4;            // chunks a consumer step holds
constexpr int kRowBatch = 16;        // y rows a thread writes at once
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ y, int64_t row,
                                          T v, bool accumulate) {
  y[row] = accumulate ? y[row] + v : v;
}

// K3a: grid of ceil(num_groups * 128 / blockDim.x) blocks; thread t is
// (group t / 128, lane t % 128).  IdxT is int (local_index) or int16_t
// (its int16 copy).
template <typename T, typename IdxT>
__global__ void __launch_bounds__(256)
    cw_level_kernel(const T* __restrict__ value,
                    const IdxT* __restrict__ local_index,
                    const int* __restrict__ anchor4,
                    const int* __restrict__ group_ptr, int d,
                    int64_t num_groups, int64_t num_rows,
                    int64_t num_columns, const T* __restrict__ x,
                    T* __restrict__ y, bool accumulate) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t g = row / kCwLanes;
  const int lane = static_cast<int>(row % kCwLanes);
  if (g >= num_groups || row >= num_rows) return;
  T acc = T(0);
  const int end = group_ptr[g + 1];
  for (int c = group_ptr[g]; c < end; ++c) {
    const int a4 = __ldg(anchor4 + c);
    const int64_t base = static_cast<int64_t>(c) * kCwChunk + lane;
    T val[kCwSlots];
    int loc[kCwSlots];
#pragma unroll
    for (int s = 0; s < kCwSlots; ++s) {
      val[s] = __ldcs(value + base + s * kCwLanes);
      loc[s] = __ldcs(local_index + base + s * kCwLanes);
    }
    T strip = T(0);
#pragma unroll
    for (int s = 0; s < kCwSlots; ++s)
      strip += val[s] * cw_x(x, num_columns, a4, d, loc[s] >> 7, loc[s]);
    acc += strip;
  }
  store_row(y, row, acc, accumulate);
}

// The ring of a streaming CTA, at the start of its dynamic shared
// memory: stage s holds `lanes` lanes of one chunk, value[8][lanes] (T),
// then local_index[8][lanes] and, with Rowmap, rowmap[8][lanes] (int32).
template <typename T, bool Rowmap>
struct CwRing {
  static constexpr int kPerCell = sizeof(T) + (Rowmap ? 8 : 4);
  unsigned char* base;
  int lanes;

  __device__ int stage_bytes() const { return kCwSlots * lanes * kPerCell; }
  __device__ T* value(int s) const {
    return reinterpret_cast<T*>(base + s * stage_bytes());
  }
  __device__ int* index(int s) const {
    return reinterpret_cast<int*>(value(s) + kCwSlots * lanes);
  }
  __device__ int* rowmap(int s) const { return index(s) + kCwSlots * lanes; }
};

__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty,
                                          int stages, int lanes) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], lanes / kWarp);   // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// The producer thread: copies chunks c0 .. c0 + n - 1 (lanes [l0, l0 +
// lanes) of each) into the ring in order, the q-th into stage q % stages
// once the consumers have freed it.  A whole chunk is one copy an array;
// a lane slice one copy a slot.
template <typename T, bool Rowmap>
__device__ void produce(const CwRing<T, Rowmap>& ring, uint64_t* full,
                        uint64_t* empty, int stages,
                        const T* __restrict__ value,
                        const int* __restrict__ local_index,
                        const int* __restrict__ rowmap, int64_t c0, int n,
                        int l0) {
  const uint64_t policy = l2_evict_first();
  const int lanes = ring.lanes;
  const int copies = lanes == kCwLanes ? 1 : kCwSlots;
  const int slots = kCwSlots / copies;      // slots a copy carries
  const uint32_t vbytes = slots * lanes * sizeof(T);
  const uint32_t ibytes = slots * lanes * 4;
  for (int q = 0; q < n; ++q) {
    const int s = q % stages;
    if (q >= stages) mbar_wait(&empty[s], (q / stages - 1) & 1);
    mbar_expect_tx(&full[s], ring.stage_bytes());
    const int64_t first = (c0 + q) * kCwChunk + l0;
    for (int j = 0; j < copies; ++j) {
      const int64_t src = first + j * kCwLanes;
      bulk_copy(ring.value(s) + j * lanes, value + src, vbytes, &full[s],
                policy);
      bulk_copy(ring.index(s) + j * lanes, local_index + src, ibytes,
                &full[s], policy);
      if (Rowmap)
        bulk_copy(ring.rowmap(s) + j * lanes, rowmap + src, ibytes,
                  &full[s], policy);
    }
  }
}

// The consumers' side: once every lane of the warp has read chunks q ..
// q + u - 1 into registers, one arrival a warp frees their stages.
__device__ __forceinline__ void release(uint64_t* empty, int q, int u,
                                        int stages) {
  __syncwarp();
  if (threadIdx.x % kWarp == 0)
    for (int i = 0; i < u; ++i) mbar_arrive(&empty[(q + i) % stages]);
}

// Warps converge, then the whole cluster meets (release / acquire: the
// tiles written before are visible to every CTA after).
__device__ __forceinline__ void cluster_sync(cg::cluster_group& cl) {
  __syncwarp();
  cl.sync();
}

// Tile rows [rank R / C, (rank + 1) R / C) of the cluster's rank, cut
// at `end` to those with a y row, (first_group + r) * 128 + l0 + t <
// num_rows, for the slice's thread t.
struct RankRows {
  int begin, end;
  __device__ RankRows(int C, int rank, int R, int64_t first_group, int l0,
                      int t, int64_t num_rows) {
    const int64_t lim = num_rows - (first_group * kCwLanes + l0 + t);
    const int64_t have = lim > 0 ? (lim + kCwLanes - 1) / kCwLanes : 0;
    begin = R * rank / C;
    end = static_cast<int>(min64(R * (rank + 1) / C, have));
  }
};

// With accumulate, the producer asks the L2 for the y rows its CTA will
// add to (the slice's lanes of each row), so that the epilogue's reads
// do not wait on device memory.
template <typename T>
__device__ __forceinline__ void prefetch_rows(int C, int rank, int R,
                                              int lanes, int64_t first_group,
                                              int l0, int64_t num_rows,
                                              const T* y) {
  const RankRows rr(C, rank, R, first_group, l0, 0, num_rows);
  if (reinterpret_cast<uintptr_t>(y) % 16 != 0) return;
  for (int r = rr.begin; r < rr.end; ++r) {
    const int64_t row = (first_group + r) * kCwLanes + l0;
    const int64_t count = min64(lanes, num_rows - row);
    const uint32_t bytes =
        static_cast<uint32_t>(count * sizeof(T)) / 16 * 16;
    if (bytes > 0) bulk_prefetch_l2(y + row, bytes);
  }
}

// The rank's rows of the sum of the cluster's C (R x lanes) tiles, added
// in rank order, into y: tile row r, lane t is y row (first_group + r) *
// 128 + l0 + t.  kRowBatch rows at a time, so that their tile and y
// reads are in flight together.
template <typename T>
__device__ __forceinline__ void write_rows(cg::cluster_group& cl,
                                           T* tile, int R, int lanes, int t,
                                           int64_t first_group, int l0,
                                           int64_t num_rows,
                                           T* __restrict__ y,
                                           bool accumulate) {
  const int C = static_cast<int>(cl.num_blocks());
  const RankRows rr(C, static_cast<int>(cl.block_rank()), R, first_group, l0,
                    t, num_rows);
  T* yt = y + first_group * kCwLanes + l0 + t;     // y row of tile row 0
  for (int r0 = rr.begin; r0 < rr.end; r0 += kRowBatch) {
    const int m = min(kRowBatch, rr.end - r0);
    T v[kRowBatch], old[kRowBatch];
    const T* t0 = cl.map_shared_rank(tile, 0);
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) {
      if (i < m) {
        v[i] = t0[(r0 + i) * lanes + t];
        old[i] = accumulate ? yt[(r0 + i) * kCwLanes] : T(0);
      }
    }
    for (int j = 1; j < C; ++j) {
      const T* tj = cl.map_shared_rank(tile, j);
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i)
        if (i < m) v[i] += tj[(r0 + i) * lanes + t];
    }
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i)
      if (i < m) yt[(r0 + i) * kCwLanes] = accumulate ? old[i] + v[i] : v[i];
  }
}

// x at a cell's column: from the CTA's staged window x[lo, lo + len) in
// shared memory where the column lies there, else from device memory (0
// past num_columns, as cw_x).
template <typename T>
__device__ __forceinline__ T cw_x_staged(const T* __restrict__ x,
                                         const T* xs, int64_t lo, int len,
                                         int64_t num_columns, int anchor4,
                                         int d, int w, int loc) {
  const int64_t col = cw_column(anchor4, d, w, loc);
  const uint64_t off = static_cast<uint64_t>(col - lo);
  if (off < static_cast<uint64_t>(len)) return xs[off];
  return col < num_columns ? __ldg(x + col) : T(0);
}

// K3c: grid (num_blocks * C), clusters of C CTAs, 128 consumer threads
// and one producer warp a CTA.  Chunk kk of block b is b * kl + kk: kk <
// 64 * cap are level chunks (group kk / cap), the rest pool chunks; CTA
// rank r takes kk in [kl r / C, kl (r + 1) / C).  x_window[2 b] and
// x_window[2 b + 1] bound the columns block b's cells read (host-built,
// lo a multiple of 4); the CTA stages up to `window` of them.  Dynamic
// shared memory: the ring, the (64 x 128) tile, then the x window.
template <typename T>
__global__ void __launch_bounds__(kCwLanes + kWarp)
    cw_merged_kernel(const T* __restrict__ value,
                     const int* __restrict__ local_index,
                     const int* __restrict__ anchor4,
                     const int* __restrict__ x_window, int d, int cap,
                     int pool_per_block, int stages, int window,
                     int64_t num_rows, int64_t num_columns,
                     const T* __restrict__ x, T* __restrict__ y,
                     bool accumulate) {
  extern __shared__ __align__(128) unsigned char cw_stream_smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ __align__(8) uint64_t staged;
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int64_t b = blockIdx.x / C;
  const int lvl_per = kMergedRows * cap;
  const int kl = lvl_per + pool_per_block;
  const int k0 = kl * rank / C;
  const int n = kl * (rank + 1) / C - k0;
  const int64_t first = b * kl + k0;        // the CTA's first chunk
  const CwRing<T, false> ring{cw_stream_smem, kCwLanes};
  T* tile =
      reinterpret_cast<T*>(cw_stream_smem + stages * ring.stage_bytes());
  T* xs = tile + kMergedRows * kCwLanes;
  // the staged x window: whole 16-byte pieces of x[lo, hi) below
  // num_columns, at most `window` elements (none if x is not aligned)
  const int64_t lo = x_window[2 * b];
  const int64_t hi = min64(x_window[2 * b + 1], num_columns);
  constexpr int kPiece = 16 / sizeof(T);
  int len = hi > lo ? static_cast<int>(min64(hi - lo, window)) : 0;
  len = len / kPiece * kPiece;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0) len = 0;
  const int t = threadIdx.x;
  if (t == 0) mbar_init(&staged, 1);
  ring_init(full, empty, stages, kCwLanes);

  if (t >= kCwLanes) {
    if (t == kCwLanes) {
      if (len > 0) {
        mbar_expect_tx(&staged, len * sizeof(T));
        bulk_copy(xs, x + lo, len * sizeof(T), &staged, l2_evict_last());
      }
      if (accumulate)
        prefetch_rows(C, rank, kMergedRows, kCwLanes, b * kMergedRows, 0,
                      num_rows, y);
      produce(ring, full, empty, stages, value, local_index,
              static_cast<const int*>(nullptr), first, n, 0);
    }
  } else {
    for (int r = 0; r < kMergedRows; ++r) tile[r * kCwLanes + t] = T(0);
    if (len > 0) mbar_wait(&staged, 0);
    const int wmask = 8 * d - 1;
    const int batch = min(kBatch, stages);
    for (int q = 0; q < n; q += batch) {
      const int u = min(batch, n - q);
      int a4[kBatch], loc[kBatch][kCwSlots];
      T val[kBatch][kCwSlots];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i < u) {
          a4[i] = __ldg(anchor4 + first + q + i);
          const int s = (q + i) % stages;
          mbar_wait(&full[s], ((q + i) / stages) & 1);
          const T* sv = ring.value(s);
          const int* si = ring.index(s);
#pragma unroll
          for (int j = 0; j < kCwSlots; ++j) {
            loc[i][j] = si[j * kCwLanes + t];
            val[i][j] = sv[j * kCwLanes + t];
          }
        }
      }
      release(empty, q, u, stages);
      T p[kBatch][kCwSlots];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i < u) {
#pragma unroll
          for (int j = 0; j < kCwSlots; ++j)
            p[i][j] = val[i][j] * cw_x_staged(x, xs, lo, len, num_columns,
                                              a4[i], d,
                                              (loc[i][j] >> 7) & wmask,
                                              loc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int kk = k0 + q + i;
        if (i < u && kk < lvl_per) {
          T strip = T(0);
#pragma unroll
          for (int j = 0; j < kCwSlots; ++j) strip += p[i][j];
          tile[(kk / cap) * kCwLanes + t] += strip;
        } else if (i < u) {
#pragma unroll
          for (int j = 0; j < kCwSlots; ++j) {
            const int r = loc[i][j] >> 14;
            if (r < kMergedRows) tile[r * kCwLanes + t] += p[i][j];
          }
        }
      }
    }
  }
  cluster_sync(cl);
  if (t < kCwLanes)
    write_rows(cl, tile, kMergedRows, kCwLanes, t, b * kMergedRows, 0,
               num_rows, y, accumulate);
  cluster_sync(cl);     // no CTA leaves while another reads its tile
}

// K3b: grid (num_blocks * C, 128 / lanes), clusters of C CTAs along x,
// `lanes` consumer threads and one producer warp a CTA: output block b,
// lanes blockIdx.y * lanes + [0, lanes).  Block b's chunks are
// [block_ptr[b], block_ptr[b + 1]); CTA rank r takes the r-th of C
// contiguous ranges.  Dynamic shared memory: the ring, then the
// (out_rows x lanes) tile.
template <typename T>
__global__ void __launch_bounds__(kCwLanes + kWarp)
    cw_pool_kernel(const T* __restrict__ value,
                   const int* __restrict__ local_index,
                   const int* __restrict__ anchor4,
                   const int* __restrict__ rowmap,
                   const int* __restrict__ block_ptr, int d, int out_rows,
                   int lanes, int stages, int64_t num_rows,
                   int64_t num_columns, const T* __restrict__ x,
                   T* __restrict__ y, bool accumulate) {
  extern __shared__ __align__(128) unsigned char cw_stream_smem[];
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  cg::cluster_group cl = cg::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int64_t b = blockIdx.x / C;
  const int l0 = blockIdx.y * lanes;
  const int begin = block_ptr[b];
  const int count = block_ptr[b + 1] - begin;
  const int q0 = count * rank / C;
  const int n = count * (rank + 1) / C - q0;
  const int64_t first = static_cast<int64_t>(begin) + q0;
  const int64_t base_group = b * out_rows;
  const CwRing<T, true> ring{cw_stream_smem, lanes};
  T* tile =
      reinterpret_cast<T*>(cw_stream_smem + stages * ring.stage_bytes());
  const int t = threadIdx.x;
  ring_init(full, empty, stages, lanes);

  if (t >= lanes) {
    if (t == lanes) {
      if (accumulate)
        prefetch_rows(C, rank, out_rows, lanes, base_group, l0, num_rows, y);
      produce(ring, full, empty, stages, value, local_index, rowmap, first, n,
              l0);
    }
  } else {
    for (int r = 0; r < out_rows; ++r) tile[r * lanes + t] = T(0);
    const int batch = min(kBatch, stages);
    for (int q = 0; q < n; q += batch) {
      const int u = min(batch, n - q);
      int a4[kBatch], loc[kBatch][kCwSlots], rel[kBatch][kCwSlots];
      T val[kBatch][kCwSlots];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i < u) {
          a4[i] = __ldg(anchor4 + first + q + i);
          const int s = (q + i) % stages;
          mbar_wait(&full[s], ((q + i) / stages) & 1);
          const T* sv = ring.value(s);
          const int* si = ring.index(s);
          const int* sr = ring.rowmap(s);
#pragma unroll
          for (int j = 0; j < kCwSlots; ++j) {
            loc[i][j] = si[j * lanes + t];
            val[i][j] = sv[j * lanes + t];
            rel[i][j] = static_cast<int>(sr[j * lanes + t] - base_group);
          }
        }
      }
      release(empty, q, u, stages);
      T p[kBatch][kCwSlots];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i < u) {
#pragma unroll
          for (int j = 0; j < kCwSlots; ++j)
            p[i][j] = val[i][j] * cw_x(x, num_columns, a4[i], d,
                                       loc[i][j] >> 7, loc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (i < u) {
#pragma unroll
          for (int j = 0; j < kCwSlots; ++j) {
            if (static_cast<unsigned>(rel[i][j]) <
                static_cast<unsigned>(out_rows))
              tile[rel[i][j] * lanes + t] += p[i][j];
          }
        }
      }
    }
  }
  cluster_sync(cl);
  if (t < lanes)
    write_rows(cl, tile, out_rows, lanes, t, base_group, l0, num_rows, y,
               accumulate);
  cluster_sync(cl);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, typename IdxT>
cudaError_t level_index(const void* value, const void* local_index,
                        const void* anchor4, const void* group_ptr, int d,
                        int64_t num_groups, int64_t num_rows,
                        int64_t num_columns, const void* x, void* y,
                        bool accumulate, cudaStream_t stream) {
  constexpr int threads = 256;
  const int64_t blocks = (num_groups * kCwLanes + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  cw_level_kernel<T, IdxT>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
          static_cast<const T*>(value),
          static_cast<const IdxT*>(local_index),
          static_cast<const int*>(anchor4),
          static_cast<const int*>(group_ptr), d, num_groups, num_rows,
          num_columns, static_cast<const T*>(x), static_cast<T*>(y),
          accumulate);
  return cudaGetLastError();
}

template <typename T>
cudaError_t level(const void* value, const void* local_index,
                  int index_bits, const void* anchor4, const void* group_ptr,
                  int d, int64_t num_groups, int64_t num_rows,
                  int64_t num_columns, const void* x, void* y,
                  bool accumulate, cudaStream_t stream) {
  if (index_bits == 16)
    return level_index<T, int16_t>(value, local_index, anchor4, group_ptr,
                                   d, num_groups, num_rows, num_columns, x,
                                   y, accumulate, stream);
  if (index_bits == 32)
    return level_index<T, int>(value, local_index, anchor4, group_ptr, d,
                               num_groups, num_rows, num_columns, x, y,
                               accumulate, stream);
  return cudaErrorInvalidValue;
}

// The host's plan must be one the kernels take: a cluster of 1, 2 or 4
// CTAs, 2 .. kMaxStages stages, 32, 64 or 128 lanes, bulk-copy sources
// 16-byte aligned, a grid within bounds.
bool plan_ok(int64_t num_blocks, int cluster, int stages, int lanes) {
  return (cluster == 1 || cluster == 2 || cluster == 4) && stages >= 2 &&
         stages <= kMaxStages &&
         (lanes == 32 || lanes == 64 || lanes == 128) &&
         num_blocks * cluster <= 0x7fffffff;
}

// Launch with clusters of `cluster` CTAs along x and `smem` bytes of
// dynamic shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid, int threads,
                            size_t smem, int cluster, cudaStream_t stream,
                            Args... args) {
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t pool(const void* value, const void* local_index,
                 const void* anchor4, const void* rowmap,
                 const void* block_ptr, int d, int out_rows,
                 int64_t num_blocks, int64_t num_rows, int64_t num_columns,
                 const void* x, void* y, bool accumulate, int lanes,
                 int stages, int cluster, cudaStream_t stream) {
  if (num_blocks == 0) return cudaSuccess;
  if (!plan_ok(num_blocks, cluster, stages, lanes) || out_rows <= 0 ||
      !aligned16(value) || !aligned16(local_index) || !aligned16(rowmap))
    return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(stages) * kCwSlots * lanes *
          CwRing<T, true>::kPerCell +
      static_cast<size_t>(out_rows) * lanes * sizeof(T);
  const dim3 grid(static_cast<unsigned>(num_blocks * cluster),
                  kCwLanes / lanes);
  return launch_clusters(
      cw_pool_kernel<T>, grid, lanes + kWarp, smem, cluster, stream,
      static_cast<const T*>(value), static_cast<const int*>(local_index),
      static_cast<const int*>(anchor4), static_cast<const int*>(rowmap),
      static_cast<const int*>(block_ptr), d, out_rows, lanes, stages,
      num_rows, num_columns, static_cast<const T*>(x), static_cast<T*>(y),
      accumulate);
}

template <typename T>
cudaError_t merged(const void* value, const void* local_index,
                   const void* anchor4, const void* x_window, int d, int cap,
                   int pool_per_block, int64_t num_blocks, int64_t num_rows,
                   int64_t num_columns, const void* x, void* y,
                   bool accumulate, int stages, int window, int cluster,
                   cudaStream_t stream) {
  if (num_blocks == 0) return cudaSuccess;
  if (!plan_ok(num_blocks, cluster, stages, kCwLanes) || cap <= 0 ||
      pool_per_block < 0 || window < 0 || !aligned16(value) ||
      !aligned16(local_index))
    return cudaErrorInvalidValue;
  const size_t smem =
      static_cast<size_t>(stages) * kCwChunk * CwRing<T, false>::kPerCell +
      (static_cast<size_t>(kMergedRows) * kCwLanes + window) * sizeof(T);
  const dim3 grid(static_cast<unsigned>(num_blocks * cluster));
  return launch_clusters(
      cw_merged_kernel<T>, grid, kCwLanes + kWarp, smem, cluster, stream,
      static_cast<const T*>(value), static_cast<const int*>(local_index),
      static_cast<const int*>(anchor4), static_cast<const int*>(x_window), d,
      cap, pool_per_block, stages, window, num_rows, num_columns,
      static_cast<const T*>(x), static_cast<T*>(y), accumulate);
}

}  // namespace
}  // namespace spmv_tpu_torch

// Each returns the cudaError_t of the launch (0 on success; invalid
// value for a plan the kernels do not take).  dtype is kFloat32 or
// kFloat64 (dia_common.cuh); every index array is int32 but K3a's
// local_index, int16 with index_bits 16.  K3b and K3c take the host's
// plan (ops/wellcw_kernels.py):
// `lanes` of a pool CTA, the ring's `stages`, K3c's x `window`
// (elements) and the `cluster` size.

extern "C" int wellcw_level_launch(int dtype, int device, const void* value,
                                   const void* local_index, int index_bits,
                                   const void* anchor4,
                                   const void* group_ptr, int d,
                                   long long num_groups, long long num_rows,
                                   long long num_columns, const void* x,
                                   void* y, int accumulate, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return level<float>(value, local_index, index_bits, anchor4,
                          group_ptr, d, num_groups, num_rows, num_columns, x,
                          y, accumulate != 0, s);
    case kFloat64:
      return level<double>(value, local_index, index_bits, anchor4,
                           group_ptr, d, num_groups, num_rows, num_columns,
                           x, y, accumulate != 0, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int wellcw_pool_launch(int dtype, int device, const void* value,
                                  const void* local_index,
                                  const void* anchor4, const void* rowmap,
                                  const void* block_ptr, int d, int out_rows,
                                  long long num_blocks, long long num_rows,
                                  long long num_columns, const void* x,
                                  void* y, int accumulate, int lanes,
                                  int stages, int cluster, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return pool<float>(value, local_index, anchor4, rowmap, block_ptr, d,
                         out_rows, num_blocks, num_rows, num_columns, x, y,
                         accumulate != 0, lanes, stages, cluster, s);
    case kFloat64:
      return pool<double>(value, local_index, anchor4, rowmap, block_ptr, d,
                          out_rows, num_blocks, num_rows, num_columns, x, y,
                          accumulate != 0, lanes, stages, cluster, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int wellcw_merged_launch(int dtype, int device, const void* value,
                                    const void* local_index,
                                    const void* anchor4,
                                    const void* x_window, int d, int cap,
                                    int pool_per_block, long long num_blocks,
                                    long long num_rows, long long num_columns,
                                    const void* x, void* y, int accumulate,
                                    int stages, int window, int cluster,
                                    void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return merged<float>(value, local_index, anchor4, x_window, d, cap,
                           pool_per_block, num_blocks, num_rows, num_columns,
                           x, y, accumulate != 0, stages, window, cluster, s);
    case kFloat64:
      return merged<double>(value, local_index, anchor4, x_window, d, cap,
                            pool_per_block, num_blocks, num_rows,
                            num_columns, x, y, accumulate != 0, stages,
                            window, cluster, s);
    default:
      return cudaErrorInvalidValue;
  }
}

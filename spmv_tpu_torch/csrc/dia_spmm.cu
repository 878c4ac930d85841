// Kernel K2: DIA SpMM, Y = A X for k right-hand sides.
//
// Replaces the Pallas kernel _dia_spmm_kernel
// (spmv_tpu/ops/pallas_kernels.py, def at line 710, launched by
// dia_spmm_core).  X is (num_columns, k) and Y is (num_rows, k), both
// row-major, so one row's k values are contiguous.
//
//   Y[i, c] = sum_d data[d * num_rows + i] * X[i + offsets[d], c]
//
// diagonals added in ascending d, a column i + offsets[d] outside
// [0, num_columns) skipped, acc += a * x (one fused multiply-add a term,
// as K1), so a column of Y is bitwise K1's SpMV of that column of X.
//
// What bounds it on an H100: bytes.  A row reads D diagonal values, D
// shifted rows of X and writes one row of Y for 2 D k flops; the diagonal
// stream is shared by all k columns, and the shifted rows of X come again
// from the L2 for each diagonal, so device memory sees data, X and Y
// about once each.  What holds a loop of k scalar loads a diagonal back
// (a thread a row, rows k * sizeof(T) bytes apart across a warp) is the
// load/store unit: every warp instruction touches 32 sectors for 4 bytes
// of each.
//
// Two paths, chosen by the host (dia_spmm_plan in ops/dia_kernels.py)
// from k, the dtype and X's and Y's alignment: the row path where a row
// is one or two 16-byte groups and both are aligned, the slab path
// elsewhere (on an H100 the faster of the two at each shape measured,
// PERF.md §6).
//
// - "row" (k = G V for G = 1 or 2, V = 16 / sizeof(T), X and Y 16-byte
//   aligned).  A thread owns a row, k a template constant, and loads its
//   G groups straight from device memory with G 16-byte ld.global a
//   diagonal; the rows of X the other diagonals read again come from L1
//   and L2.  Y is written 16 bytes at a time.
// - "slab" (any k, any alignment).  A thread owns one group of V columns
//   (G = ceil(k / V) groups a row) of R = 4 rows a pass apart; a unit is
//   a tile of B = R 256 / G rows, or for G > 256 one row and a chunk of
//   256 V columns (R = 1).  For each unit and each window of diagonals
//   (the consecutive diagonals whose offsets lie within 256 / G rows of
//   the window's first, at most kMaxWindowDiags of them), the rows of X
//   the window reads, X[i0 + off_first : i0 + off_last + B, :], are one
//   contiguous run of bytes, and so is data[d, i0 : i0 + B] for each of
//   its diagonals.  One producer thread streams them into shared memory
//   with bulk asynchronous copies (cp.async.bulk, completing on an
//   mbarrier), a ring of stages ahead of the consumers, aligned down and
//   up to 16 bytes so that any k and any start address copy whole; the
//   threads read their rows' values from shared memory (16-byte loads
//   where k * sizeof(T) and X allow it) and keep their R V sums in
//   registers across the unit's windows.  CTAs are persistent: each walks
//   units gridDim.x apart, so the next unit's copies overlap this one's
//   sums.  Y is written from registers, 16 bytes a thread where aligned.
//
// Bounds checks on i + offset replace the TPU's zero-padded layout; Y
// never aliases X (blocks run in no order).

#include "dia_common.cuh"
#include "mbarrier.cuh"

namespace spmv_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kMaxStages = 8;
constexpr int kMaxWindowDiags = 8;

// The path codes the wrapper passes (DIA_SPMM_PATHS in dia_kernels.py).
enum DiaSpmmPath : int { kSlab = 0, kRow = 1 };

// Rows a slab thread owns, a pass apart (SLAB_PASSES in dia_kernels.py).
constexpr int kSlabPasses = 4;

template <typename T>
__host__ __device__ constexpr int vec_width() {
  return 16 / static_cast<int>(sizeof(T));
}

// V values of T from 16 aligned bytes.
template <typename T, typename Acc>
__device__ __forceinline__ void unpack16(uint4 raw, Acc* out) {
  constexpr int V = vec_width<T>();
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int c = 0; c < V; ++c) out[c] = to_acc<Acc>(v[c]);
}

template <typename T, typename Acc>
__device__ __forceinline__ uint4 pack16(const Acc* acc) {
  constexpr int V = vec_width<T>();
  uint4 raw;
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int c = 0; c < V; ++c) v[c] = from_acc<T>(acc[c]);
  return raw;
}

// ---------------------------------------------------------------- slab

// The host's plan of a slab launch (dia_spmm_plan).
struct SlabPlan {
  int64_t num_rows, num_columns;
  int k, num_diagonals;
  int rows;           // B: rows a unit, R 256 / groups (R = 1 in chunks)
  int chunk_cols;     // columns a unit: k, or 256 V past 256 groups
  int chunks;         // units a tile of rows
  int stages;         // ring stages
  int span;           // a window's offsets lie within this many rows
                      // of its first (-1: one diagonal a window)
  int max_span;       // off_last - off_first of a window, at most
  int wdiags;         // diagonals of a window, at most
  int x_stage_bytes;  // X bytes a stage holds (a multiple of 16)
  int d_stage_bytes;  // bytes of one diagonal's data a stage holds

  __host__ __device__ int stage_bytes() const {
    return x_stage_bytes + wdiags * d_stage_bytes;
  }
};

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ uintptr_t down16(uintptr_t a) {
  return a & ~uintptr_t(15);
}
__device__ __forceinline__ uintptr_t up16(uintptr_t a) {
  return (a + 15) & ~uintptr_t(15);
}

// A unit: its rows [i0, i0 + rows_here) and columns [c0, c0 + cc).
struct Unit {
  int64_t i0;
  int rows_here, c0, cc;

  __device__ Unit(const SlabPlan& p, int u) {
    int tile = u, chunk = 0;
    if (p.chunks > 1) {
      tile = u / p.chunks;
      chunk = u - tile * p.chunks;
    }
    i0 = static_cast<int64_t>(tile) * p.rows;
    rows_here = static_cast<int>(min64(p.rows, p.num_rows - i0));
    c0 = chunk * p.chunk_cols;
    cc = min(p.k - c0, p.chunk_cols);
  }
};

// The rows [lo, hi) of X that a unit's window [dfirst, dlast] reads: one
// run of bytes from xs, copied from xa (xs aligned down to 16).
template <typename T>
struct Slab {
  int64_t lo, hi;
  uintptr_t xs, xa;

  __device__ Slab(const SlabPlan& p, const int* off, const Unit& un,
                  int dfirst, int dlast, const T* X) {
    lo = max64(un.i0 + off[dfirst], 0);
    hi = min64(un.i0 + off[dlast] + un.rows_here, p.num_columns);
    xs = reinterpret_cast<uintptr_t>(X + lo * p.k + un.c0);
    xa = down16(xs);
  }
  __device__ uint32_t bytes(const SlabPlan& p, const Unit& un) const {
    if (hi <= lo) return 0;
    const uintptr_t end =
        xs + (static_cast<uintptr_t>(hi - lo - 1) * p.k + un.cc) * sizeof(T);
    return static_cast<uint32_t>(up16(end) - xa);
  }
};

// data[d, i0 ...]'s first byte
template <typename T>
__device__ __forceinline__ uintptr_t diag_start(const T* data,
                                                const SlabPlan& p,
                                                const Unit& un, int d) {
  return reinterpret_cast<uintptr_t>(data + d * p.num_rows + un.i0);
}

// The producer: unit u's window w into one stage, completing on full.
template <typename T>
__device__ void issue(const SlabPlan& p, const int* off, const int* win,
                      const T* data, const T* X, unsigned char* stage,
                      uint64_t* full, int u, int w, uint64_t x_policy,
                      uint64_t d_policy) {
  const Unit un(p, u);
  const int dfirst = win[w], dlast = win[w + 1] - 1;
  const Slab<T> sl(p, off, un, dfirst, dlast, X);
  const uint32_t xb = sl.bytes(p, un);
  const uint32_t dbytes = un.rows_here * sizeof(T);
  uint32_t total = xb;
  for (int d = dfirst; d <= dlast; ++d) {
    const uintptr_t ds = diag_start(data, p, un, d);
    total += static_cast<uint32_t>(up16(ds + dbytes) - down16(ds));
  }
  mbar_expect_tx(full, total);
  if (xb) bulk_copy(stage, reinterpret_cast<const void*>(sl.xa), xb, full,
                    x_policy);
  unsigned char* dbuf = stage + p.x_stage_bytes;
  for (int d = dfirst; d <= dlast; ++d) {
    const uintptr_t ds = diag_start(data, p, un, d);
    const uintptr_t da = down16(ds);
    bulk_copy(dbuf + (d - dfirst) * p.d_stage_bytes,
              reinterpret_cast<const void*>(da),
              static_cast<uint32_t>(up16(ds + dbytes) - da), full,
              d_policy);
  }
}

// Windows of the diagonals, as the host's dia_spmm_plan draws them: a new
// window where an offset falls, passes the first's by more than `span`
// rows, or the window holds kMaxWindowDiags.  win[0 .. W] are their first
// diagonals, win[W] = D; returns W.
__device__ int draw_windows(const int* off, int D, int span, int* win) {
  int w = 0, first = 0;
  win[0] = 0;
  for (int d = 1; d < D; ++d) {
    if (off[d] < off[d - 1] || off[d] - off[first] > span ||
        d - first >= kMaxWindowDiags) {
      win[++w] = d;
      first = d;
    }
  }
  win[++w] = D;
  return D > 0 ? w : 0;
}

template <typename T, typename Acc, bool Vec, int R>
__global__ void __launch_bounds__(kThreads)
    dia_spmm_slab_kernel(SlabPlan p, const T* __restrict__ data,
                         const int* __restrict__ offsets,
                         const T* __restrict__ X, T* __restrict__ Y) {
  constexpr int V = vec_width<T>();
  extern __shared__ __align__(128) unsigned char dia_spmm_smem[];
  const int S = p.stages;
  const int stage_bytes = p.stage_bytes();
  unsigned char* ring = dia_spmm_smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * stage_bytes);
  uint64_t* empty = full + S;
  int* off = reinterpret_cast<int*>(empty + S);
  int* win = off + p.num_diagonals;
  __shared__ int num_windows;

  const int t = threadIdx.x;
  for (int d = t; d < p.num_diagonals; d += kThreads) off[d] = offsets[d];
  __syncthreads();
  if (t == 0) {
    num_windows = draw_windows(off, p.num_diagonals, p.span, win);
    // the host sized the stages for its own windows: these must be them
    for (int w = 0; w < num_windows; ++w)
      if (off[win[w + 1] - 1] - off[win[w]] > p.max_span ||
          win[w + 1] - win[w] > p.wdiags)
        __trap();
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads / kWarp);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int W = num_windows;
  const int units =
      static_cast<int>((p.num_rows + p.rows - 1) / p.rows) * p.chunks;
  // groups a row of a unit; this thread's row and group
  const int gpr = p.chunks > 1 ? kThreads : (p.k + V - 1) / V;
  const int pass = kThreads / gpr;  // rows a pass; the thread's rows are
  const int r = t / gpr;            // r, r + pass, ... (R of them), and
                                    // no row where r >= pass
  const int col = (t % gpr) * V;    // the group's first column in the unit
  if (W == 0) {
    // no diagonal: every row of Y is zero
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit un(p, u);
      for (int q = 0; q < R && r < pass; ++q) {
        const int rq = r + q * pass;
        if (rq >= un.rows_here) continue;
        T* yr = Y + (un.i0 + rq) * p.k + un.c0;
        for (int c = col; c < min(col + V, un.cc); ++c)
          yr[c] = from_acc<T>(Acc(0));
      }
    }
    return;
  }
  // data streams through once; the rows of X come again from the L2 for
  // the unit's other windows and its neighbours'
  const uint64_t x_policy = l2_evict_normal();
  const uint64_t d_policy = l2_evict_first();
  // the producer's cursor: the next unit and window to copy
  int pu = blockIdx.x, pw = 0;
  auto produce = [&](int stage) {
    issue(p, off, win, data, X, ring + stage * stage_bytes, &full[stage],
          pu, pw, x_policy, d_policy);
    if (++pw == W) {
      pw = 0;
      pu += gridDim.x;
    }
  };
  if (t == 0)
    for (int s = 0; s < S && pu < units; ++s) produce(s);

  int s = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit un(p, u);
    const bool active = r < pass && r < un.rows_here && col < un.cc;
    Acc acc[R][V];
#pragma unroll
    for (int q = 0; q < R; ++q)
#pragma unroll
      for (int c = 0; c < V; ++c) acc[q][c] = Acc(0);
    for (int w = 0; w < W; ++w) {
      const int dfirst = win[w], dlast = win[w + 1] - 1;
      const unsigned char* stage = ring + s * stage_bytes;
      mbar_wait(&full[s], phase);
      if (active) {
        const Slab<T> sl(p, off, un, dfirst, dlast, X);
        const T* xrows = reinterpret_cast<const T*>(stage + (sl.xs - sl.xa));
        for (int d = dfirst; d <= dlast; ++d) {
          const uintptr_t ds = diag_start(data, p, un, d);
          const T* dv = reinterpret_cast<const T*>(
              stage + p.x_stage_bytes + (d - dfirst) * p.d_stage_bytes +
              (ds - down16(ds)));
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int rq = r + q * pass;
            const int64_t j = un.i0 + rq + off[d];
            if (rq >= un.rows_here || j < 0 || j >= p.num_columns) continue;
            const Acc a = to_acc<Acc>(dv[rq]);
            const T* xr = xrows + (j - sl.lo) * p.k + col;
            if (Vec) {
              Acc xv[V];
              unpack16<T, Acc>(*reinterpret_cast<const uint4*>(xr), xv);
#pragma unroll
              for (int c = 0; c < V; ++c) acc[q][c] += a * xv[c];
            } else {
#pragma unroll
              for (int c = 0; c < V; ++c)
                if (col + c < un.cc) acc[q][c] += a * to_acc<Acc>(xr[c]);
            }
          }
        }
      }
      __syncwarp();
      if (t % kWarp == 0) mbar_arrive(&empty[s]);
      if (t == 0 && pu < units) {
        // every warp is done with this stage: refill it, S items ahead
        mbar_wait(&empty[s], phase);
        produce(s);
      }
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
    if (active) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int rq = r + q * pass;
        if (rq >= un.rows_here) continue;
        T* yr = Y + (un.i0 + rq) * p.k + un.c0 + col;
        if (Vec) {
          *reinterpret_cast<uint4*>(yr) = pack16<T, Acc>(acc[q]);
        } else {
#pragma unroll
          for (int c = 0; c < V; ++c)
            if (col + c < un.cc) yr[c] = from_acc<T>(acc[q][c]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- row

// A thread a row of G groups: G 16-byte loads a diagonal.
template <typename T, typename Acc, int G>
__global__ void __launch_bounds__(kThreads)
    dia_spmm_row_kernel(const T* __restrict__ data,
                        const int* __restrict__ offsets, int num_diagonals,
                        int64_t num_rows, int64_t num_columns,
                        const T* __restrict__ X, T* __restrict__ Y) {
  constexpr int V = vec_width<T>();
  constexpr int k = G * V;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= num_rows) return;
  Acc acc[G][V];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int c = 0; c < V; ++c) acc[g][c] = Acc(0);
  for (int d = 0; d < num_diagonals; ++d) {
    const int64_t j = i + __ldg(offsets + d);
    if (j < 0 || j >= num_columns) continue;
    const Acc a = to_acc<Acc>(data[static_cast<int64_t>(d) * num_rows + i]);
    const uint4* xr = reinterpret_cast<const uint4*>(X + j * k);
    uint4 raw[G];
#pragma unroll
    for (int g = 0; g < G; ++g) raw[g] = __ldg(xr + g);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      Acc xv[V];
      unpack16<T, Acc>(raw[g], xv);
#pragma unroll
      for (int c = 0; c < V; ++c) acc[g][c] += a * xv[c];
    }
  }
  uint4* yr = reinterpret_cast<uint4*>(Y + i * k);
#pragma unroll
  for (int g = 0; g < G; ++g) yr[g] = pack16<T, Acc>(acc[g]);
}

// ---------------------------------------------------------------- launch

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 0;
  if (cached[device] == 0)
    cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount,
                           device);
  return cached[device];
}

// The dynamic shared memory of a slab launch: the ring, its barriers, the
// D offsets and the windows' W + 1 <= D + 2 bounds (two for D = 0).
size_t slab_smem(const SlabPlan& p) {
  return static_cast<size_t>(p.stages) * p.stage_bytes() +
         2 * p.stages * sizeof(uint64_t) +
         (2 * static_cast<size_t>(p.num_diagonals) + 2) * sizeof(int);
}

template <typename T, typename Acc, bool Vec, int R>
cudaError_t launch_slab(const SlabPlan& p, const void* data,
                        const void* offsets, const void* X, void* Y,
                        int device, cudaStream_t stream) {
  auto kernel = dia_spmm_slab_kernel<T, Acc, Vec, R>;
  const size_t smem = slab_smem(p);
  static size_t attr_smem = 48 * 1024;
  if (smem > attr_smem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    attr_smem = smem;
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const int64_t tiles = (p.num_rows + p.rows - 1) / p.rows;
  const int64_t units = tiles * p.chunks;
  const int64_t grid =
      min64(units, static_cast<int64_t>(per_sm) * sm_count(device));
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      p, static_cast<const T*>(data), static_cast<const int*>(offsets),
      static_cast<const T*>(X), static_cast<T*>(Y));
  return cudaGetLastError();
}

template <typename T, typename Acc, int G>
cudaError_t launch_row(const SlabPlan& p, const void* data,
                       const void* offsets, const void* X, void* Y,
                       cudaStream_t stream) {
  const int64_t blocks = (p.num_rows + kThreads - 1) / kThreads;
  dia_spmm_row_kernel<T, Acc, G>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(data), static_cast<const int*>(offsets),
          p.num_diagonals, p.num_rows, p.num_columns,
          static_cast<const T*>(X), static_cast<T*>(Y));
  return cudaGetLastError();
}

template <typename T, typename Acc>
cudaError_t launch(int path, const SlabPlan& p, const void* data,
                   const void* offsets, const void* X, void* Y, int device,
                   cudaStream_t stream) {
  constexpr int V = vec_width<T>();
  if (p.num_rows == 0 || p.k == 0) return cudaSuccess;
  const bool aligned = p.k % V == 0 && aligned16(X) && aligned16(Y);
  if (path == kRow) {
    if (!aligned) return cudaErrorInvalidValue;
    if (p.k == V) return launch_row<T, Acc, 1>(p, data, offsets, X, Y, stream);
    if (p.k == 2 * V)
      return launch_row<T, Acc, 2>(p, data, offsets, X, Y, stream);
    return cudaErrorInvalidValue;
  }
  // units count in 32 bits; a unit is R passes of whole rows, or a chunk
  const int gpr = p.chunks > 1 ? kThreads : (p.k + V - 1) / V;
  const int R = p.chunks > 1 ? 1 : kSlabPasses;
  if (path != kSlab || p.stages < 2 || p.stages > kMaxStages ||
      p.rows != R * (kThreads / gpr) || p.chunk_cols <= 0 ||
      p.chunks <= 0 || p.wdiags < 1 || p.wdiags > kMaxWindowDiags ||
      p.x_stage_bytes % 16 || p.d_stage_bytes % 16 ||
      (p.num_rows + p.rows - 1) / p.rows * p.chunks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // 16-byte shared-memory loads only where every slab starts aligned
  if (R == 1)
    return aligned ? launch_slab<T, Acc, true, 1>(p, data, offsets, X, Y,
                                                  device, stream)
                   : launch_slab<T, Acc, false, 1>(p, data, offsets, X, Y,
                                                   device, stream);
  return aligned ? launch_slab<T, Acc, true, kSlabPasses>(
                       p, data, offsets, X, Y, device, stream)
                 : launch_slab<T, Acc, false, kSlabPasses>(
                       p, data, offsets, X, Y, device, stream);
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launch (0 on success).  `path` is
// kSlab (0) or kRow (1); the slab plan's numbers come from the host's
// dia_spmm_plan (ignored on the row path).
extern "C" int dia_spmm_launch(int dtype, int device, const void* data,
                               const void* offsets, int num_diagonals,
                               long long num_rows, long long num_columns,
                               int k, const void* X, void* Y, int path,
                               int rows, int chunk_cols, int chunks,
                               int stages, int span, int max_span,
                               int wdiags, int x_stage_bytes,
                               int d_stage_bytes, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SlabPlan p{num_rows, num_columns,   k,            num_diagonals,
                   rows,     chunk_cols,    chunks,       stages,
                   span,     max_span,      wdiags,       x_stage_bytes,
                   d_stage_bytes};
  switch (dtype) {
    case kFloat32:
      return launch<float, float>(path, p, data, offsets, X, Y, device, s);
    case kFloat64:
      return launch<double, double>(path, p, data, offsets, X, Y, device, s);
    case kBFloat16:
      return launch<__nv_bfloat16, float>(path, p, data, offsets, X, Y,
                                          device, s);
    default:
      return cudaErrorInvalidValue;
  }
}

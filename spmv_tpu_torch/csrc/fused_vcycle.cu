// Kernel K8: one whole block smoothed-aggregation AMG V-cycle, y = M^-1 b,
// in a single launch.
//
// Replaces the Pallas kernel _fused_kernel (spmv_tpu/ops/fused_vcycle.py,
// def at line 297, pallas_call at line 372), launched by
// fused_vcycle_core (spmv_tpu_torch/ops/fused_vcycle.py).  Its plain
// version is fused_vcycle_reference there.
//
// At level l (n_l rows, D_l diagonals in natural-order DIA, n_{l+1} =
// n_l / block), with the Chebyshev smoother of ops/amg.py _cheb_smooth:
//   pre-smooth from x = 0, r = b - A x, if smoothed r -= omega A (dinv r),
//   restrict (the sum of each run of `block` rows times wscale), recurse,
//   prolong (repeat times wscale; if smoothed y0 -= omega dinv A y0),
//   x += y0, post-smooth.  The coarsest level is y = Cinv b, dense.
//
// What bounds it on an H100: bytes.  Every step is a DIA matvec (2 flops a
// value read) or an axpy.  The least the card could move is each input
// once: the levels' diagonals, dinv, Cinv, b, and y once (about 235 MB at
// poisson2d(2048^2) in float32, 0.070 ms at 3.35 TB/s).  The algorithm
// itself reads each level again for each of its matvecs (8 at a smoothed
// level, 6 at a plain one, degree 3), so its own traffic is several times
// that bound.
//
// The simple design: a cooperative persistent kernel.  The grid is as many
// blocks as can be co-resident (the occupancy calculator times the SMs: one
// block of 1,024 threads an SM), launched with cudaLaunchCooperativeKernel,
// which refuses a grid that could not all be resident.  Each step of the
// cycle is a grid-stride loop over rows, one thread a row; a grid-wide
// barrier separates dependent steps: 9 at a smoothed level, 8 at a plain
// one, one after the coarse solve (58 at poisson2d(2048^2)).  The barrier
// is written here (an arrival counter and a generation word, with
// __threadfence), so the file needs no relocatable device code.
//
// Why a barrier step costs what it does: every block's arrival makes a
// round trip through L2, and, at the coarse levels (a few thousand rows), a
// step is one thread's chain of dependent loads while the other threads
// wait at the barrier.  So a step costs memory latency, not bandwidth:
// measured on an H100, K8 took 1.76 ms at poisson2d(2048^2) in float32
// with one load in flight a thread and 4 blocks of 256 threads an SM, 1.29
// ms with the loads of 8 diagonals in flight (dia_row) and the restriction
// spread over fine rows, 1.25 ms with 1,024-thread blocks (fewer arrivals);
// spinning without __nanosleep changed nothing.  Keeping the coarse levels
// inside one block or cluster, with fewer barriers, is later work.
//
// Steps fused so that no vector is written only to be read back by the
// same row: the matvec with its vector update; the restriction with the
// last residual or composition matvec (one thread a fine row, a segmented
// warp shuffle summing each coarse row's `block` fine rows; one thread a
// coarse row where `block` does not divide 32); the prolongation reads the
// coarse vector directly.
// The pre-smoother starts from x = 0, so its first residual is dinv * b
// (A 0 = 0); the smoother's last step adds p to x and needs no matvec.
// The p update writes a second buffer (q), since neighbours still read p.
//
// The coarse solve is part of K8's body: one warp a row of Cinv, a fixed
// shuffle tree.  There are no atomics on data, so every sum runs in a fixed
// order and two launches are bitwise equal.  The Chebyshev scalars come in
// as float64 and are rounded to T once; vectors written within the launch
// are read with plain loads (never the read-only path), the matrix with
// __ldg.
#include <cuda_runtime.h>

#include <cstdint>

namespace spmv_tpu_torch {
namespace {

constexpr int kMaxLevels = 12;   // MAX_LEVELS in ops/fused_vcycle.py
constexpr int kMaxDegree = 8;    // MAX_DEGREE
constexpr int kThreads = 1024;   // THREADS_PER_BLOCK
constexpr int kPtrs = 8;         // pointers a level in the host table
constexpr int kInts = 4;
constexpr int kScalars = 3 + 2 * kMaxDegree;

template <typename T>
struct Level {
  const T* data;     // (D, n): data[k * n + i] = A[i, i + offs[k]]
  const int* offs;   // (D,)
  const T* dinv;     // (n,)
  T* b;              // right-hand side at this level
  T* x;              // solution at this level
  T* r;
  T* p;
  T* q;
  int n;
  int D;
  int smoothed;
  T omega, wscale, theta;
  T c1[kMaxDegree], c2[kMaxDegree];
};

template <typename T>
struct Params {
  Level<T> lv[kMaxLevels];
  const T* cinv;     // (nc, nc), row-major
  T* bc;             // coarse right-hand side
  T* xc;             // coarse solution
  unsigned* bar;     // [0] arrivals, [1] generation
  int nc;
  int levels;
  int degree;
  int block;
};

// Grid-wide barrier for a cooperative launch (every block resident).
// Thread 0 of each block arrives once; the last to arrive resets the
// counter and advances the generation, which the others wait to see.  The
// fences order each block's writes before its arrival and its later reads
// after the release, as cooperative groups' grid sync does.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// Row i of A v, the diagonals in order, v(j) read for 0 <= j < n.  The
// loads of U diagonals are issued before any of their products is added,
// so a thread waits for one memory latency every U diagonals, not every
// one: at the coarse levels a step is a few thousand rows, too few threads
// to hide the latency otherwise.  The sum's order is unchanged.
template <typename T, typename V>
__device__ __forceinline__ T dia_row(const Level<T>& L, int i, V v) {
  constexpr int U = sizeof(T) == 8 ? 4 : 8;
  const int D = L.D, n = L.n;
  const T* d = L.data + i;
  T acc = T(0);
  for (int k0 = 0; k0 < D; k0 += U) {
    T a[U], x[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u;
      const int j = k < D ? i + __ldg(L.offs + k) : -1;
      ok[u] = j >= 0 && j < n;
      if (ok[u]) {
        a[u] = __ldg(d + static_cast<int64_t>(k) * n);
        x[u] = v(j);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ok[u]) acc += a[u] * x[u];
    }
  }
  return acc;
}

// _cheb_smooth at one level: x = 0 on entry when `pre`, else L.x.
template <typename T>
__device__ void smooth(const Level<T>& L, int degree, bool pre, int tid,
                       int stride, unsigned* bar) {
  T* x = L.x;
  for (int i = tid; i < L.n; i += stride) {
    T res;
    if (pre) {
      res = L.b[i];
      x[i] = T(0);
    } else {
      res = L.b[i] - dia_row(L, i, [x](int j) { return x[j]; });
    }
    const T rv = L.dinv[i] * res;
    L.r[i] = rv;
    L.p[i] = rv / L.theta;
  }
  grid_sync(bar);
  T* p = L.p;
  T* q = L.q;
  for (int s = 0; s + 1 < degree; ++s) {
    const bool last = s + 2 == degree;
    const T c1 = L.c1[s], c2 = L.c2[s];
    for (int i = tid; i < L.n; i += stride) {
      const T ap = dia_row(L, i, [p](int j) { return p[j]; });
      const T pi = p[i];
      const T ri = L.r[i] - L.dinv[i] * ap;
      const T qi = c1 * pi + c2 * ri;
      T xi = x[i] + pi;
      if (last) xi = xi + qi;   // the last step: x += p, no matvec
      x[i] = xi;
      L.r[i] = ri;
      q[i] = qi;
    }
    grid_sync(bar);
    T* t = p;
    p = q;
    q = t;
  }
  if (degree == 1) {
    for (int i = tid; i < L.n; i += stride) x[i] = x[i] + p[i];
    grid_sync(bar);
  }
}

// bnext[c] = wscale * (the sum of rs over fine rows c*block .. +block-1),
// rs(i) the restricted residual of fine row i.  When block divides 32, one
// thread a fine row and a segmented shuffle tree (the rows of one coarse
// row are neighbouring lanes of one warp: the grid stride is a multiple of
// 32 and n of block); otherwise one thread a coarse row, in row order.
template <typename T, typename R>
__device__ __forceinline__ void restrict_rows(const Level<T>& L, int block,
                                              T* bnext, int tid, int stride,
                                              R rs) {
  if (32 % block == 0) {
    const int lane = threadIdx.x & 31;
    for (int i0 = tid - lane; i0 < L.n; i0 += stride) {
      const int i = i0 + lane;
      T s = i < L.n ? rs(i) : T(0);
      for (int o = block >> 1; o > 0; o >>= 1) {
        s += __shfl_down_sync(0xffffffffu, s, o, block);
      }
      if (i < L.n && lane % block == 0) bnext[i / block] = s * L.wscale;
    }
  } else {
    for (int c = tid; c < L.n / block; c += stride) {
      T s = T(0);
      for (int k = 0; k < block; ++k) s += rs(c * block + k);
      bnext[c] = s * L.wscale;
    }
  }
}

// bnext = P^T (b - A x).
template <typename T>
__device__ void restrict_residual(const Level<T>& L, int block, T* bnext,
                                  int tid, int stride, unsigned* bar) {
  const T* x = L.x;
  if (L.smoothed) {
    // rs = r - omega A (dinv r): r kept in L.r, dinv r in L.p
    for (int i = tid; i < L.n; i += stride) {
      const T rf = L.b[i] - dia_row(L, i, [x](int j) { return x[j]; });
      L.r[i] = rf;
      L.p[i] = L.dinv[i] * rf;
    }
    grid_sync(bar);
    const T* t = L.p;
    restrict_rows(L, block, bnext, tid, stride, [&L, t](int i) {
      return L.r[i] - L.omega * dia_row(L, i, [t](int j) { return t[j]; });
    });
  } else {
    restrict_rows(L, block, bnext, tid, stride, [&L, x](int i) {
      return L.b[i] - dia_row(L, i, [x](int j) { return x[j]; });
    });
  }
  grid_sync(bar);
}

// x += P xc, P = (I - omega D^-1 A) P0 when smoothed, else P0 (a repeat
// times wscale), y0 read straight from xc.
template <typename T>
__device__ void prolong(const Level<T>& L, int block, const T* xc, int tid,
                        int stride, unsigned* bar) {
  const T w = L.wscale;
  for (int i = tid; i < L.n; i += stride) {
    const T y0 = xc[i / block] * w;
    if (L.smoothed) {
      const T ay = dia_row(L, i, [xc, block, w](int j) {
        return xc[j / block] * w;
      });
      L.x[i] = L.x[i] + (y0 - L.omega * L.dinv[i] * ay);
    } else {
      L.x[i] = L.x[i] + y0;
    }
  }
  grid_sync(bar);
}

// xc = Cinv bc, one warp a row, lanes over columns, a fixed shuffle tree.
template <typename T>
__device__ void coarse_solve(const Params<T>& P, int tid, int stride) {
  const int lane = threadIdx.x & 31;
  for (int row = tid >> 5; row < P.nc; row += stride >> 5) {
    const T* a = P.cinv + static_cast<int64_t>(row) * P.nc;
    T s = T(0);
    for (int c = lane; c < P.nc; c += 32) s += __ldg(a + c) * P.bc[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) P.xc[row] = s;
  }
  grid_sync(P.bar);
}

// One block of 1,024 threads an SM: at most 64 registers a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    fused_vcycle_kernel(const __grid_constant__ Params<T> P) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = gridDim.x * blockDim.x;
  for (int l = 0; l < P.levels; ++l) {
    const Level<T>& L = P.lv[l];
    smooth(L, P.degree, true, tid, stride, P.bar);
    restrict_residual(L, P.block, l + 1 < P.levels ? P.lv[l + 1].b : P.bc,
                      tid, stride, P.bar);
  }
  coarse_solve(P, tid, stride);
  for (int l = P.levels - 1; l >= 0; --l) {
    const Level<T>& L = P.lv[l];
    prolong(L, P.block, l + 1 < P.levels ? P.lv[l + 1].x : P.xc, tid,
            stride, P.bar);
    smooth(L, P.degree, false, tid, stride, P.bar);
  }
}

template <typename T>
cudaError_t launch(int device, int levels, int degree, int nc,
                   const uint64_t* ptrs, const int64_t* ints,
                   const double* scal, void* bar, int threads,
                   cudaStream_t stream) {
  if (levels < 1 || levels > kMaxLevels || degree < 1 ||
      degree > kMaxDegree || threads != kThreads) {
    return cudaErrorInvalidValue;
  }
  Params<T> P = {};
  for (int l = 0; l < levels; ++l) {
    const uint64_t* pp = ptrs + l * kPtrs;
    const int64_t* ii = ints + l * kInts;
    const double* ss = scal + l * kScalars;
    Level<T>& L = P.lv[l];
    L.data = reinterpret_cast<const T*>(pp[0]);
    L.offs = reinterpret_cast<const int*>(pp[1]);
    L.dinv = reinterpret_cast<const T*>(pp[2]);
    L.b = reinterpret_cast<T*>(pp[3]);
    L.x = reinterpret_cast<T*>(pp[4]);
    L.r = reinterpret_cast<T*>(pp[5]);
    L.p = reinterpret_cast<T*>(pp[6]);
    L.q = reinterpret_cast<T*>(pp[7]);
    L.n = static_cast<int>(ii[0]);
    L.D = static_cast<int>(ii[1]);
    L.smoothed = static_cast<int>(ii[2]);
    P.block = static_cast<int>(ii[3]);
    L.omega = static_cast<T>(ss[0]);
    L.wscale = static_cast<T>(ss[1]);
    L.theta = static_cast<T>(ss[2]);
    for (int s = 0; s < kMaxDegree; ++s) {
      L.c1[s] = static_cast<T>(ss[3 + s]);
      L.c2[s] = static_cast<T>(ss[3 + kMaxDegree + s]);
    }
  }
  const uint64_t* tail = ptrs + levels * kPtrs;
  P.cinv = reinterpret_cast<const T*>(tail[0]);
  P.bc = reinterpret_cast<T*>(tail[1]);
  P.xc = reinterpret_cast<T*>(tail[2]);
  P.bar = static_cast<unsigned*>(bar);
  P.nc = nc;
  P.levels = levels;
  P.degree = degree;

  // The co-resident grid of this device, asked once.
  static int grid[2][64] = {};
  const int slot = sizeof(T) == 8 ? 1 : 0;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (grid[slot][device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_vcycle_kernel<T>, kThreads, 0);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    grid[slot][device] = per_sm * sms;
  }
  void* args[] = {&P};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_vcycle_kernel<T>),
      dim3(grid[slot][device]), dim3(kThreads), args, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launch (0 on success).  `ptrs` holds 8
// pointers a level (data, offsets, dinv, b, x, r, p, q) then the coarse
// inverse's, b's and x's; `ints` 4 a level (rows, diagonals, smoothed,
// block); `scalars` 3 + 2 * 8 float64 a level (omega, wscale, theta, c1,
// c2); `barrier` two zeroed unsigned words on the device, zero again when
// the kernel ends.  dtype 0 is float32, 1 float64.
extern "C" int fused_vcycle_launch(int dtype, int device, int levels,
                                   int degree, long long nc,
                                   const void* ptrs, const void* ints,
                                   const void* scalars, void* barrier,
                                   int threads, void* stream) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t* p = static_cast<const uint64_t*>(ptrs);
  const int64_t* i = static_cast<const int64_t*>(ints);
  const double* c = static_cast<const double*>(scalars);
  switch (dtype) {
    case 0:
      return launch<float>(device, levels, degree, static_cast<int>(nc), p,
                           i, c, barrier, threads, s);
    case 1:
      return launch<double>(device, levels, degree, static_cast<int>(nc), p,
                            i, c, barrier, threads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

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
// What bounds it on an H100: bytes at the fine levels, latency at the
// coarse ones.  Every step is a DIA matvec (2 flops a value read) or an
// axpy.  The least the card could move is each input once: the levels'
// diagonals, dinv, Cinv, b, and y once (about 235 MB at poisson2d(2048^2)
// in float32, 0.070 ms at 3.35 TB/s).  The algorithm itself reads each
// level again for each of its matvecs (8 at a smoothed level, 6 at a
// plain one, degree 3).  Below level 2 (262,144 rows at 2048^2) a level
// fits the L2 and a step is a few thousand rows: a thread's chain of
// dependent loads, then a barrier.
//
// The design: a cooperative persistent kernel.  The grid is as many
// blocks as can be co-resident (the occupancy calculator times the SMs:
// one block of 1,024 threads an SM), launched with
// cudaLaunchCooperativeKernel, which refuses a grid that could not all be
// resident.  A step is a grid-stride loop over rows, one thread a row, and
// dependent steps are separated by a grid-wide barrier (an arrival
// counter and a generation word, with __threadfence, so the file needs no
// relocatable device code).  Measured on an H100 at poisson2d(2048^2),
// float32 (V-cycles from level k down, timed alike): level 0 takes 0.66
// ms, level 1 0.32, levels 2-6 and the coarse solve 0.21, so the fine
// levels' streaming (about 60% of the triad rate) sets K8's time, not its
// barriers.  Not kept, being no faster: the coarse levels in one thread
// block cluster with the hardware cluster barrier (clusters of 8 or 4
// leave 120 of the 132 SMs co-resident and took 1.28 ms at their best;
// clusters of 2 gained 0.002-0.005 ms over these steps on the whole
// grid), and two rows a thread a trip (spilled at the 64-register cap,
// 1.31 ms).
// - Barriers a level, degree k >= 2: the pre-smoother k - 1 (its first
//   step, x = 0, r = dinv b, p = r / theta, is element-wise and is folded
//   into the second, which computes p at each neighbour on the fly); the
//   restriction 1, or 2 at a smoothed level; the prolongation 0 at a
//   plain level (folded into the post-smoother's first residual, which
//   reads x + xc wscale at each neighbour) or 1 at a smoothed one (it
//   needs A y0 at each neighbour); the post-smoother k.  So 2 k + 2 at a
//   smoothed level and 2 k at a plain one, one after the coarse solve,
//   less the last step's (the launch's end): 44 at poisson2d(2048^2),
//   degree 3, against 58 for one barrier a step of every level.
// - A value a fused step computes on the fly is rounded as the unfused
//   step rounded the value it stored (mul_rn, div_rn, add_rn: no
//   contraction into an FMA), so the result is the unfused kernel's bit
//   for bit.
//
// Steps fused so that no vector is written only to be read back by the
// same row: the matvec with its vector update; the restriction with the
// last residual or composition matvec (one thread a fine row, a segmented
// warp shuffle summing each coarse row's `block` fine rows; one thread a
// coarse row where `block` does not divide 32).  The smoother's last step
// adds p to x and needs no matvec.  The p update writes a second buffer
// (q), since neighbours still read p; at a folded prolongation the
// prolonged x waits in q for the first Chebyshev step, which reads it at
// its own row only.
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

// Roundings of their own: never contracted into an FMA with a later add.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

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

// The threads of a step (a grid-stride loop) and the barrier after it.
struct Grid {
  unsigned* bar;
  int tid, stride;
  __device__ void sync() const { grid_sync(bar); }
};

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

// Chebyshev steps first .. degree-2 of _cheb_smooth: p is read at each
// neighbour, x at the row's own entry from xin (L.x, or q where the
// prolonged x waits), and x, r and q (the next p) are written.  The last
// step adds p to x and needs no matvec; it is followed by a barrier only
// with sync_last.
template <typename T>
__device__ void cheb_steps(const Level<T>& L, int degree, int first, T* p,
                           T* q, const T* xin, const Grid& on,
                           bool sync_last) {
  T* x = L.x;
  for (int s = first; s + 1 < degree; ++s) {
    const bool last = s + 2 == degree;
    const T c1 = L.c1[s], c2 = L.c2[s];
    for (int i = on.tid; i < L.n; i += on.stride) {
      const T ap = dia_row(L, i, [p](int j) { return p[j]; });
      const T pi = p[i];
      const T ri = L.r[i] - L.dinv[i] * ap;
      const T qi = c1 * pi + c2 * ri;
      T xi = xin[i] + pi;
      if (last) xi = xi + qi;   // the last step: x += p, no matvec
      x[i] = xi;
      L.r[i] = ri;
      q[i] = qi;
    }
    if (!last || sync_last) on.sync();
    T* t = p;
    p = q;
    q = t;
    xin = x;
  }
}

// _cheb_smooth from x = 0.  Its first step (r = dinv b, p = r / theta,
// x = 0) is element-wise: the next step computes p at each neighbour
// from b and dinv, rounded as the stored p was.
template <typename T>
__device__ void pre_smooth(const Level<T>& L, int degree, const Grid& on) {
  const T* b = L.b;
  const T* dinv = L.dinv;
  const T theta = L.theta;
  const auto p0 = [b, dinv, theta](int j) {
    return div_rn(mul_rn(dinv[j], b[j]), theta);
  };
  T* x = L.x;
  if (degree == 1) {
    for (int i = on.tid; i < L.n; i += on.stride) x[i] = add_rn(T(0), p0(i));
    on.sync();
    return;
  }
  const bool last = degree == 2;
  const T c1 = L.c1[0], c2 = L.c2[0];
  for (int i = on.tid; i < L.n; i += on.stride) {
    const T ap = dia_row(L, i, p0);
    const T pi = p0(i);
    const T r0 = mul_rn(dinv[i], b[i]);
    const T ri = r0 - dinv[i] * ap;
    const T qi = c1 * pi + c2 * ri;
    T xi = add_rn(T(0), pi);
    if (last) xi = xi + qi;
    x[i] = xi;
    L.r[i] = ri;
    L.q[i] = qi;
  }
  on.sync();
  cheb_steps(L, degree, 1, L.q, L.p, x, on, true);
}

// x + xc[j / block] wscale, a plain level's prolongation of row j, with
// the product rounded on its own as the unfused step rounded it.
template <typename T>
__device__ __forceinline__ T prolonged(T x, T xc, T w) {
  return add_rn(x, mul_rn(xc, w));
}

// _cheb_smooth from L.x; with Fold (a plain level), L.x is first
// prolonged from xc, x(j) + xc[j / block] wscale, at each neighbour of
// the first residual, and the prolonged x of the row waits in q.
template <bool Fold, typename T>
__device__ void post_smooth(const Level<T>& L, int degree, int block,
                            const T* xc, const Grid& on, bool sync_last) {
  T* x = L.x;
  const T w = L.wscale;
  const auto xv = [x, xc, block, w](int j) {
    return Fold ? prolonged(x[j], xc[j / block], w) : x[j];
  };
  for (int i = on.tid; i < L.n; i += on.stride) {
    const T res = L.b[i] - dia_row(L, i, xv);
    const T rv = L.dinv[i] * res;
    L.r[i] = rv;
    L.p[i] = rv / L.theta;
    if (Fold) L.q[i] = xv(i);
  }
  on.sync();
  const T* xin = Fold ? L.q : x;
  if (degree == 1) {
    for (int i = on.tid; i < L.n; i += on.stride) x[i] = xin[i] + L.p[i];
    if (sync_last) on.sync();
    return;
  }
  cheb_steps(L, degree, 0, L.p, L.q, xin, on, sync_last);
}

// bnext[c] = wscale * (the sum of rs over fine rows c*block .. +block-1),
// rs(i) the restricted residual of fine row i.  When block divides 32, one
// thread a fine row and a segmented shuffle tree (the rows of one coarse
// row are neighbouring lanes of one warp: the stride is a multiple of 32
// and n of block); otherwise one thread a coarse row, in row order.
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
                                  const Grid& on) {
  const T* x = L.x;
  if (L.smoothed) {
    // rs = r - omega A (dinv r): r kept in L.r, dinv r in L.p
    for (int i = on.tid; i < L.n; i += on.stride) {
      const T rf = L.b[i] - dia_row(L, i, [x](int j) { return x[j]; });
      L.r[i] = rf;
      L.p[i] = L.dinv[i] * rf;
    }
    on.sync();
    const T* t = L.p;
    restrict_rows(L, block, bnext, on.tid, on.stride, [&L, t](int i) {
      return L.r[i] - L.omega * dia_row(L, i, [t](int j) { return t[j]; });
    });
  } else {
    restrict_rows(L, block, bnext, on.tid, on.stride, [&L, x](int i) {
      return L.b[i] - dia_row(L, i, [x](int j) { return x[j]; });
    });
  }
  on.sync();
}

// A smoothed level's prolongation, x += (I - omega D^-1 A) P0 xc, P0 a
// repeat times wscale, y0 read straight from xc: a step of its own.
template <typename T>
__device__ void prolong_smoothed(const Level<T>& L, int block, const T* xc,
                                 const Grid& on) {
  const T w = L.wscale;
  for (int i = on.tid; i < L.n; i += on.stride) {
    const T y0 = mul_rn(xc[i / block], w);
    const T ay = dia_row(L, i, [xc, block, w](int j) {
      return xc[j / block] * w;
    });
    L.x[i] = L.x[i] + (y0 - L.omega * L.dinv[i] * ay);
  }
  on.sync();
}

// xc = Cinv bc, one warp a row, lanes over columns, a fixed shuffle tree.
template <typename T>
__device__ void coarse_solve(const Params<T>& P, const Grid& on) {
  const int lane = threadIdx.x & 31;
  for (int row = on.tid >> 5; row < P.nc; row += on.stride >> 5) {
    const T* a = P.cinv + static_cast<int64_t>(row) * P.nc;
    T s = T(0);
    for (int c = lane; c < P.nc; c += 32) s += __ldg(a + c) * P.bc[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) P.xc[row] = s;
  }
}

// Level l on the way down: pre-smooth, then restrict into level l + 1.
template <typename T>
__device__ void descend(const Params<T>& P, int l, const Grid& on) {
  const Level<T>& L = P.lv[l];
  pre_smooth(L, P.degree, on);
  restrict_residual(L, P.block, l + 1 < P.levels ? P.lv[l + 1].b : P.bc,
                    on);
}

// Level l on the way up: prolong from level l + 1, then post-smooth.
template <typename T>
__device__ void ascend(const Params<T>& P, int l, const Grid& on,
                       bool sync_last) {
  const Level<T>& L = P.lv[l];
  const T* xc = l + 1 < P.levels ? P.lv[l + 1].x : P.xc;
  if (L.smoothed) {
    prolong_smoothed(L, P.block, xc, on);
    post_smooth<false>(L, P.degree, P.block, xc, on, sync_last);
  } else {
    post_smooth<true>(L, P.degree, P.block, xc, on, sync_last);
  }
}

// One block of 1,024 threads an SM: at most 64 registers a thread.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    fused_vcycle_kernel(const __grid_constant__ Params<T> P) {
  const Grid grid{P.bar, static_cast<int>(blockIdx.x * blockDim.x +
                                          threadIdx.x),
                  static_cast<int>(gridDim.x * blockDim.x)};
  for (int l = 0; l < P.levels; ++l) descend(P, l, grid);
  coarse_solve(P, grid);
  grid.sync();
  for (int l = P.levels - 1; l >= 0; --l) ascend(P, l, grid, l > 0);
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
// c2); `barrier` two unsigned words on the device, the first zero, zero
// again when the kernel ends.  dtype 0 is float32, 1 float64.
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

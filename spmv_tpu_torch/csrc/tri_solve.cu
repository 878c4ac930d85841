// Sparse triangular solve: z = T^-1 b, for the IC(0) and ILU(0)
// preconditioners (spmv_tpu_torch/ops/incomplete.py).
//
// Replaces no Pallas kernel: the JAX package runs this solve as a
// lax.scan over padded levels in XLA (DeviceTriSolve.solve,
// spmv_tpu/ops/incomplete.py:363-378, and tri_solve_sweeps, :399-419).
// A scan on the hot path becomes a kernel here: the solve runs twice in
// every preconditioner apply.
//
// For the row i at position p (the rows in level order, level_rows), with
// the row's off-diagonal dependencies j at dep_ptr[p]..dep_ptr[p+1] in the
// factor's CSR order:
//
//   z[i] = (b[i] - sum_j T[i, j] * z[j]) * diag_inv[p]
//
// The layout is the port's own (DeviceTriSolve): the rows in level order
// and a CSR of their dependencies in that order, with no padding.  The
// JAX container pads every level to the widest and every row to the most
// dependencies, so a row there also adds 0 * z[n] for each padding slot;
// the sum is the same.
//
// Three modes, one C entry (tri_solve_launch); a thread takes a row in
// each, and every mode adds a row's dependencies in CSR order with the
// same expression (dep_add), so the level and the chained solve give the
// same bits:
// - kLevels: in place, one launch a level, in level order, each over its
//   own positions.  A level's rows read only rows of earlier levels, so
//   no launch reads what it writes; the launches run in order on the
//   stream.  The wrapper zeroes z first, as the JAX scan starts from 0.
// - kChained: one launch for the whole solve, in place.  Every dependency
//   of position p lies at a smaller position (the levels are in order), so
//   a row waits until its dependencies are published in this solve and
//   then solves and publishes itself; see tri_chained_kernel for how it
//   keeps the order, makes progress and tells this solve's values from
//   the last one's without a pass over its state.
// - kSweep: one launch over every position, z_in -> z_out (a Jacobi
//   sweep: every row reads the previous sweep's z, as JAX's
//   z.at[rows].set(...) computed from z does).  The wrapper alternates
//   two buffers.
//
// What bounds it on an H100: bytes where the levels are few and wide, the
// chain of levels where they are many and narrow.  A solve reads dep_ptr,
// dep_cols, dep_vals and b once and writes z once (2 flops a dependency,
// far below the card's flops-a-byte balance), plus the z gathers, which
// mostly hit L2; level_rows and diag_inv only where they carry
// information: a unit-diagonal factor (ILU(0)'s L) skips diag_inv
// (template Unit), and where every level is a contiguous row range the
// row is the position plus the level's shift (template Contig; in the
// chained mode only where every shift is 0).  After --reorder color a
// triangle has one level a color (2 on a 5-point stencil): one or two
// wide launches of kLevels at the memory rate.  At natural order a
// 5-point stencil's triangle has 2 sqrt(n) - 1 levels of at most sqrt(n)
// rows: at poisson2d(1024^2) 2,047 levels, which cost 2,047 launches in
// the level mode (about 1.7 us each in a CUDA graph) and 2,047 hand-offs
// from one level to the next through the L2 in the chained mode (about
// 0.35 us each on a chain of one-row levels; twice that a level at
// natural order, where each row waits on the later of two rows).
// tri_solve_plan (ops/tri_kernels.py) picks kChained for many narrow
// levels and kLevels for few wide ones, where the chained mode's words
// (8 or 16 bytes a row written, as many a dependency read) and its
// polling cost more than the launches.  A grid barrier a level, as K8's
// cooperative launch has, would cost about a launch a barrier, so it was
// not taken.

#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

enum TriMode : int { kLevels = 0, kSweep = 1, kChained = 2 };

// The chained mode's counters (DeviceTriSolve.chain_counters).
enum ChainCounter : int { kEpoch = 0, kTicket = 1, kDone = 2 };

// Rows a ticket at most: a warp takes one ticket at a time, a lane a row.
constexpr int kTicketRows = 32;

// The first dependencies of a row whose columns and values the chained
// mode loads into registers before it waits, and polls together.
constexpr int kHeld = 4;

// Polls of a waiting row in flight at once (2 measured faster than 1, 3
// and 4 on an H100).
constexpr int kPolls = 2;

// A wait longer than this ends the launch with an error (a trap) instead
// of holding the card: no solve comes near it (2,047 levels take
// milliseconds), so only a fault in the order of the positions could.
constexpr unsigned long long kStuckNs = 10ull * 1000 * 1000 * 1000;

// sum_q dep_vals[q] * z[dep_cols[q]] over [s, e), in order, each term
// fused into the sum: the one expression every mode adds with.
template <typename T>
__device__ __forceinline__ T dep_add(T acc, T v, T zj) {
  return acc + v * zj;
}

// Unit: the factor's diagonal is 1 (ILU(0)'s L), so diag_inv is not
// read.  Contig: the level's rows are the contiguous range that starts at
// row begin + shift (as after --reorder color), so level_rows is not read.
template <typename T, bool Unit, bool Contig>
__global__ void __launch_bounds__(256)
    tri_solve_kernel(const int* __restrict__ level_rows,
                     const int* __restrict__ dep_ptr,
                     const int* __restrict__ dep_cols,
                     const T* __restrict__ dep_vals,
                     const T* __restrict__ diag_inv,
                     const T* __restrict__ b, const T* z_in, T* z_out,
                     int64_t begin, int64_t end, int64_t shift) {
  const int64_t p =
      begin + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= end) return;
  const int row = Contig ? static_cast<int>(p + shift) : level_rows[p];
  const int s = dep_ptr[p];
  const int e = dep_ptr[p + 1];
  T acc = T(0);
  for (int q = s; q < e; ++q)
    acc = dep_add(acc, dep_vals[q], z_in[dep_cols[q]]);
  const T r = b[row] - acc;
  z_out[row] = Unit ? r : r * diag_inv[p];
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A row's value and the tag of the solve that wrote it share 64-bit
// words: one for a float (tag << 32 | bits), two for a double (tag << 32
// | each half of its bits).  A relaxed load that finds the tag holds the
// value too, so neither side needs a fence: each word is written and
// read whole (naturally aligned 64-bit accesses are single-copy atomic).
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int kWords = 1;
  static __device__ __forceinline__ float value(
      const unsigned long long* x) {
    return __uint_as_float(static_cast<unsigned>(x[0]));
  }
  static __device__ __forceinline__ void publish(unsigned long long* w,
                                                 int row, unsigned tag,
                                                 float v) {
    store_relaxed(w + row, static_cast<unsigned long long>(tag) << 32 |
                               __float_as_uint(v));
  }
};

template <>
struct Word<double> {
  static constexpr int kWords = 2;
  static __device__ __forceinline__ double value(
      const unsigned long long* x) {
    return __hiloint2double(static_cast<int>(x[1]), static_cast<int>(x[0]));
  }
  static __device__ __forceinline__ void publish(unsigned long long* w,
                                                 int row, unsigned tag,
                                                 double v) {
    const unsigned long long bits = __double_as_longlong(v);
    const unsigned long long t = static_cast<unsigned long long>(tag) << 32;
    store_relaxed(w + 2 * int64_t(row), t | (bits & 0xffffffffull));
    store_relaxed(w + 2 * int64_t(row) + 1, t | (bits >> 32));
  }
};

// The words of a row's first kHeld dependencies, as one poll read them:
// start() sends every load and waits for none; ready() waits for them.
template <typename T>
struct Poll {
  static constexpr int kW = Word<T>::kWords;
  unsigned long long x[kHeld * kW];

  __device__ __forceinline__ void start(const unsigned long long* w,
                                        const int* col, int deps) {
#pragma unroll
    for (int k = 0; k < kHeld; ++k)
#pragma unroll
      for (int h = 0; h < kW; ++h)
        if (k < deps)
          x[k * kW + h] = load_relaxed(w + int64_t(col[k]) * kW + h);
  }
  __device__ __forceinline__ bool ready(unsigned tag, int deps) const {
    bool ok = true;
#pragma unroll
    for (int k = 0; k < kHeld; ++k)
#pragma unroll
      for (int h = 0; h < kW; ++h)
        if (k < deps) ok &= static_cast<unsigned>(x[k * kW + h] >> 32) == tag;
    return ok;
  }
  __device__ __forceinline__ T value(int k) const {
    return Word<T>::value(x + k * kW);
  }
};

// Ends the launch with an error once a wait that began at t0 has lasted
// kStuckNs.
__device__ __forceinline__ void check_stuck(unsigned long long t0) {
  if (global_ns() - t0 > kStuckNs) __trap();
}

// Row j's value once its words carry tag; false while they do not (a
// row's dependencies past the first kHeld).
template <typename T>
__device__ __forceinline__ bool take(const unsigned long long* w, int j,
                                     unsigned tag, T& v) {
  constexpr int kW = Word<T>::kWords;
  unsigned long long x[kW];
  bool ok = true;
#pragma unroll
  for (int h = 0; h < kW; ++h) {
    x[h] = load_relaxed(w + int64_t(j) * kW + h);
    ok &= static_cast<unsigned>(x[h] >> 32) == tag;
  }
  v = Word<T>::value(x);
  return ok;
}

// One launch solves every position [0, n).
//
// Order: the positions are in level order, so each dependency of
// position p lies at a smaller position.  A ticket is a run of at most
// kTicketRows positions of one level (ticket_ptr: no ticket straddles two
// levels, so no lane waits on a lane of its own warp).  A warp takes its
// tickets from a counter (atomicAdd), not from its block index, so the
// positions it waits on belong to lower tickets, which warps already
// running hold; by induction on the ticket every wait ends, whatever
// order the blocks are scheduled in and however few of them are
// resident.  The grid is sized by the wrapper to a few levels' tickets:
// more warps than the chain of levels can feed would only poll.
//
// Memory order: a row publishes its value and the solve's tag in one
// relaxed 64-bit store (two for a double; struct Word) and then writes
// z[row] for the caller; a reader polls its dependencies' words with
// relaxed loads at device scope (through L2, never the non-coherent
// path) and takes the values from the words it finds tagged.  A release
// flag beside z would cost a fence on the writer's side and a second L2
// round trip (the z read after the acquire) on the reader's, both on the
// chain of levels.  Each waiting lane spins on its own: kPolls polls of
// its held dependencies' words in flight, checked in turn, and it solves
// and publishes as soon as one finds them all tagged.
//
// Tags without a reset pass: a word carries the solve's epoch + 1 once
// the row is done in this solve.  Every warp reads the epoch from the
// counters when it starts; the last warp to finish (the done counter)
// zeroes the ticket and done counters and advances the epoch, after every
// warp has read it.  The counters live on the device, so a CUDA graph
// that replays the launch solves anew each time.
//
// The sum is the level kernel's: the same dep_add over the same
// dependencies in the same order, so z is bit for bit kLevels'.  The
// first kHeld dependencies' columns and values, b and diag_inv are loaded
// before the polls.
template <typename T, bool Unit, bool Contig>
__global__ void __launch_bounds__(256)
    tri_chained_kernel(const int* __restrict__ ticket_ptr,
                       const int* __restrict__ level_rows,
                       const int* __restrict__ dep_ptr,
                       const int* __restrict__ dep_cols,
                       const T* __restrict__ dep_vals,
                       const T* __restrict__ diag_inv,
                       const T* __restrict__ b, T* z,
                       unsigned long long* words, unsigned* counters,
                       int tickets) {
  const int lane = threadIdx.x & 31;
  unsigned epoch = 0;
  if (lane == 0) epoch = *static_cast<volatile unsigned*>(counters + kEpoch);
  const unsigned tag = __shfl_sync(0xffffffffu, epoch, 0) + 1u;
  for (;;) {
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(counters + kTicket, 1u);
    t = __shfl_sync(0xffffffffu, t, 0);
    if (t >= static_cast<unsigned>(tickets)) break;
    const int p = ticket_ptr[t] + lane;
    const bool pending = p < ticket_ptr[t + 1];
    int row = 0, s = 0, e = 0;
    T bi = T(0), di = T(1);
    int col[kHeld];
    T val[kHeld];
    if (pending) {
      row = Contig ? p : level_rows[p];
      s = dep_ptr[p];
      e = dep_ptr[p + 1];
      bi = b[row];
      if (!Unit) di = diag_inv[p];
    }
    const int held = min(e - s, kHeld);
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      col[k] = k < held ? dep_cols[s + k] : 0;
      val[k] = k < held ? dep_vals[s + k] : T(0);
    }
    // solve the row from a poll that found its first kHeld dependencies
    // done, and publish it
    auto finish = [&](const Poll<T>& got, unsigned long long t0) {
      for (int q = s + kHeld; q < e; ++q) {
        T unused;
        while (!take(words, dep_cols[q], tag, unused)) check_stuck(t0);
      }
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < kHeld; ++k)
        if (k < held) acc = dep_add(acc, val[k], got.value(k));
      for (int q = s + kHeld; q < e; ++q) {
        T v;
        take(words, dep_cols[q], tag, v);
        acc = dep_add(acc, dep_vals[q], v);
      }
      const T r = bi - acc;
      const T zi = Unit ? r : r * di;
      Word<T>::publish(words, row, tag, zi);
      z[row] = zi;
    };
    if (pending) {
      // kPolls polls in flight, checked in turn, so the words are sampled
      // kPolls times an L2 round trip; a lane waits on other warps only
      // (no ticket straddles two levels), so it spins on its own and
      // publishes as soon as its row is solved
      Poll<T> poll[kPolls];
#pragma unroll
      for (int i = 0; i + 1 < kPolls; ++i) poll[i].start(words, col, held);
      const unsigned long long t0 = global_ns();
      for (;;) {
        bool done = false;
#pragma unroll
        for (int i = 0; i < kPolls; ++i) {
          poll[(i + kPolls - 1) % kPolls].start(words, col, held);
          if (poll[i].ready(tag, held)) {
            finish(poll[i], t0);
            done = true;
            break;
          }
        }
        if (done) break;
        check_stuck(t0);
      }
    }
  }
  if (lane == 0) {
    __threadfence();
    const unsigned warps = gridDim.x * (blockDim.x / 32);
    if (atomicAdd(counters + kDone, 1u) == warps - 1) {
      counters[kTicket] = 0;
      counters[kDone] = 0;
      counters[kEpoch] = tag;
    }
  }
}

struct TriArgs {
  const int* rows;
  const int* dptr;
  const int* dcols;
  const void* dvals;
  const void* dinv;
  const void* b;
  const void* z_in;
  void* z_out;
  bool unit;
  int threads;
  cudaStream_t stream;
};

template <typename T, bool Unit, bool Contig>
void launch_as(const TriArgs& a, int64_t begin, int64_t end, int64_t shift,
               unsigned blocks) {
  tri_solve_kernel<T, Unit, Contig><<<blocks, a.threads, 0, a.stream>>>(
      a.rows, a.dptr, a.dcols, static_cast<const T*>(a.dvals),
      static_cast<const T*>(a.dinv), static_cast<const T*>(a.b),
      static_cast<const T*>(a.z_in), static_cast<T*>(a.z_out), begin, end,
      shift);
}

// One launch over the positions [begin, end); contig: row = p + shift.
template <typename T>
cudaError_t launch_range(const TriArgs& a, int64_t begin, int64_t end,
                         bool contig, int64_t shift) {
  const int64_t blocks = (end - begin + a.threads - 1) / a.threads;
  if (blocks <= 0) return cudaSuccess;
  const unsigned g = static_cast<unsigned>(blocks);
  if (a.unit && contig) launch_as<T, true, true>(a, begin, end, shift, g);
  else if (a.unit) launch_as<T, true, false>(a, begin, end, shift, g);
  else if (contig) launch_as<T, false, true>(a, begin, end, shift, g);
  else launch_as<T, false, false>(a, begin, end, shift, g);
  return cudaGetLastError();
}

struct ChainArgs {
  const int* ticket_ptr;
  int tickets;
  unsigned long long* words;
  unsigned* counters;
  int blocks;
};

template <typename T, bool Unit, bool Contig>
void chained_as(const TriArgs& a, const ChainArgs& c) {
  tri_chained_kernel<T, Unit, Contig><<<c.blocks, a.threads, 0, a.stream>>>(
      c.ticket_ptr, a.rows, a.dptr, a.dcols, static_cast<const T*>(a.dvals),
      static_cast<const T*>(a.dinv), static_cast<const T*>(a.b),
      static_cast<T*>(a.z_out), c.words, c.counters, c.tickets);
}

// One launch of the chained mode over the tickets; contig: row = p.
template <typename T>
cudaError_t launch_chained(const TriArgs& a, const ChainArgs& c,
                           bool contig) {
  if (a.threads % 32 != 0 || c.blocks <= 0) return cudaErrorInvalidValue;
  if (c.tickets <= 0) return cudaSuccess;
  if (a.unit && contig) chained_as<T, true, true>(a, c);
  else if (a.unit) chained_as<T, true, false>(a, c);
  else if (contig) chained_as<T, false, true>(a, c);
  else chained_as<T, false, false>(a, c);
  return cudaGetLastError();
}

template <typename T>
int run(int mode, const long long* level_ptr, const long long* level_shift,
        int num_levels, const TriArgs& a, const ChainArgs& c,
        long long* launched) {
  *launched = 0;
  if (mode == kSweep || mode == kChained) {
    // one launch over every position: contiguous only where every
    // level's shift is 0 (the positions are the rows)
    bool identity = level_shift != nullptr;
    for (int l = 0; identity && l < num_levels; ++l)
      identity = level_shift[l] == 0;
    const int64_t begin = level_ptr[0], end = level_ptr[num_levels];
    cudaError_t e = mode == kSweep
                        ? launch_range<T>(a, begin, end, identity, 0)
                        : launch_chained<T>(a, c, identity);
    if (e == cudaSuccess && end > begin) *launched = 1;
    return e;
  }
  if (mode != kLevels) return cudaErrorInvalidValue;
  for (int l = 0; l < num_levels; ++l) {
    if (level_ptr[l + 1] <= level_ptr[l]) continue;
    cudaError_t e = launch_range<T>(
        a, level_ptr[l], level_ptr[l + 1], level_shift != nullptr,
        level_shift != nullptr ? level_shift[l] : 0);
    if (e != cudaSuccess) return e;
    ++*launched;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace spmv_tpu_torch

// Returns the cudaError_t of the launches (0 on success) and the number
// of kernels launched in *launched.  level_ptr is a host array of
// num_levels + 1 positions; level_shift, a host array of num_levels, or
// null: where given, level l's rows are the positions of l plus
// level_shift[l] and level_rows is not read.  unit_diag: diag_inv is not
// read (the diagonal is 1).  kLevels launches once a non-empty level, in
// order (z_in == z_out), kSweep once over [level_ptr[0],
// level_ptr[num_levels]) (z_in != z_out), kChained once (z_in == z_out)
// over the tickets (ticket_ptr, tickets + 1 device positions) in
// chain_blocks blocks, with the container's words (one 64-bit word a row
// for float, two for double) and counters (epoch, ticket, done); the
// other modes ignore those five.
extern "C" int tri_solve_launch(int dtype, int device, int mode,
                                const long long* level_ptr,
                                const long long* level_shift,
                                int num_levels, int unit_diag,
                                const void* level_rows, const void* dep_ptr,
                                const void* dep_cols, const void* dep_vals,
                                const void* diag_inv, const void* b,
                                const void* z_in, void* z_out,
                                const void* ticket_ptr, int tickets,
                                void* words, void* counters,
                                int chain_blocks, int threads, void* stream,
                                long long* launched) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const TriArgs a{static_cast<const int*>(level_rows),
                  static_cast<const int*>(dep_ptr),
                  static_cast<const int*>(dep_cols),
                  dep_vals, diag_inv, b, z_in, z_out, unit_diag != 0,
                  threads, static_cast<cudaStream_t>(stream)};
  const ChainArgs c{static_cast<const int*>(ticket_ptr), tickets,
                    static_cast<unsigned long long*>(words),
                    static_cast<unsigned*>(counters), chain_blocks};
  switch (dtype) {
    case kFloat32:
      return run<float>(mode, level_ptr, level_shift, num_levels, a, c,
                        launched);
    case kFloat64:
      return run<double>(mode, level_ptr, level_shift, num_levels, a, c,
                         launched);
    default:
      return cudaErrorInvalidValue;
  }
}

// Level-scheduled sparse triangular solve: z = T^-1 b, for the IC(0) and
// ILU(0) preconditioners (spmv_tpu_torch/ops/incomplete.py).
//
// Replaces no Pallas kernel: the JAX package runs this solve as a
// lax.scan over padded levels in XLA (DeviceTriSolve.solve,
// spmv_tpu/ops/incomplete.py:363-378, and tri_solve_sweeps, :399-419).
// A scan on the hot path becomes a kernel here: the solve runs twice in
// every preconditioner apply.
//
// For the rows i of one level (the rows at positions [begin, end) of
// level_rows), with the row's off-diagonal dependencies j at
// dep_ptr[p]..dep_ptr[p+1] in the factor's CSR order:
//
//   z[i] = (b[i] - sum_j T[i, j] * z[j]) * diag_inv[p]
//
// The layout is the port's own (DeviceTriSolve): the rows in level order
// and a CSR of their dependencies in that order, with no padding.  The
// JAX container pads every level to the widest and every row to the most
// dependencies, so a row there also adds 0 * z[n] for each padding slot;
// the sum is the same.
//
// Two modes, one C entry (tri_solve_launch):
// - kLevels: in place, one launch a level, in level order, each over its
//   own positions.  A level's rows read only rows of earlier levels, so
//   no launch reads what it writes; the launches run in order on the
//   stream.  The wrapper zeroes z first, as the JAX scan starts from 0.
// - kSweep: one launch over every position, z_in -> z_out (a Jacobi
//   sweep: every row reads the previous sweep's z, as JAX's
//   z.at[rows].set(...) computed from z does).  The wrapper alternates
//   two buffers.
//
// What bounds it on an H100: bytes and, at natural order, launches.  A
// solve reads dep_ptr, dep_cols, dep_vals and b once and writes z once
// (2 flops a dependency, far below the card's flops-a-byte balance),
// plus the z gathers, which mostly hit L2 since they read rows of recent
// levels; level_rows and diag_inv only where they carry information.  A
// unit-diagonal factor (ILU(0)'s L) skips diag_inv (template Unit), and
// where every level is a contiguous row range the row is the position
// plus the level's shift (template Contig): after --reorder color that
// is every triangle, so its solve reads neither array.  After --reorder
// color a triangle has one level a color (2 on a 5-point stencil), so it
// is one or two wide launches at the memory rate.  At natural order a 5-point stencil's
// triangle has 2 sqrt(n) - 1 levels of at most sqrt(n) rows: at
// poisson2d(1024^2), 2,047 launches of at most 4 blocks each, so the
// solve costs the launches, not the bytes.  What this design does about
// it: the positions of a level are contiguous, so a warp's reads of
// level_rows, dep_ptr and diag_inv coalesce and its dependency entries
// stream; the C entry loops over the levels itself (one ctypes call a
// solve, not one a level); and a thread takes a row, which is enough at
// 2 dependencies a row.  One launch for the whole solve (a grid barrier a
// level, or ready flags) is the redesign the launch bound asks for.

#include "dia_common.cuh"

namespace spmv_tpu_torch {
namespace {

enum TriMode : int { kLevels = 0, kSweep = 1 };

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
  for (int q = s; q < e; ++q) acc += dep_vals[q] * z_in[dep_cols[q]];
  const T r = b[row] - acc;
  z_out[row] = Unit ? r : r * diag_inv[p];
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

template <typename T>
int run(int mode, const long long* level_ptr, const long long* level_shift,
        int num_levels, const TriArgs& a, long long* launched) {
  *launched = 0;
  if (mode == kSweep) {
    // one launch over every position: contiguous only where every
    // level's shift is 0 (the positions are the rows)
    bool identity = level_shift != nullptr;
    for (int l = 0; identity && l < num_levels; ++l)
      identity = level_shift[l] == 0;
    cudaError_t e = launch_range<T>(a, level_ptr[0], level_ptr[num_levels],
                                    identity, 0);
    if (e == cudaSuccess && level_ptr[num_levels] > level_ptr[0])
      *launched = 1;
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
// level_ptr[num_levels]) (z_in != z_out).
extern "C" int tri_solve_launch(int dtype, int device, int mode,
                                const long long* level_ptr,
                                const long long* level_shift,
                                int num_levels, int unit_diag,
                                const void* level_rows, const void* dep_ptr,
                                const void* dep_cols, const void* dep_vals,
                                const void* diag_inv, const void* b,
                                const void* z_in, void* z_out, int threads,
                                void* stream, long long* launched) {
  using namespace spmv_tpu_torch;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const TriArgs a{static_cast<const int*>(level_rows),
                  static_cast<const int*>(dep_ptr),
                  static_cast<const int*>(dep_cols),
                  dep_vals, diag_inv, b, z_in, z_out, unit_diag != 0,
                  threads, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case kFloat32:
      return run<float>(mode, level_ptr, level_shift, num_levels, a,
                        launched);
    case kFloat64:
      return run<double>(mode, level_ptr, level_shift, num_levels, a,
                         launched);
    default:
      return cudaErrorInvalidValue;
  }
}

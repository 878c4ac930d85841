"""The triangular solve's wrapper (``csrc/tri_solve.cu``) and its plain
version.

``tri_solve_core(T, b)`` solves ``T z = b`` for a ``DeviceTriSolve`` in
the mode ``tri_solve_plan(T)`` picks: one launch a level (``"levels"``),
or one launch for the whole solve, each row waiting until its
dependencies are published in this solve (``"chained"``); both give the
same bits.  With ``sweeps=k`` it
runs k Jacobi sweeps from z = 0 instead (``tri_solve_sweeps``).  It
replaces no Pallas kernel: the JAX package runs both as a ``lax.scan`` /
``fori_loop`` in XLA (``spmv_tpu/ops/incomplete.py:363-378, :399-419``).
On a CUDA tensor it launches the kernel (a level a launch, one chained
launch over the container's tickets, words and counters, or a sweep a
launch over two buffers), with the launch discipline of ``ops/_launch.py``; the
kernel reads ``level_rows`` only where the levels are not contiguous row
ranges and ``diag_inv`` only where ``T.unit_diag`` is false.  On a CPU
tensor it runs the plain version (``tri_solve_reference``,
``tri_sweeps_reference``: a level's gather, sum and scatter in a Python
loop; the chained mode computes the level mode's z, so its plain version
is the same); anything else raises.  ``tri_solve_core.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.ops._launch import (
    check_no_alias,
    check_vector,
    on_cuda,
    raise_on,
    stream_of,
)

__all__ = ["tri_solve_core", "tri_solve_plan", "tri_solve_reference",
           "tri_sweeps_reference"]

THREADS_PER_BLOCK = 256
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
# the modes of tri_solve_launch (TriMode in csrc/tri_solve.cu)
LEVELS = 0
SWEEP = 1
CHAINED = 2
_MODES = {"levels": LEVELS, "chained": CHAINED}
# The chained launch: threads a block, and its grid: warps for
# CHAIN_LEVELS_AHEAD levels of tickets of the widest level, at most
# CHAIN_MAX_WARPS (a quarter of what an H100 holds resident).  Its warps
# take their tickets from a counter, so the grid need not be resident;
# more warps than the chain of levels can feed would only poll.
CHAIN_THREADS = 64
CHAIN_LEVELS_AHEAD = 8
CHAIN_MAX_WARPS = 2048
# tri_solve_plan's line: the chained mode where there are at least
# CHAIN_MIN_LEVELS levels and they hold at most CHAIN_MAX_ROWS_A_LEVEL
# rows each on average.
CHAIN_MIN_LEVELS = 3
CHAIN_MAX_ROWS_A_LEVEL = 65536


def tri_solve_plan(T) -> str:
    """The mode a solve of ``T`` launches in: ``"chained"`` (one launch,
    each row waiting on its dependencies) where T has at least
    ``CHAIN_MIN_LEVELS`` levels and they hold at most
    ``CHAIN_MAX_ROWS_A_LEVEL`` rows each on average, else ``"levels"``
    (one launch a level).

    Many narrow levels (natural order: IC(0) of poisson2d(1024²) has
    2,047 of at most 1,024 rows) cost a launch each in the level mode,
    about 1.7 us in a CUDA graph, against a hand-off through the L2
    chained.  Wide levels (after ``--reorder color``: 2 of 8.4M rows at
    poisson2d(4096²)) cost their bytes, and the chained mode adds its
    words and its ticket counter (about 45 ps a row); with two levels it
    saves one launch at most.  The line, measured on an H100 (700 W,
    float32, a CUDA graph, the L2 flushed; ``chip_smoke.py`` phase 28) on
    layered triangles: of 2^21 rows, levels of 65,536 rows took 0.094 ms
    chained and 0.125 a level a launch, levels of 131,072 rows 0.094 and
    0.072; of 2^16 rows in 2 levels, 0.0090 and 0.0070."""
    chained = (T.num_levels >= CHAIN_MIN_LEVELS
               and T.n <= CHAIN_MAX_ROWS_A_LEVEL * T.num_levels)
    return "chained" if chained else "levels"


def _walk(T):
    """The plain versions' index arrays: each level's rows, and each
    dependency's column and the position of the row it belongs to, as
    int64 (one pass over the factor a solve, not one a level)."""
    counts = (T.dep_ptr[1:] - T.dep_ptr[:-1]).long()
    pos = torch.repeat_interleave(
        torch.arange(T.n, device=counts.device), counts,
        output_size=T.num_deps)
    return T.level_rows.long(), T.dep_cols.long(), pos


def _level_sum(T, z, cols, pos, s: int, e: int, d0: int,
               d1: int) -> torch.Tensor:
    """sum_j T[i, j] z[j] for the rows at positions [s, e), whose
    dependencies are entries [d0, d1), each row's added in CSR order."""
    prod = T.dep_vals[d0:d1] * z[cols[d0:d1]]
    return torch.zeros(e - s, dtype=z.dtype, device=z.device).index_add_(
        0, pos[d0:d1] - s, prod)


def tri_solve_reference(T, b: torch.Tensor) -> torch.Tensor:
    """The plain version of the level mode: z = 0, then for each level in
    order, z[rows] = (b[rows] - T[rows, :] z) * diag_inv."""
    z = torch.zeros(T.n, dtype=T.dep_vals.dtype, device=b.device)
    rows_all, cols, pos = _walk(T)
    lp, ld = T.level_ptr.tolist(), T.level_dep_ptr.tolist()
    for l in range(T.num_levels):
        s, e = lp[l], lp[l + 1]
        rows = rows_all[s:e]
        z[rows] = (b[rows] - _level_sum(T, z, cols, pos, s, e, ld[l],
                                        ld[l + 1])) * T.diag_inv[s:e]
    return z


def tri_sweeps_reference(T, b: torch.Tensor, sweeps: int) -> torch.Tensor:
    """The plain version of the sweep mode: z = 0, then ``sweeps`` times
    z <- (b - (T - D) z) * diag_inv, every row reading the old z."""
    z = torch.zeros(T.n, dtype=T.dep_vals.dtype, device=b.device)
    rows, cols, pos = _walk(T)
    for _ in range(sweeps):
        nz = torch.empty_like(z)
        nz[rows] = (b[rows] - _level_sum(T, z, cols, pos, 0, T.n, 0,
                                         T.num_deps)) * T.diag_inv
        z = nz
    return z


def chain_grid(T) -> int:
    """Blocks of the chained launch: CHAIN_LEVELS_AHEAD levels of the
    widest level's tickets, a warp a ticket, at most CHAIN_MAX_WARPS."""
    warps = min(CHAIN_MAX_WARPS,
                CHAIN_LEVELS_AHEAD * -(-max(T.width, 1) // 32))
    return -(-warps // (CHAIN_THREADS // 32))


def tri_solve_core(T, b: torch.Tensor, sweeps: int = None,
                   out: torch.Tensor = None, mode: str = None) -> torch.Tensor:
    """z = T^-1 b for a ``DeviceTriSolve``, in ``mode`` (``"levels"`` or
    ``"chained"``; ``tri_solve_plan(T)`` when None), or with ``sweeps``
    (>= 0) that many Jacobi sweeps from z = 0; b in the factor's value
    dtype, length n.  ``out`` (not with sweeps; length n, not overlapping
    b) receives z; else z is a new tensor.  A chained solve uses T's
    words and counters: solves of one container run one at a time, in
    stream order."""
    dt = T.dep_vals.dtype
    if dt not in _DTYPE_CODE:
        raise KernelError(f"unsupported triangular factor dtype {dt}")
    for name in ("level_rows", "dep_ptr", "dep_cols", "ticket_ptr",
                 "chain_counters"):
        t = getattr(T, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise KernelError(f"triangular factor {name} must be "
                              "contiguous int32")
    check_vector("ready", T.ready, (T.n, 2 if dt == torch.float64 else 1),
                 torch.int64)
    check_vector("chain_counters", T.chain_counters, (3,), torch.int32)
    check_vector("b", b, (T.n,), dt)
    if sweeps is not None and sweeps < 0:
        raise KernelError(f"sweeps must be >= 0, got {sweeps}")
    if sweeps is not None and mode is not None:
        raise KernelError("mode is for the exact solve (a sweep is one "
                          "launch over every position)")
    mode = tri_solve_plan(T) if mode is None and sweeps is None else mode
    if sweeps is None and mode not in _MODES:
        raise KernelError(f"unknown triangular solve mode {mode!r}; "
                          f"expected one of {sorted(_MODES)}")
    if out is not None:
        if sweeps is not None:
            raise KernelError("out= is for the level mode and the "
                              "chained one (a sweep alternates two "
                              "buffers of its own)")
        check_vector("out", out, (T.n,), dt)
        check_no_alias(b, out)
    tensors = (T.level_rows, T.dep_ptr, T.dep_cols, T.dep_vals, T.diag_inv,
               T.ticket_ptr, T.ready, T.chain_counters, b) + (
                   () if out is None else (out,))
    if not on_cuda("triangular solve", *tensors):
        if sweeps is not None:
            return tri_sweeps_reference(T, b, sweeps)
        z = tri_solve_reference(T, b)
        return z if out is None else out.copy_(z)

    from spmv_tpu_torch.ops._build import load_library

    if sweeps is None and mode != "levels":
        # every row is written: no zeros first
        z = torch.empty(T.n, dtype=dt, device=b.device) if out is None else out
    else:
        # the level mode starts from z = 0, as the JAX scan does
        z = (torch.zeros(T.n, dtype=dt, device=b.device) if out is None
             else out.zero_())
    if T.n == 0 or sweeps == 0:
        return z
    lib = load_library()
    launched = ctypes.c_longlong(0)

    shift = None if T.level_shift is None else T.level_shift.ctypes.data
    chain_blocks = chain_grid(T)

    def launch(code, z_in, z_out):
        rc = lib.tri_solve_launch(
            _DTYPE_CODE[dt], b.device.index, code,
            T.level_ptr.ctypes.data, shift, T.num_levels, int(T.unit_diag),
            T.level_rows.data_ptr(),
            T.dep_ptr.data_ptr(), T.dep_cols.data_ptr(),
            T.dep_vals.data_ptr(), T.diag_inv.data_ptr(), b.data_ptr(),
            z_in.data_ptr(), z_out.data_ptr(), T.ticket_ptr.data_ptr(),
            T.num_tickets, T.ready.data_ptr(), T.chain_counters.data_ptr(),
            chain_blocks, CHAIN_THREADS if code == CHAINED
            else THREADS_PER_BLOCK,
            stream_of(b), ctypes.byref(launched))
        tri_solve_core.launches += launched.value
        raise_on(lib, rc, "tri_solve")

    if sweeps is None:
        launch(_MODES[mode], z, z)
        return z
    other = torch.empty_like(z)
    for _ in range(sweeps):
        launch(SWEEP, z, other)
        z, other = other, z
    return z


tri_solve_core.launches = 0

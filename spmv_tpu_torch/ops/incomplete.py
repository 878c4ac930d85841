"""Incomplete factorizations and level-scheduled triangular solves.

The port's counterpart of ``spmv_tpu/ops/incomplete.py``: IC(0) / ILU(0)
preconditioning for the CG, BiCGSTAB and GMRES solvers.  Rows of a
triangular factor group into dependency levels (row i's level is one
past the largest level of the rows it reads); a level's rows are solved
together.

- The factorizations (``ic0_factor``, ``ilu0_factor``), the level
  schedule and the host helpers are the JAX package's numpy code,
  copied, with the native kernels of ``csrc/ic0.cpp`` loaded through
  ``ops._ic_native``.
- **DeviceTriSolve** (the "levels" method, the CLI's): the rows in level
  order, ``level_ptr`` bounding each level, and a CSR of each row's
  off-diagonal dependencies in that order.  The JAX container pads every
  level to the widest (W rows) and every row to the most dependencies
  (``max_deps``), (NL, W, max_deps) tiles for a ``lax.scan``; at natural
  order on poisson2d(4096²) that is 8,191 levels of 4,096 slots for
  16.8M rows.  The port stores no padding (its padding slots added
  ``0 * z[n]``), and its solve is the hand-written kernel of
  ``ops.tri_kernels`` (``csrc/tri_solve.cu``): one launch a level where
  the levels are few and wide, one launch for the whole solve (each row
  waiting until its dependencies are published) where they are many and
  narrow (``tri_solve_plan``).
  ``num_levels``, ``width``, ``max_deps`` and ``padding_factor`` keep
  the JAX definitions, which the CLI reports.
- **tri_solve_sweeps** (the "sweeps" method): Jacobi iteration on the
  same arrays, ``z <- D^-1 (b - (T - D) z)``, every row reading the old
  z, exact after ``num_levels`` sweeps: the same kernel, one launch a
  sweep over two buffers.
- **BlockTriSolve** (``method="auto"`` or ``"blocks"``, where the levels
  are contiguous row ranges, as after ``--reorder color``): each level
  is a slice update plus one SpMV of its rectangular dependency block
  through the port's ``DeviceDia`` (K1) or ``DeviceCsr`` (the CSR
  kernel).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.models.csr import CsrMatrix

__all__ = [
    "ic0_factor",
    "ilu0_factor",
    "build_level_schedule",
    "DeviceTriSolve",
    "BlockTriSolve",
    "tri_solve_sweeps",
    "ic0_preconditioner",
    "ilu0_preconditioner",
]


# ------------------------------------------------------------------ host

def _csr_arrays(m: CsrMatrix):
    """Unpadded (row_ptr, cols, vals) views of a host CSR matrix."""
    if int(m.row_ptr[-1]) != m.num_entries:
        # alignment-padding entries would pollute the factor's pattern
        raise MatrixError(
            "incomplete factorization requires an unpadded CSR "
            "(row_alignment=1)"
        )
    return (np.asarray(m.row_ptr, np.int64),
            np.asarray(m.column_index, np.int64),
            np.asarray(m.value, np.float64))


def ic0_factor(m: CsrMatrix, shift: float = 0.0,
               native: bool = True) -> CsrMatrix:
    """IC(0): lower-triangular L on lower(A)'s pattern, L L^T ~= A.

    Row-by-row left-looking update restricted to the pattern.  A
    non-positive pivot (A not SPD enough for the incomplete pattern)
    raises unless ``shift`` > 0 is supplied, in which case the
    factorization runs on A + shift*diag(A) (Manteuffel shift).

    ``native``: run the numeric update through csrc/ic0.cpp when the
    library is available (~100x the Python loop; the same output up to
    the order of a sparse dot's adds, which the lockstep test pins);
    pass False to force the Python path.
    """
    if m.num_rows != m.num_columns:
        raise MatrixError("ic0 requires a square matrix")
    rp, cols, vals = _csr_arrays(m)
    n = m.num_rows

    # sorted lower pattern (incl. diagonal), fully vectorized
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    order = np.lexsort((cols, rows))
    rs, cs, vs = rows[order], cols[order], vals[order]
    low = cs <= rs
    rs, lcols, lvals = rs[low], cs[low], \
        np.ascontiguousarray(vs[low], np.float64)
    is_diag = lcols == rs
    if int(is_diag.sum()) != n:
        bad = int(np.setdiff1d(
            np.arange(n), rs[is_diag], assume_unique=False)[0])
        raise MatrixError(f"ic0: row {bad} has no diagonal entry")
    if shift:
        lvals[is_diag] *= 1.0 + shift
    lrp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rs, minlength=n), out=lrp[1:])

    from spmv_tpu_torch.ops import _ic_native

    if native and _ic_native.available():
        code = _ic_native.ic0_inplace(lrp, lcols, lvals)
        if code:
            raise MatrixError(
                f"ic0: non-positive pivot at row {code - 1}; "
                "retry with a Manteuffel shift (shift=0.01 .. 0.1)"
            )
    else:
        for i in range(n):
            s, e = lrp[i], lrp[i + 1]
            ci = lcols[s:e]
            # off-diagonal entries first
            for t in range(e - s - 1):
                j = ci[t]
                sj, ej = lrp[j], lrp[j + 1]
                # dot of L[i, :j] and L[j, :j] over the pattern
                # intersection (both column-sorted)
                acc = _sorted_dot(
                    lcols[s:s + t], lvals[s:s + t],
                    lcols[sj:ej - 1], lvals[sj:ej - 1],
                )
                dj = lvals[ej - 1]
                lvals[s + t] = (lvals[s + t] - acc) / dj
            # diagonal
            off = lvals[s:e - 1]
            pivot = lvals[e - 1] - float(off @ off)
            if pivot <= 0.0:
                raise MatrixError(
                    f"ic0: non-positive pivot {pivot:.3e} at row {i}; "
                    "retry with a Manteuffel shift (shift=0.01 .. 0.1)"
                )
            lvals[e - 1] = np.sqrt(pivot)

    return CsrMatrix(
        num_rows=n, num_columns=n, num_entries=int(lrp[-1]),
        row_alignment=1, row_ptr=lrp,
        column_index=lcols.astype(np.int32), value=lvals,
    )


def _sorted_dot(c1, v1, c2, v2) -> float:
    """Dot product of two sparse rows given sorted column indices."""
    if c1.size == 0 or c2.size == 0:
        return 0.0
    i1 = np.searchsorted(c2, c1)
    ok = i1 < c2.size
    match = np.zeros(c1.size, dtype=bool)
    match[ok] = c2[i1[ok]] == c1[ok]
    if not match.any():
        return 0.0
    return float(v1[match] @ v2[i1[match]])


def ilu0_factor(m: CsrMatrix, native: bool = True) -> tuple:
    """ILU(0): (L_unit, U) on A's pattern, L U ~= A.

    IKJ-variant Gaussian elimination restricted to the pattern
    (Saad, Iterative Methods, alg. 10.4).  L has unit diagonal
    (stored without it); U holds the diagonal.  ``native`` as in
    :func:`ic0_factor`.
    """
    if m.num_rows != m.num_columns:
        raise MatrixError("ilu0 requires a square matrix")
    rp, cols, vals = _csr_arrays(m)
    n = m.num_rows

    # column-sorted copy + flat (i, i) slot lookup, fully vectorized
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    order = np.lexsort((cols, rows))
    rs = rows[order]
    a_cols = cols[order]
    a_vals = vals[order].copy()
    a_rp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rs, minlength=n), out=a_rp[1:])

    is_diag = a_cols == rs
    if int(is_diag.sum()) != n:
        bad = int(np.setdiff1d(np.arange(n), rs[is_diag])[0])
        raise MatrixError(f"ilu0: row {bad} has no diagonal entry")
    diag_slot = np.nonzero(is_diag)[0].astype(np.int64)

    from spmv_tpu_torch.ops import _ic_native

    a_vals = np.ascontiguousarray(a_vals, np.float64)
    if native and _ic_native.available():
        code = _ic_native.ilu0_inplace(a_rp, a_cols, a_vals, diag_slot)
        if code:
            raise MatrixError(f"ilu0: zero pivot at row {code - 1}")
    else:
        for i in range(1, n):
            s, e = a_rp[i], a_rp[i + 1]
            ci = a_cols[s:e]
            for t in range(e - s):
                k = ci[t]
                if k >= i:
                    break
                piv = a_vals[diag_slot[k]]
                if piv == 0.0:
                    raise MatrixError(f"ilu0: zero pivot at row {k}")
                lik = a_vals[s + t] / piv
                a_vals[s + t] = lik
                # subtract lik * U[k, j] for j > k in row i's pattern
                ks, ke = diag_slot[k] + 1, a_rp[k + 1]
                if ks < ke:
                    cj = a_cols[ks:ke]
                    pos = np.searchsorted(ci, cj)
                    ok = pos < ci.size
                    okm = np.zeros(cj.size, dtype=bool)
                    okm[ok] = ci[pos[ok]] == cj[ok]
                    a_vals[s + pos[okm]] -= lik * a_vals[ks:ke][okm]

    # split into L (strict lower, unit diag implied) and U (upper);
    # entries are already row-major + column-sorted, so boolean masks
    # preserve both orders
    low = a_cols < rs
    l_rp = np.zeros(n + 1, dtype=np.int64)
    u_rp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rs[low], minlength=n), out=l_rp[1:])
    np.cumsum(np.bincount(rs[~low], minlength=n), out=u_rp[1:])

    L = CsrMatrix(
        num_rows=n, num_columns=n, num_entries=int(l_rp[-1]),
        row_alignment=1, row_ptr=l_rp,
        column_index=a_cols[low].astype(np.int32),
        value=a_vals[low],
    )
    U = CsrMatrix(
        num_rows=n, num_columns=n, num_entries=int(u_rp[-1]),
        row_alignment=1, row_ptr=u_rp,
        column_index=a_cols[~low].astype(np.int32),
        value=a_vals[~low],
    )
    return L, U


# -------------------------------------------------------- level schedule

def build_level_schedule(rp, cols, n, lower: bool) -> list:
    """Group rows of a triangular matrix into dependency levels.

    ``lower``: dependencies are columns < row (forward solve order);
    otherwise columns > row (backward solve, computed in reverse).
    Returns a list of int64 row arrays, one per level.
    """
    from spmv_tpu_torch.ops import _ic_native

    if _ic_native.available():
        level = _ic_native.level_schedule(
            np.asarray(rp), np.asarray(cols), n, lower)
    else:
        level = np.zeros(n, dtype=np.int64)
        rows_iter = range(n) if lower else range(n - 1, -1, -1)
        for i in rows_iter:
            deps = cols[rp[i]:rp[i + 1]]
            deps = deps[deps < i] if lower else deps[deps > i]
            if deps.size:
                level[i] = level[deps].max() + 1
    nl = int(level.max()) + 1 if n else 0
    order = np.argsort(level, kind="stable")
    bounds = np.searchsorted(level[order], np.arange(nl + 1))
    return [order[bounds[k]:bounds[k + 1]] for k in range(nl)]



# ------------------------------------------------------------ device solves

class DeviceTriSolve:
    """Level-scheduled triangular solve operator, in the port's compact
    layout (no padding):

    - ``level_ptr`` (num_levels + 1,) int64, on the host: level l holds
      the positions ``level_ptr[l]:level_ptr[l + 1]``, and
      ``level_dep_ptr``, ``dep_ptr`` at those positions (host, for the
      plain version);
    - ``level_rows`` (n,) int32: the row at each position, levels in
      order, rows ascending within a level (``build_level_schedule``'s
      order);
    - ``dep_ptr`` (n + 1,) int32, ``dep_cols`` and ``dep_vals``: the
      off-diagonal entries of the row at each position, in the factor's
      CSR order (the JAX container's slot order);
    - ``diag_inv`` (n,): 1/diagonal of the row at each position (1 for a
      unit-diagonal factor, which the kernel then does not read);
    - ``level_shift`` (num_levels,) int64, on the host, or None: where
      every level's rows are a contiguous ascending range (as after
      ``--reorder color``), the row at position p of level l is
      ``p + level_shift[l]``, and the kernel does not read
      ``level_rows``;
    - the chained solve's layout and state (``csrc/tri_solve.cu``,
      ``tri_chained_kernel``): ``ticket_ptr`` (num_tickets + 1,) int32,
      the first position of each ticket, a run of at most
      ``CHAIN_TICKET_ROWS`` positions of one level (``chain_tickets``);
      ``ready`` (n, 1) int64 for a float32 factor, (n, 2) for float64,
      the words in which each row publishes its value and the solve's
      tag; and ``chain_counters`` (3,) int32, the epoch, ticket and done
      counters.  ``ready`` and ``chain_counters`` are zeros on the
      container's device, allocated once here, so the kernel allocates
      nothing and a CUDA graph of the solve replays it anew.

    ``solve`` computes ``z[i] = (b[i] - sum_j T[i, j] z[j]) * diag_inv``
    level by level, as the JAX scan does; the widths of the JAX layout
    (``width``, ``max_deps``, ``padding_factor``) are kept as numbers.
    """

    def __init__(self, n, level_ptr, level_dep_ptr, level_rows, dep_ptr,
                 dep_cols, dep_vals, diag_inv, width, max_deps, unit_diag,
                 level_shift=None):
        self.n = int(n)
        self.level_ptr = np.ascontiguousarray(level_ptr, np.int64)
        self.level_dep_ptr = np.ascontiguousarray(level_dep_ptr, np.int64)
        self.level_rows = level_rows
        self.dep_ptr = dep_ptr
        self.dep_cols = dep_cols
        self.dep_vals = dep_vals
        self.diag_inv = diag_inv
        self.width = int(width)
        self.max_deps = int(max_deps)
        self.unit_diag = bool(unit_diag)
        self.level_shift = level_shift
        dev = dep_ptr.device
        self.ticket_ptr = torch.from_numpy(
            chain_tickets(self.level_ptr).astype(np.int32)).to(dev)
        self.ready = torch.zeros(
            self.n, 2 if dep_vals.dtype == torch.float64 else 1,
            dtype=torch.int64, device=dev)
        self.chain_counters = torch.zeros(3, dtype=torch.int32, device=dev)

    @property
    def num_levels(self) -> int:
        return len(self.level_ptr) - 1

    @property
    def num_deps(self) -> int:
        return int(self.dep_cols.numel())

    @property
    def num_tickets(self) -> int:
        return int(self.ticket_ptr.numel()) - 1

    @classmethod
    def from_host(cls, t: CsrMatrix, lower: bool = True,
                  unit_diag: bool = False, dtype=None,
                  device=None) -> "DeviceTriSolve":
        """Build from a host triangular CSR factor.

        ``unit_diag``: the factor stores only strict off-diagonal
        entries and its diagonal is implicitly 1 (ILU's L).
        """
        from spmv_tpu_torch.models.device import default_value_dtype

        dtype = dtype or default_value_dtype()
        rp = np.asarray(t.row_ptr, np.int64)
        cols = np.asarray(t.column_index, np.int64)
        vals = np.asarray(t.value, np.float64)
        n = t.num_rows

        levels = build_level_schedule(rp, cols, n, lower)
        W = max((int(lv.size) for lv in levels), default=1)
        level_ptr = np.zeros(len(levels) + 1, dtype=np.int64)
        np.cumsum([lv.size for lv in levels], out=level_ptr[1:])
        order = (np.concatenate(levels) if levels
                 else np.zeros(0, np.int64))

        rows_flat = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
        diag, keep = _extract_diag(rows_flat, cols, vals, n, unit_diag)
        kr, kc, kv = rows_flat[keep], cols[keep], vals[keep]
        cnt = np.bincount(kr, minlength=n)
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(cnt, out=starts[1:])
        # the dependencies of the row at each position, in CSR order
        lengths = cnt[order]
        dep_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lengths, out=dep_ptr[1:])
        pos = np.repeat(np.arange(n, dtype=np.int64), lengths)
        src = starts[order][pos] + (np.arange(pos.size, dtype=np.int64)
                                    - dep_ptr[pos])
        if dep_ptr[-1] >= 2 ** 31 or n >= 2 ** 31:
            raise MatrixError("triangular factor too large for int32 "
                              "indices")

        def put(a, dt):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dt)

        return cls(
            n=n, level_ptr=level_ptr, level_dep_ptr=dep_ptr[level_ptr],
            level_rows=put(order.astype(np.int32), torch.int32),
            dep_ptr=put(dep_ptr.astype(np.int32), torch.int32),
            dep_cols=put(kc[src].astype(np.int32), torch.int32),
            dep_vals=put(kv[src], dtype),
            diag_inv=put(1.0 / diag[order], dtype),
            width=W, max_deps=max(int(cnt.max(initial=0)), 1),
            unit_diag=unit_diag, level_shift=_level_shift(level_ptr, order),
        )

    @property
    def padding_factor(self) -> float:
        """Slots a real row in the JAX container's padded (NL, W) layout:
        the level-skew diagnostic (the port stores no padding)."""
        return self.num_levels * self.width / max(self.n, 1)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """z = T^-1 b on the ``tri_solve`` kernel, in the mode
        ``tri_solve_plan`` picks (``tri_solve_core``)."""
        from spmv_tpu_torch.ops.tri_kernels import tri_solve_core

        return tri_solve_core(self, b.to(self.dep_vals.dtype).contiguous())


# Positions a ticket of the chained solve at most (kTicketRows in
# csrc/tri_solve.cu): a warp's lanes.
CHAIN_TICKET_ROWS = 32


def chain_tickets(level_ptr: np.ndarray) -> np.ndarray:
    """The chained solve's tickets: each level cut into runs of at most
    ``CHAIN_TICKET_ROWS`` positions, in order.  Returns the first
    position of each ticket and, last, the number of positions (int64),
    so ticket t covers ``[out[t], out[t + 1])`` and never straddles two
    levels."""
    level_ptr = np.asarray(level_ptr, np.int64)
    sizes = np.diff(level_ptr)
    counts = -(-sizes // CHAIN_TICKET_ROWS)
    level = np.repeat(np.arange(sizes.size), counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    starts = (level_ptr[:-1][level]
              + CHAIN_TICKET_ROWS * (np.arange(level.size) - first))
    return np.append(starts, level_ptr[-1]).astype(np.int64)


def _level_shift(level_ptr: np.ndarray, rows: np.ndarray):
    """Each level's row minus position, where that is one number a level
    (every level a contiguous ascending row range), else None."""
    shift = rows - np.arange(rows.size, dtype=np.int64)
    first = shift[np.minimum(level_ptr[:-1], max(rows.size - 1, 0))]
    sizes = np.diff(level_ptr)
    if not np.array_equal(shift, np.repeat(first, sizes)):
        return None
    return np.ascontiguousarray(first, np.int64)


def _extract_diag(rows_flat, cols, vals, n, unit_diag):
    """(diag, keep-mask) of a triangular factor's flat arrays; keep
    selects the off-diagonal (dependency) entries.  Vectorized — the
    per-row python loops cost seconds at production sizes."""
    if unit_diag:
        return np.ones(n, dtype=np.float64), np.ones(
            rows_flat.size, dtype=bool)
    is_d = cols == rows_flat
    found = np.bincount(rows_flat[is_d], minlength=n)
    if (found == 0).any():
        bad = int(np.nonzero(found == 0)[0][0])
        raise MatrixError(
            f"triangular factor row {bad} has no diagonal")
    diag = np.zeros(n, dtype=np.float64)
    diag[rows_flat[is_d]] = vals[is_d]
    return diag, ~is_d



def tri_solve_sweeps(t: DeviceTriSolve, b: torch.Tensor,
                     sweeps: int) -> torch.Tensor:
    """Approximate triangular solve by Jacobi iteration on the level
    structure's arrays, from z = 0: exact after ``num_levels`` sweeps,
    a standard preconditioner substitute after a handful.  Each sweep
    reads the previous sweep's z for every row (one kernel launch a
    sweep, ``tri_solve_core`` with ``sweeps``)."""
    from spmv_tpu_torch.ops.tri_kernels import tri_solve_core

    return tri_solve_core(t, b.to(t.dep_vals.dtype).contiguous(),
                          sweeps=int(sweeps))


# --------------------------------------------------------- preconditioners

def _pair_solver(Tl: CsrMatrix, Tu: CsrMatrix, unit_lower: bool,
                 method: str, sweeps: int, dtype, device):
    """Shared forward+backward solver builder for both factorizations.

    ``method``:
    - "auto": "blocks" when both triangles' levels are contiguous
      ranges and few (the multicolor case), else the "levels" solve;
    - "blocks": force the per-level SpMV path (``BlockTriSolve``);
    - "levels": the level-scheduled kernel (``DeviceTriSolve``);
    - "sweeps": Jacobi-iteration approximation, ``sweeps``/triangle.

    ``device``: where the factors live and the solves run;
    ``default_device()`` when None (the card unless the caller asks for
    the CPU).
    """
    from spmv_tpu_torch.models.device import resolve_device

    device = resolve_device(device)
    if method in ("auto", "blocks"):
        try:
            fwd = BlockTriSolve.from_host(
                Tl, lower=True, unit_diag=unit_lower, dtype=dtype,
                device=device)
            bwd = BlockTriSolve.from_host(Tu, lower=False, dtype=dtype,
                                          device=device)

            def apply(r):
                return bwd.solve(fwd.solve(r))
            info = {
                "levels_forward": fwd.num_levels,
                "levels_backward": bwd.num_levels,
                "block_formats": [
                    getattr(b, "format_name", "none")
                    for b in fwd.blocks + bwd.blocks
                ],
                "method": "blocks",
            }
            return apply, info
        except MatrixError:
            if method == "blocks":
                raise
            method = "levels"

    fwd = DeviceTriSolve.from_host(
        Tl, lower=True, unit_diag=unit_lower, dtype=dtype, device=device)
    bwd = DeviceTriSolve.from_host(Tu, lower=False, dtype=dtype,
                                   device=device)
    if method == "levels":
        def apply(r):
            return bwd.solve(fwd.solve(r))
    elif method == "sweeps":
        def apply(r):
            return tri_solve_sweeps(bwd, tri_solve_sweeps(
                fwd, r, sweeps), sweeps)
    else:
        raise ValueError(f"unknown tri-solve method {method!r}")
    info = {
        "levels_forward": fwd.num_levels,
        "levels_backward": bwd.num_levels,
        "level_width": fwd.width,
        "padding_factor": fwd.padding_factor,
        "method": method,
    }
    return apply, info


def ic0_preconditioner(L: CsrMatrix, method: str = "auto",
                       sweeps: int = 6, dtype=None, device=None):
    """M^-1 r = (L L^T)^-1 r from an IC(0) factor.

    See :func:`_pair_solver` for the method choices ("auto" picks the
    block SpMV path when the ordering allows).  Returns
    (apply_fn, info_dict).
    """
    return _pair_solver(L, _transpose_csr(L), unit_lower=False,
                        method=method, sweeps=sweeps, dtype=dtype,
                        device=device)


def ilu0_preconditioner(L: CsrMatrix, U: CsrMatrix,
                        method: str = "auto", sweeps: int = 6,
                        dtype=None, device=None):
    """M^-1 r = (L U)^-1 r from an ILU(0) factor (unit-diagonal L).

    See :func:`_pair_solver` for the method choices."""
    return _pair_solver(L, U, unit_lower=True, method=method,
                        sweeps=sweeps, dtype=dtype, device=device)


def _transpose_csr(m: CsrMatrix) -> CsrMatrix:
    """Host CSR transpose (unpadded)."""
    rp = np.asarray(m.row_ptr, np.int64)
    rows = np.repeat(np.arange(m.num_rows, dtype=np.int64),
                     np.diff(rp))
    cols = np.asarray(m.column_index, np.int64)
    vals = np.asarray(m.value, np.float64)
    order = np.lexsort((rows, cols))
    t_rows = cols[order]
    t_rp = np.zeros(m.num_columns + 1, dtype=np.int64)
    np.cumsum(np.bincount(t_rows, minlength=m.num_columns),
              out=t_rp[1:])
    return CsrMatrix(
        num_rows=m.num_columns, num_columns=m.num_rows,
        num_entries=m.num_entries, row_alignment=1,
        row_ptr=t_rp,
        column_index=rows[order].astype(np.int32),
        value=vals[order],
    )


# ------------------------------------------------- block-level tri solve

class BlockTriSolve:
    """Triangular solve as one SpMV a dependency level.

    When the levels are contiguous row ranges (what multicolor
    reordering gives: rows numbered color-major), a level needs no
    scatter:

        z[s_k:e_k] = (b[s_k:e_k] - T[s_k:e_k, :] @ z) * dinv[s_k:e_k]

    The dependency block ``T[s_k:e_k, :]`` is a rectangular sparse
    matrix held as a ``DeviceDia`` (K1) when it has few distinct
    diagonals, else as a ``DeviceCsr`` (the CSR kernel), so the solve is
    NL slice updates and at most NL SpMVs.
    """

    def __init__(self, n, starts, ends, blocks, diag_inv, dtype):
        self.n = n
        self.starts = starts          # python ints
        self.ends = ends
        self.blocks = blocks          # per level: device matrix or None
        self.diag_inv = diag_inv      # per level: (len,) tensor
        self.dtype = dtype

    @property
    def num_levels(self) -> int:
        return len(self.starts)

    @classmethod
    def from_host(cls, t: CsrMatrix, lower: bool = True,
                  unit_diag: bool = False, dtype=None,
                  max_levels: int = 64, max_diagonals: int = 96,
                  device=None) -> "BlockTriSolve":
        """Build from a host triangular factor whose dependency levels
        are contiguous row ranges (e.g. after ``--reorder color``).

        Raises MatrixError when levels are non-contiguous or too many
        (``max_levels``); callers fall back to the level or sweep
        solves.
        """
        from spmv_tpu_torch.models.device import (
            DeviceCsr,
            DeviceDia,
            default_value_dtype,
        )
        from spmv_tpu_torch.models.dia import DiaMatrix

        dtype = dtype or default_value_dtype()
        rp = np.asarray(t.row_ptr, np.int64)
        cols = np.asarray(t.column_index, np.int64)
        vals = np.asarray(t.value, np.float64)
        n = t.num_rows

        levels = build_level_schedule(rp, cols, n, lower)
        if len(levels) > max_levels:
            raise MatrixError(
                f"block tri-solve: {len(levels)} levels > "
                f"{max_levels}; use the level-scheduled path (or reorder "
                "with multicoloring)"
            )
        starts, ends = [], []
        for lv in levels:
            lv = np.sort(lv)
            if lv.size and not (np.diff(lv) == 1).all():
                raise MatrixError(
                    "block tri-solve requires contiguous level "
                    "ranges (color-major row numbering)"
                )
            starts.append(int(lv[0]) if lv.size else 0)
            ends.append(int(lv[-1]) + 1 if lv.size else 0)

        rows_flat = np.repeat(np.arange(n, dtype=np.int64),
                              np.diff(rp))
        diag, keep = _extract_diag(rows_flat, cols, vals, n, unit_diag)

        blocks, dinvs = [], []
        for s, e in zip(starts, ends):
            # dep entries of rows [s, e): everything except the
            # diagonal, one flat slice a level (levels are contiguous
            # row ranges, entries row-major)
            sl = slice(int(rp[s]), int(rp[e]) if e <= n else rp[-1])
            m = keep[sl]
            br = rows_flat[sl][m] - s
            bc = cols[sl][m]
            bv = vals[sl][m]
            if br.size == 0:
                blocks.append(None)
            else:
                brp = np.zeros(e - s + 1, dtype=np.int64)
                np.cumsum(np.bincount(br, minlength=e - s),
                          out=brp[1:])
                host = CsrMatrix(e - s, n, br.size, 1, brp,
                                 bc.astype(np.int32), bv)
                try:
                    dia = DiaMatrix.from_csr(
                        host, max_diagonals=max_diagonals)
                    blocks.append(DeviceDia.from_host(dia, dtype=dtype,
                                                      device=device))
                except MatrixError:
                    blocks.append(DeviceCsr.from_host(host, dtype=dtype,
                                                      device=device))
            dinvs.append(torch.from_numpy(1.0 / diag[s:e]).to(
                device=device, dtype=dtype))

        return cls(n, starts, ends, blocks, dinvs, dtype)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        from spmv_tpu_torch.ops.dispatch import spmv

        bf = b.to(self.dtype)
        z = torch.zeros(self.n, dtype=self.dtype, device=bf.device)
        for s, e, blk, dinv in zip(self.starts, self.ends,
                                   self.blocks, self.diag_inv):
            seg = bf[s:e]
            if blk is not None:
                seg = seg - spmv(blk, z)
            z[s:e] = seg * dinv
        return z

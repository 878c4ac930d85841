"""The port's IC(0) / ILU(0) factors, level schedules, triangular solves
(levels, sweeps, blocks), preconditioners and multicoloring against the
JAX package's, in fp64 on the CPU.

The factors and schedules are the same numpy code on both sides, so they
must be bitwise equal, on the native path (``csrc/ic0.cpp``) and on the
Python loops alike; the port's own two paths agree to reduction-order
rounding (rtol 1e-13, as the JAX package's own lockstep test).  The
solves must agree to rtol 1e-12 (relative max-norm): the port's
``DeviceTriSolve`` stores no padding, so its sums run over a row's real
dependencies where JAX's also add the padding slots' zeros; the plain
version of the ``tri_solve`` kernel runs here.  The multicolor order is
the same integers.  ``DeviceDia`` and ``DeviceCsr`` on a rectangular
matrix (``BlockTriSolve``'s dependency blocks) are held to a dense
product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _solver_mats import (
    banded_nonsym,
    convection_diffusion,
    csr_of,
    dense_of,
    poisson,
    renumber,
)

from spmv_tpu import ops as jops
from spmv_tpu.errors import MatrixError as JaxMatrixError
from spmv_tpu.io.generate import poisson2d as jax_poisson2d
from spmv_tpu.models import CsrMatrix as JaxCsr
from spmv_tpu.models import reorder as jax_reorder
from spmv_tpu.ops import _ic_native as jax_native
from spmv_tpu.ops import incomplete as jinc
from spmv_tpu_torch import ops
from spmv_tpu_torch.errors import KernelError, MatrixError
from spmv_tpu_torch.io.generate import (
    from_coo_arrays,
    poisson2d,
    random_sparse,
)
from spmv_tpu_torch.models import (
    CsrMatrix,
    DeviceCsr,
    DeviceDia,
    DiaMatrix,
    reorder,
)
from spmv_tpu_torch.models.device import DEVICE_ENV
from spmv_tpu_torch.ops import _ic_native, incomplete


@pytest.fixture(autouse=True)
def _fp64(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")   # the entry points' device
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture
def python_paths(monkeypatch):
    """Both packages without their native library: the Python loops."""
    monkeypatch.setattr(_ic_native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "available", lambda: False)


def _colored(coo):
    """The COO arrays renumbered by the port's multicolor order."""
    n, rows, cols, vals = coo
    mm = from_coo_arrays(n, n, rows, cols, vals)
    return renumber(coo, reorder.find_new_order_coloring(mm))


SPD = {"poisson": lambda: poisson(17, 13),
       "poisson_colored": lambda: _colored(poisson(17, 13))}
GENERAL = {"banded_random": lambda: banded_nonsym(300, 10, 5, seed=4),
           "convdiff": lambda: convection_diffusion(15, 12),
           "convdiff_colored": lambda: _colored(convection_diffusion(15, 12))}


def _csr_equal(got, want):
    assert (got.num_rows, got.num_columns, got.num_entries) == (
        want.num_rows, want.num_columns, want.num_entries)
    np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(got.column_index, want.column_index)
    np.testing.assert_array_equal(got.value, want.value)


# ---------------------------------------------------------------- factors

@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("shift", [0.0, 0.05])
@pytest.mark.parametrize("matrix", list(SPD))
def test_ic0_factor_bitwise_jax(matrix, shift, native):
    coo = SPD[matrix]()
    if native:
        assert _ic_native.available() and jax_native.available()
    _csr_equal(ops.ic0_factor(csr_of(coo, CsrMatrix), shift=shift,
                              native=native),
               jops.ic0_factor(csr_of(coo, JaxCsr), shift=shift,
                               native=native))


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("matrix", list(GENERAL))
def test_ilu0_factor_bitwise_jax(matrix, native):
    coo = GENERAL[matrix]()
    got = ops.ilu0_factor(csr_of(coo, CsrMatrix), native=native)
    want = jops.ilu0_factor(csr_of(coo, JaxCsr), native=native)
    for g, w in zip(got, want):
        _csr_equal(g, w)


def test_native_and_python_factors_in_lockstep():
    """The native factorizers mirror the Python loops: same patterns,
    values to reduction-order rounding."""
    m = csr_of(poisson(17, 13), CsrMatrix)
    Ln, Lp = ops.ic0_factor(m, native=True), ops.ic0_factor(m, native=False)
    np.testing.assert_array_equal(Ln.column_index, Lp.column_index)
    np.testing.assert_allclose(Ln.value, Lp.value, rtol=1e-13, atol=1e-15)
    g = csr_of(banded_nonsym(120, 8, 5, seed=16), CsrMatrix)
    for a, b in zip(ops.ilu0_factor(g, native=True),
                    ops.ilu0_factor(g, native=False)):
        np.testing.assert_array_equal(a.column_index, b.column_index)
        np.testing.assert_allclose(a.value, b.value, rtol=1e-13,
                                   atol=1e-15)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_factor_errors_match_jax(native):
    """A non-positive IC(0) pivot, a row with no diagonal, a padded CSR
    and a rectangular matrix raise MatrixError with the JAX messages."""
    A = np.diag([1.0, 1.0, 1.0, 1.0])
    A[0, 1] = A[1, 0] = 2.0
    rows, cols = np.nonzero(A)
    indefinite = (4, rows, cols, A[rows, cols])
    no_diag = (3, np.array([0, 1, 2]), np.array([0, 2, 1]),
               np.array([1.0, 1.0, 1.0]))
    cases = [("ic0", indefinite), ("ic0", no_diag), ("ilu0", no_diag)]
    for kind, coo in cases:
        with pytest.raises(JaxMatrixError) as want:
            getattr(jops, f"{kind}_factor")(csr_of(coo, JaxCsr),
                                            native=native)
        with pytest.raises(MatrixError) as got:
            getattr(ops, f"{kind}_factor")(csr_of(coo, CsrMatrix),
                                           native=native)
        assert str(got.value) == str(want.value)
    padded = CsrMatrix.from_matrix_market(poisson2d(5, 5), row_alignment=8)
    with pytest.raises(MatrixError, match="unpadded"):
        ops.ic0_factor(padded)
    rect = CsrMatrix.from_matrix_market(random_sparse(6, 4, 2, seed=1))
    with pytest.raises(MatrixError, match="square"):
        ops.ilu0_factor(rect)


# --------------------------------------------------------- level schedules

@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
@pytest.mark.parametrize("matrix", ["poisson", "convdiff_colored"])
def test_level_schedule_equal(matrix, lower, native, request):
    if not native:
        request.getfixturevalue("python_paths")
    coo = {**SPD, **GENERAL}[matrix]()
    m = csr_of(coo, CsrMatrix)
    L, U = ops.ilu0_factor(m)
    t = L if lower else U
    args = (np.asarray(t.row_ptr), np.asarray(t.column_index, np.int64),
            t.num_rows, lower)
    got = ops.build_level_schedule(*args)
    want = jops.build_level_schedule(*args)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------- solves

def _factors(matrix):
    """[(port triangle, JAX triangle, lower, unit_diag)] of the matrix:
    IC(0)'s L and L^T for the SPD ones, ILU(0)'s L and U for the rest."""
    coo = {**SPD, **GENERAL}[matrix]()
    if matrix in SPD:
        Lt = ops.ic0_factor(csr_of(coo, CsrMatrix))
        Lj = jops.ic0_factor(csr_of(coo, JaxCsr))
        return [(Lt, Lj, True, False),
                (incomplete._transpose_csr(Lt), jinc._transpose_csr(Lj),
                 False, False)]
    Lt, Ut = ops.ilu0_factor(csr_of(coo, CsrMatrix))
    Lj, Uj = jops.ilu0_factor(csr_of(coo, JaxCsr))
    return [(Lt, Lj, True, True), (Ut, Uj, False, False)]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("matrix", ["poisson", "poisson_colored",
                                    "banded_random", "convdiff_colored"])
def test_device_tri_solve_matches_jax(matrix):
    """The level solve (the tri_solve kernel's plain version) against
    JAX's scan, with JAX's num_levels, width, max_deps and
    padding_factor."""
    b = np.random.default_rng(9).standard_normal(_factors(matrix)[0][0]
                                                 .num_rows)
    for tt, tj, lower, unit in _factors(matrix):
        T = ops.DeviceTriSolve.from_host(tt, lower=lower, unit_diag=unit)
        J = jops.DeviceTriSolve.from_host(tj, lower=lower, unit_diag=unit)
        for name in ("n", "num_levels", "width", "max_deps",
                     "padding_factor"):
            assert getattr(T, name) == getattr(J, name), name
        assert T.num_deps == int((np.asarray(J.dep_vals) != 0).sum())
        got = T.solve(torch.from_numpy(b)).numpy()
        assert _rel(got, J.solve(jnp.asarray(b))) <= 1e-12


@pytest.mark.parametrize("sweeps", [1, 3, 6])
@pytest.mark.parametrize("matrix", ["poisson", "convdiff"])
def test_tri_solve_sweeps_match_jax(matrix, sweeps):
    b = np.random.default_rng(10).standard_normal(_factors(matrix)[0][0]
                                                  .num_rows)
    for tt, tj, lower, unit in _factors(matrix):
        T = ops.DeviceTriSolve.from_host(tt, lower=lower, unit_diag=unit)
        J = jops.DeviceTriSolve.from_host(tj, lower=lower, unit_diag=unit)
        got = ops.tri_solve_sweeps(T, torch.from_numpy(b), sweeps).numpy()
        want = jops.tri_solve_sweeps(J, jnp.asarray(b), sweeps)
        assert _rel(got, want) <= 1e-12


def test_tri_solve_layout_is_compact():
    """The rows in level order, each row's dependencies in CSR order, no
    padding slot: the factor's off-diagonal entries exactly once."""
    tt = _factors("poisson")[0][0]
    T = ops.DeviceTriSolve.from_host(tt)
    assert T.num_deps == tt.num_entries - tt.num_rows
    assert sorted(T.level_rows.tolist()) == list(range(tt.num_rows))
    assert T.level_ptr[-1] == tt.num_rows and T.dep_ptr[-1] == T.num_deps
    rp = np.asarray(tt.row_ptr)
    for p in (0, 17, tt.num_rows - 1):
        row = int(T.level_rows[p])
        s, e = int(T.dep_ptr[p]), int(T.dep_ptr[p + 1])
        np.testing.assert_array_equal(
            T.dep_cols[s:e].numpy(), tt.column_index[rp[row]:rp[row + 1] - 1])
        assert float(T.diag_inv[p]) == 1.0 / tt.value[rp[row + 1] - 1]
    np.testing.assert_array_equal(T.level_dep_ptr,
                                  T.dep_ptr.numpy()[T.level_ptr])


@pytest.mark.parametrize("matrix", ["poisson", "poisson_colored",
                                    "banded_random", "convdiff_colored"])
def test_tri_solve_level_shift(matrix):
    """``level_shift`` is given exactly where every level is a contiguous
    ascending row range (after coloring: both triangles), and then maps
    each position to its row, so the kernel need not read level_rows."""
    for tt, _, lower, unit in _factors(matrix):
        T = ops.DeviceTriSolve.from_host(tt, lower=lower, unit_diag=unit)
        rows = T.level_rows.numpy()
        contiguous = all(
            np.array_equal(np.diff(rows[s:e]), np.ones(e - s - 1))
            for s, e in zip(T.level_ptr[:-1], T.level_ptr[1:]))
        assert contiguous == matrix.endswith("colored"), (lower, unit)
        assert (T.level_shift is not None) == contiguous
        if contiguous:
            sizes = np.diff(T.level_ptr)
            np.testing.assert_array_equal(
                rows, np.arange(T.n) + np.repeat(T.level_shift, sizes))


def test_tri_solve_wrapper_refuses_what_the_kernel_does_not_take():
    T = ops.DeviceTriSolve.from_host(_factors("poisson")[0][0])
    with pytest.raises(KernelError, match="shape"):
        ops.tri_solve_core(T, torch.ones(T.n + 1))
    with pytest.raises(KernelError, match="dtype"):
        ops.tri_solve_core(T, torch.ones(T.n, dtype=torch.float32))
    with pytest.raises(KernelError, match="sweeps"):
        ops.tri_solve_core(T, torch.ones(T.n), sweeps=-1)
    with pytest.raises(KernelError, match="level mode"):
        ops.tri_solve_core(T, torch.ones(T.n), sweeps=2,
                           out=torch.empty(T.n))
    with pytest.raises(KernelError, match="out"):
        ops.tri_solve_core(T, torch.ones(T.n), out=torch.empty(T.n - 1))
    b = torch.ones(T.n)
    with pytest.raises(KernelError, match="overlap"):
        ops.tri_solve_core(T, b, out=b)
    out = torch.full((T.n,), float("nan"))
    assert ops.tri_solve_core(T, b, out=out) is out
    assert torch.equal(out, ops.tri_solve_core(T, b))
    bf = ops.DeviceTriSolve.from_host(_factors("poisson")[0][0],
                                      dtype=torch.bfloat16)
    with pytest.raises(KernelError, match="unsupported"):
        ops.tri_solve_core(bf, torch.ones(T.n, dtype=torch.bfloat16))


@pytest.mark.parametrize("max_diagonals", [96, 1], ids=["dia", "csr"])
@pytest.mark.parametrize("matrix", ["poisson_colored", "convdiff_colored"])
def test_block_tri_solve_matches_jax(matrix, max_diagonals):
    """BlockTriSolve after multicoloring: the same levels and block
    formats (DIA, or CSR past max_diagonals) as JAX's, the solve at rtol
    1e-12."""
    b = np.random.default_rng(11).standard_normal(_factors(matrix)[0][0]
                                                  .num_rows)
    kinds = set()
    for tt, tj, lower, unit in _factors(matrix):
        kw = dict(lower=lower, unit_diag=unit, max_diagonals=max_diagonals)
        B = ops.BlockTriSolve.from_host(tt, **kw)
        J = jinc.BlockTriSolve.from_host(tj, **kw)
        assert (B.starts, B.ends) == (J.starts, J.ends)
        fmts = [getattr(x, "format_name", "none") for x in B.blocks]
        assert fmts == [getattr(x, "format_name", "none") for x in J.blocks]
        kinds.update(fmts)
        got = B.solve(torch.from_numpy(b)).numpy()
        assert _rel(got, J.solve(jnp.asarray(b))) <= 1e-12
    assert kinds - {"none"} == {"dia" if max_diagonals > 1 else "csr"}


def test_block_tri_solve_refuses_natural_order():
    tt, tj, _, _ = _factors("poisson")[0]
    with pytest.raises(JaxMatrixError) as want:
        jinc.BlockTriSolve.from_host(tj)
    with pytest.raises(MatrixError) as got:
        ops.BlockTriSolve.from_host(tt)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("method", ["auto", "levels", "sweeps", "blocks"])
@pytest.mark.parametrize("kind,matrix", [("ic0", "poisson"),
                                         ("ic0", "poisson_colored"),
                                         ("ilu0", "convdiff"),
                                         ("ilu0", "convdiff_colored")])
def test_preconditioners_match_jax(kind, matrix, method):
    """ic0_preconditioner / ilu0_preconditioner: the same info dict (the
    block path only where the ordering allows it, as in JAX) and M^-1 r
    at rtol 1e-12."""
    coo = {**SPD, **GENERAL}[matrix]()
    mt, mj = csr_of(coo, CsrMatrix), csr_of(coo, JaxCsr)
    if kind == "ic0":
        make_t = lambda: ops.ic0_preconditioner(  # noqa: E731
            ops.ic0_factor(mt), method=method)
        make_j = lambda: jops.ic0_preconditioner(  # noqa: E731
            jops.ic0_factor(mj), method=method)
    else:
        make_t = lambda: ops.ilu0_preconditioner(  # noqa: E731
            *ops.ilu0_factor(mt), method=method)
        make_j = lambda: jops.ilu0_preconditioner(  # noqa: E731
            *jops.ilu0_factor(mj), method=method)
    if method == "blocks" and not matrix.endswith("colored"):
        with pytest.raises(JaxMatrixError):
            make_j()
        with pytest.raises(MatrixError):
            make_t()
        return
    (at, it), (aj, ij) = make_t(), make_j()
    assert it == ij
    r = np.random.default_rng(12).standard_normal(coo[0])
    assert _rel(at(torch.from_numpy(r)).numpy(), aj(jnp.asarray(r))) <= 1e-12


# ------------------------------------------------------------ multicolor

@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("matrix", ["poisson", "banded_random"])
def test_find_new_order_coloring_equal(matrix, native, request):
    if not native:
        request.getfixturevalue("python_paths")
    n, rows, cols, vals = {**SPD, **GENERAL}[matrix]()
    from spmv_tpu.io.generate import from_coo_arrays as jax_from_coo

    got = reorder.find_new_order_coloring(from_coo_arrays(n, n, rows, cols,
                                                          vals))
    want = jax_reorder.find_new_order_coloring(jax_from_coo(n, n, rows,
                                                            cols, vals))
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n))


def test_coloring_collapses_levels():
    mm = poisson2d(12, 12)
    m = CsrMatrix.from_matrix_market(mm.permute(
        reorder.find_new_order_coloring(mm)))
    jm = JaxCsr.from_matrix_market(jax_poisson2d(12, 12).permute(
        jax_reorder.find_new_order_coloring(jax_poisson2d(12, 12))))
    L = ops.ic0_factor(m)
    assert len(ops.build_level_schedule(
        L.row_ptr, L.column_index.astype(np.int64), m.num_rows, True)) == 2
    _csr_equal(L, jops.ic0_factor(jm))


# ------------------------------------------------ rectangular SpMV blocks

@pytest.mark.parametrize("shape", [(30, 70), (70, 30)], ids=["wide", "tall"])
def test_rectangular_dia_and_csr_spmv(shape):
    """DeviceDia (K1's plain version) and DeviceCsr (the CSR kernel's) on
    a non-square matrix, against the dense product."""
    mm = random_sparse(*shape, 4, seed=shape[0])
    rows = np.asarray(mm.rows_1based) - 1
    cols = np.asarray(mm.cols_1based) - 1
    dense = np.zeros(shape)
    np.add.at(dense, (rows, cols), np.asarray(mm.values))
    x = np.random.default_rng(13).standard_normal(shape[1])
    for A in (DeviceDia.from_host(DiaMatrix.from_matrix_market(mm)),
              DeviceCsr.from_host(CsrMatrix.from_matrix_market(mm))):
        y = ops.spmv(A, torch.from_numpy(x)).numpy()
        assert y.shape == (shape[0],)
        np.testing.assert_allclose(y, dense @ x, rtol=1e-12, atol=1e-14)


def test_level_solve_equals_dense():
    for matrix in ("poisson", "banded_random"):
        for tt, _, lower, unit in _factors(matrix):
            T = ops.DeviceTriSolve.from_host(tt, lower=lower,
                                             unit_diag=unit)
            n = tt.num_rows
            dense = dense_of((n, np.repeat(np.arange(n), np.diff(
                tt.row_ptr)), np.asarray(tt.column_index, np.int64),
                tt.value))
            if unit:
                np.fill_diagonal(dense, 1.0)
            b = np.arange(1.0, n + 1)
            got = T.solve(torch.from_numpy(b)).numpy()
            np.testing.assert_allclose(got, np.linalg.solve(dense, b),
                                       rtol=1e-10)

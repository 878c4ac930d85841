"""The chained triangular solve's host side, on the CPU: ``tri_solve_plan``
(which mode a solve launches in), ``DeviceTriSolve``'s device state (the
ready flags and the epoch, ticket and done counters), and a numpy walk in
the chained kernel's order (``csrc/tri_solve.cu``, ``tri_chained_kernel``)
held to the JAX package's ``DeviceTriSolve.solve`` at fp64 rtol 1e-12.

The walk takes the positions in ticket order (``ticket_ptr``: runs of at
most 32 positions of one level, in order) and sums each row's
dependencies in CSR order, as the kernel does.
At each dependency it asserts that the row it reads lies at a smaller
position and was already written: the invariant that the kernel's
freedom from deadlock rests on (a warp waits only on lower tickets,
which warps already running hold).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _solver_mats import (
    banded_nonsym,
    convection_diffusion,
    csr_of,
    poisson,
    renumber,
)

from spmv_tpu import ops as jops
from spmv_tpu.models import CsrMatrix as JaxCsr
from spmv_tpu.ops import incomplete as jinc
from spmv_tpu_torch import ops
from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.io.generate import from_coo_arrays
from spmv_tpu_torch.models import CsrMatrix, reorder
from spmv_tpu_torch.models.device import DEVICE_ENV
from spmv_tpu_torch.ops import incomplete, tri_kernels

TICKET_ROWS = 32      # kTicketRows in csrc/tri_solve.cu


@pytest.fixture(autouse=True)
def _fp64(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")   # the entry points' device
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _colored(coo):
    n, rows, cols, vals = coo
    mm = from_coo_arrays(n, n, rows, cols, vals)
    return renumber(coo, reorder.find_new_order_coloring(mm))


def _chain(n):
    """A symmetric tridiagonal matrix: its IC(0) and ILU(0) triangles are
    chains, every level one row."""
    i = np.arange(1, n)
    rows = np.concatenate([np.arange(n), i, i - 1])
    cols = np.concatenate([np.arange(n), i - 1, i])
    vals = np.concatenate([np.full(n, 2.0), np.full(2 * (n - 1), -0.5)])
    order = np.lexsort((cols, rows))
    return n, rows[order], cols[order], vals[order]


def _diagonal(n):
    """No dependency at all: one level."""
    return n, np.arange(n), np.arange(n), np.linspace(1.0, 3.0, n)


MATRICES = {
    "poisson": lambda: poisson(17, 13),
    "poisson_colored": lambda: _colored(poisson(17, 13)),
    "convdiff": lambda: convection_diffusion(15, 12),
    "convdiff_colored": lambda: _colored(convection_diffusion(15, 12)),
    "banded_random": lambda: banded_nonsym(300, 10, 5, seed=4),
    "chain": lambda: _chain(70),
    "diagonal": lambda: _diagonal(45),
}
# (matrix, factor kind): IC(0) of the symmetric matrices, ILU(0) of all
CASES = [(m, "ic0") for m in ("poisson", "poisson_colored", "chain",
                              "diagonal")] + [(m, "ilu0") for m in MATRICES]


def _factors(matrix, kind):
    """[(port triangle, JAX triangle, lower, unit_diag)]: IC(0)'s L and
    L^T, or ILU(0)'s unit L and U."""
    coo = MATRICES[matrix]()
    if kind == "ic0":
        Lt = ops.ic0_factor(csr_of(coo, CsrMatrix))
        Lj = jops.ic0_factor(csr_of(coo, JaxCsr))
        return [(Lt, Lj, True, False),
                (incomplete._transpose_csr(Lt), jinc._transpose_csr(Lj),
                 False, False)]
    Lt, Ut = ops.ilu0_factor(csr_of(coo, CsrMatrix))
    Lj, Uj = jops.ilu0_factor(csr_of(coo, JaxCsr))
    return [(Lt, Lj, True, True), (Ut, Uj, False, False)]


def _chained_walk(T, b):
    """z of the chained kernel's order: its tickets in order (runs of at
    most TICKET_ROWS positions of one level), each row's dependencies
    added in CSR order with the level kernel's expression; asserts that
    every row read lies at a smaller position and is done."""
    n = T.n
    rows = T.level_rows.numpy().astype(np.int64)
    dptr = T.dep_ptr.numpy().astype(np.int64)
    dcols = T.dep_cols.numpy().astype(np.int64)
    dvals = T.dep_vals.numpy()
    dinv = T.diag_inv.numpy()
    position = np.empty(n, np.int64)
    position[rows] = np.arange(n)
    done = np.zeros(n, bool)
    z = np.full(n, np.nan)
    tickets = T.ticket_ptr.numpy()
    level_of = np.repeat(np.arange(T.num_levels), np.diff(T.level_ptr))
    for t in range(T.num_tickets):
        run = range(tickets[t], tickets[t + 1])
        assert 0 < len(run) <= TICKET_ROWS
        assert len(set(level_of[list(run)])) == 1    # one level a ticket
        for p in run:
            row = rows[p]
            acc = 0.0
            for q in range(dptr[p], dptr[p + 1]):
                j = dcols[q]
                assert position[j] < p, (p, j)
                assert done[j], (p, j)
                acc = acc + dvals[q] * z[j]
            r = b[row] - acc
            z[row] = r if T.unit_diag else r * dinv[p]
            done[row] = True
    assert done.all()
    return z


@pytest.mark.parametrize("matrix,kind", CASES)
def test_chained_walk_matches_jax(matrix, kind):
    """The walk in the chained kernel's order on every factor kind the
    port builds (lower and upper, unit and not, natural and colored):
    every dependency at a smaller position, z at fp64 rtol 1e-12 of the
    JAX scan; the wrapper's chained mode (its plain version here) gives
    the walk's z too."""
    for tt, tj, lower, unit in _factors(matrix, kind):
        T = ops.DeviceTriSolve.from_host(tt, lower=lower, unit_diag=unit)
        J = jops.DeviceTriSolve.from_host(tj, lower=lower, unit_diag=unit)
        b = np.random.default_rng(12).standard_normal(T.n)
        got = _chained_walk(T, b)
        want = np.asarray(J.solve(jnp.asarray(b)))
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
        via = ops.tri_solve_core(T, torch.from_numpy(b), mode="chained")
        assert np.abs(via.numpy() - got).max() <= 1e-12 * np.abs(got).max()


def _plan(n, num_levels):
    """tri_solve_plan of a container with these counts."""
    return ops.tri_solve_plan(types.SimpleNamespace(n=n,
                                                    num_levels=num_levels))


@pytest.mark.parametrize("matrix,kind", CASES)
def test_plan_of_built_factors(matrix, kind):
    """The plan of each factor the port builds at test size: chained at
    natural order and for one-row levels (many narrow levels), a launch
    a level after coloring (2 levels) and for a single level."""
    for tt, _, lower, unit in _factors(matrix, kind):
        T = ops.DeviceTriSolve.from_host(tt, lower=lower, unit_diag=unit)
        want = "levels" if matrix.endswith("colored") or matrix == \
            "diagonal" else "chained"
        assert ops.tri_solve_plan(T) == want
        assert (T.num_levels >= 3) == (want == "chained")
        if matrix == "diagonal":
            assert T.num_levels == 1
        if matrix == "chain":
            assert T.num_levels == T.n


def test_plan_at_full_size():
    """The plan at the shapes the solvers path runs: the natural-order
    IC(0) triangles of poisson2d(1024²) (2,047 levels) and (4096²)
    (8,191) chain; the colored ILU(0) triangles of poisson2d(4096²) and
    (256²) (2 levels) take a launch a level; the line at 3 levels and at
    CHAIN_MAX_ROWS_A_LEVEL rows a level; n = 0 launches nothing, in the
    level mode."""
    line = tri_kernels.CHAIN_MAX_ROWS_A_LEVEL
    assert tri_kernels.CHAIN_MIN_LEVELS == 3
    assert _plan(1 << 20, 2047) == "chained"
    assert _plan(1 << 24, 8191) == "chained"
    assert _plan(1 << 24, 2) == "levels"
    assert _plan(1 << 16, 2) == "levels"
    assert _plan(3, 3) == "chained"
    assert _plan(2, 2) == "levels"
    assert _plan(3 * line, 3) == "chained"
    assert _plan(3 * line + 1, 3) == "levels"
    assert _plan(1 << 20, 1) == "levels"
    assert _plan(0, 0) == "levels"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("n", [0, 1, 7, 300])
def test_device_state_of_the_container(n, dtype):
    """``ready`` (n, 1) int64 words for float32, (n, 2) for float64, and
    ``chain_counters`` (3,) int32: zeros on the container's device, made
    once per container; ``ticket_ptr`` is ``chain_tickets`` of its
    levels, as int32 on that device."""
    tt = CsrMatrix.from_matrix_market(from_coo_arrays(n, *_chain(n))) \
        if n else CsrMatrix(0, 0, 0, 1, np.zeros(1, np.int64),
                            np.zeros(0, np.int32), np.zeros(0))
    T = ops.DeviceTriSolve.from_host(tt, dtype=dtype, device="cpu")
    words = 2 if dtype == torch.float64 else 1
    for t, shape, dt in ((T.ready, (n, words), torch.int64),
                         (T.chain_counters, (3,), torch.int32)):
        assert t.dtype == dt and tuple(t.shape) == shape
        assert t.device == T.dep_ptr.device == torch.device("cpu")
        assert t.is_contiguous() and not t.any()
    assert T.ticket_ptr.dtype == torch.int32
    np.testing.assert_array_equal(T.ticket_ptr.numpy(),
                                  incomplete.chain_tickets(T.level_ptr))
    assert T.num_tickets == n            # a chain: one row a level
    b = torch.ones(n, dtype=dtype)
    assert torch.equal(ops.tri_solve_core(T, b, mode="chained"),
                       ops.tri_solve_core(T, b, mode="levels"))
    assert ops.tri_solve_plan(T) == ("chained" if n >= 3 else "levels")


@pytest.mark.parametrize("sizes", [[], [1], [32], [33], [1, 64, 65, 31, 5],
                                   [1000, 0, 3]])
def test_chain_tickets(sizes):
    """Tickets cut every level into runs of at most 32 positions, in
    order, cover every position once and never straddle two levels."""
    level_ptr = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    got = incomplete.chain_tickets(level_ptr)
    assert got[0] == 0 and got[-1] == level_ptr[-1]
    runs = np.diff(got)
    assert (runs > 0).all() and (runs <= TICKET_ROWS).all()
    assert len(runs) == sum(-(-s // TICKET_ROWS) for s in sizes)
    assert set(level_ptr) <= set(got)     # every level starts a ticket


def test_wrapper_refuses_bad_modes_and_state():
    """An unknown mode, a mode with sweeps, and words or counters of the
    wrong size or type raise before anything runs."""
    tt = _factors("poisson", "ic0")[0][0]
    T = ops.DeviceTriSolve.from_host(tt)
    b = torch.ones(T.n)
    with pytest.raises(KernelError, match="mode"):
        ops.tri_solve_core(T, b, mode="wavefront")
    with pytest.raises(KernelError, match="mode"):
        ops.tri_solve_core(T, b, sweeps=2, mode="chained")
    good = T.ready
    for bad in (torch.zeros(T.n - 1, 2, dtype=torch.int64),
                torch.zeros(T.n, 1, dtype=torch.int64),
                torch.zeros(T.n, 2, dtype=torch.int32)):
        T.ready = bad
        with pytest.raises(KernelError, match="ready"):
            ops.tri_solve_core(T, b)
    T.ready = good
    T.chain_counters = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(KernelError, match="chain_counters"):
        ops.tri_solve_core(T, b)

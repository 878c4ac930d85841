"""K2's host side: ``dia_spmm_plan`` and ``dia_spmm_windows``
(``spmv_tpu_torch/ops/dia_kernels.py``), and a numpy walk of the slab
path in the kernel's order (``csrc/dia_spmm.cu``).

- ``dia_spmm_plan`` at k = 1-17 for float64, float32 and bfloat16, with
  X and Y 16-byte aligned and not: the group width (16 bytes), rows a
  thread and a unit, the window rule, stage sizes that hold every copy
  in a CTA's shared memory, the row path only where k is one or two
  16-byte groups and the addresses allow it.
- The walk does what the kernel does, unit by unit and window by
  window, each thread's rows a pass apart: it cuts each window's rows of
  X and each diagonal's data out
  of byte buffers at the kernel's 16-byte aligned starts and ends (X
  placed at an aligned start, or 8 bytes past one as a view one float64
  past its storage's start), asserts that every value a thread reads lies
  inside what was copied and that every copy fits its stage, and adds
  the diagonals in order, clipped at both ends.  At k = 1-17 on a
  banded matrix whose offsets reach past both ends and on rectangular
  ones, in float64 (the slab path's plan, whichever path the default
  picks), its Y is held at rtol 1e-12 against the port's plain
  version (``dia_spmm_reference``) and JAX's ``dia_spmm`` in Pallas
  interpret mode, run as ``tests/test_torch_dia.py`` runs it.  Past 256
  groups a row (column chunks) the walk is held against the plain
  version.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.io.generate import from_coo_arrays
from spmv_tpu.models import DiaMatrix as JaxDiaMatrix
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import pallas_kernels as jpk
from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.models import DeviceDia, DiaMatrix
from spmv_tpu_torch.ops import dia_spmm_core, dia_spmm_plan
from spmv_tpu_torch.ops.dia_kernels import (
    MAX_ROW_GROUPS,
    MAX_WINDOW_DIAGS,
    SLAB_PASSES,
    SMEM_BYTES,
    SPMM_THREADS,
    dia_spmm_windows,
)
from spmv_tpu_torch.ops.spmv import dia_spmm_reference

DTYPES = (torch.float64, torch.float32, torch.bfloat16)
KS = tuple(range(1, 18))
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SPMV_TPU_TORCH_DEVICE", "cpu")


def _coo(n, m, offsets, seed):
    """An n x m matrix on the given diagonals, every in-range entry set."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, m - off))
        rows.append(i)
        cols.append(i + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return n, m, rows, cols, rng.standard_normal(rows.size)


# offsets that reach past both ends (|offset| close to n), runs of
# neighbours that share a window, and gaps wider than a unit's rows
MATRICES = {
    "banded": lambda: _coo(150, 150, (-140, -70, -9, -1, 0, 1, 2, 9, 40,
                                      41, 70, 149), 1),
    "tall": lambda: _coo(150, 120, (-149, -30, -2, 0, 1, 3, 100, 119), 2),
    "wide": lambda: _coo(90, 160, (-89, -5, 0, 4, 5, 6, 7, 8, 9, 10, 11,
                                   50, 159), 3),
}


@functools.lru_cache(maxsize=None)
def _matrix(case):
    n, m, rows, cols, vals = MATRICES[case]()
    port = DeviceDia.from_host(DiaMatrix.from_matrix_market(
        _port_coo(n, m, rows, cols, vals)), dtype=torch.float64)
    jax_dia = jdev.DeviceDia.from_host(JaxDiaMatrix.from_matrix_market(
        from_coo_arrays(n, m, rows, cols, vals)))
    return port, jax_dia


def _port_coo(n, m, rows, cols, vals):
    from spmv_tpu_torch.io.generate import from_coo_arrays as port_coo

    return port_coo(n, m, rows, cols, vals)


def _up16(a):
    return -(-a // 16) * 16


def _down16(a):
    return a // 16 * 16


def slab_walk(A, X, plan, x_base=0):
    """Y = A X in the slab path's order, from byte buffers cut as the
    kernel's bulk copies cut them (``X`` placed ``x_base`` bytes past a
    16-byte boundary).  Asserts every read inside its copy and every copy
    inside its stage."""
    data = A.data.numpy()
    offs = list(A.offsets)
    n, m = A.num_rows, A.num_columns
    k = X.shape[1]
    dt = data.dtype
    sz = dt.itemsize
    V = plan["width"]
    assert V == 16 // sz
    xbuf = np.zeros(_up16(x_base + X.size * sz) + 16, np.uint8)
    xbuf[x_base:x_base + X.size * sz] = np.frombuffer(
        np.ascontiguousarray(X, dt).tobytes(), np.uint8)
    dbuf = np.frombuffer(np.ascontiguousarray(data).tobytes(), np.uint8)
    dbuf = np.concatenate([dbuf, np.zeros(16, np.uint8)])
    B, chunks, chunk_cols = plan["rows"], plan["chunks"], plan["chunk_cols"]
    gpr = SPMM_THREADS if chunks > 1 else plan["groups"]
    passes = plan["passes"]
    assert B == passes * (SPMM_THREADS // gpr)
    # thread t's rows: t // gpr + q * pass for q < passes, where
    # t // gpr < pass; its group t % gpr
    t = np.arange(SPMM_THREADS)
    t = t[t // gpr < SPMM_THREADS // gpr]
    q = np.arange(passes)
    r_of = ((t // gpr)[None, :] + q[:, None] * (SPMM_THREADS // gpr)).ravel()
    g_of = np.tile(t % gpr, passes)
    Y = np.full((n, k), np.nan)
    tiles = -(-n // B)
    for u in range(tiles * chunks):
        i0 = (u // chunks) * B
        rows_here = min(B, n - i0)
        c0 = (u % chunks) * chunk_cols
        cc = min(k - c0, chunk_cols)
        col = g_of * V
        act = (r_of < rows_here) & (col < cc)
        r, g, col = r_of[act], g_of[act], col[act]
        acc = np.zeros((r.size, V))
        for first, last in plan["windows"]:
            lo = max(i0 + offs[first], 0)
            hi = min(i0 + offs[last] + rows_here, m)
            xs = x_base + (lo * k + c0) * sz
            xa = _down16(xs)
            nx = (_up16(xs + ((hi - lo - 1) * k + cc) * sz) - xa
                  if hi > lo else 0)
            assert nx <= plan["x_stage_bytes"]
            sx = np.frombuffer(xbuf[xa:xa + nx].tobytes(), dt)
            for d in range(first, last + 1):
                ds = (d * n + i0) * sz
                da = _down16(ds)
                nd = _up16(ds + rows_here * sz) - da
                assert nd <= plan["d_stage_bytes"]
                sd = np.frombuffer(dbuf[da:da + nd].tobytes(), dt)
                a = sd[(ds - da) // sz + r]
                j = i0 + r + offs[d]
                ok = (j >= 0) & (j < m)
                for c in range(V):
                    live = ok & (col + c < cc)
                    e = (xs - xa) // sz + (j - lo) * k + col + c
                    assert (e[live] >= 0).all() and (e[live] < sx.size).all()
                    acc[live, c] += a[live] * sx[e[live]]
        for c in range(V):
            live = col + c < cc
            Y[i0 + r[live], c0 + col[live] + c] = acc[live, c]
    return Y


# ---------------------------------------------------------------- the plan


@pytest.mark.parametrize("x_aligned", [True, False])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("k", KS)
def test_plan(k, dtype, x_aligned):
    offsets = (-1024, -1, 0, 1, 1024)
    plan = dia_spmm_plan(k, dtype, offsets, x_aligned, True)
    item = torch.empty(0, dtype=dtype).element_size()
    V = 16 // item
    assert plan["width"] == V
    assert plan["groups"] == -(-k // V)
    assert plan["row_ok"] == (k in (V, 2 * V) and x_aligned)
    assert MAX_ROW_GROUPS == 2
    assert plan["path"] == ("row" if plan["row_ok"] else "slab")
    assert (plan["chunks"], plan["chunk_cols"]) == (1, k)
    assert plan["span"] == SPMM_THREADS // plan["groups"]
    assert plan["passes"] == SLAB_PASSES == 4
    assert plan["rows"] == SLAB_PASSES * plan["span"]
    assert plan["windows"] == [(0, 0), (1, 3), (4, 4)]
    assert (plan["max_span"], plan["wdiags"]) == (2, 3)
    for key in ("x_stage_bytes", "d_stage_bytes"):
        assert plan[key] % 16 == 0
    assert plan["x_stage_bytes"] >= (2 + plan["rows"]) * k * item + 30
    assert plan["d_stage_bytes"] >= plan["rows"] * item + 30
    assert 2 <= plan["stages"] <= 8
    assert plan["smem_bytes"] <= SMEM_BYTES == 227 * 1024
    if plan["row_ok"]:
        assert dia_spmm_plan(k, dtype, offsets, x_aligned, True,
                             "row")["path"] == "row"
    else:
        with pytest.raises(KernelError, match="row path"):
            dia_spmm_plan(k, dtype, offsets, x_aligned, True, "row")
    assert dia_spmm_plan(k, dtype, offsets, x_aligned, False)["path"] == (
        "slab")


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("k", KS)
def test_plan_fits_a_ctas_shared_memory(k, dtype):
    """The fullest windows (8 neighbouring diagonals each) fit a CTA's
    shared memory in at least two stages; past what a CTA holds, the
    plan raises."""
    plan = dia_spmm_plan(k, dtype, tuple(range(-7, 9)), path="slab")
    assert plan["windows"] == [(0, 7), (8, 15)]
    assert plan["wdiags"] == MAX_WINDOW_DIAGS
    assert 2 <= plan["stages"] and plan["smem_bytes"] <= SMEM_BYTES
    with pytest.raises(KernelError, match="shared memory"):
        dia_spmm_plan(k, dtype, tuple(range(0, 120000, 2)), path="slab")


def test_plan_refuses_an_unknown_path():
    with pytest.raises(KernelError, match="no K2 path"):
        dia_spmm_plan(4, torch.float32, (0,), path="tiles")


@pytest.mark.parametrize("offsets, span, want", [
    ((), 8, []),
    ((0,), 8, [(0, 0)]),
    ((-4096, -1, 0, 1, 4096), 256, [(0, 0), (1, 3), (4, 4)]),
    # the first of a window sets its reach: 0 -> 8 fits, 9 does not
    ((0, 4, 8, 9, 17), 8, [(0, 2), (3, 4)]),
    # a window holds MAX_WINDOW_DIAGS diagonals at most
    (tuple(range(10)), 64, [(0, 7), (8, 9)]),
    # an offset below the one before starts a window
    ((0, 1, -1, 2), 64, [(0, 1), (2, 3)]),
    # column chunks: each diagonal alone
    ((-1, 0, 1), -1, [(0, 0), (1, 1), (2, 2)]),
])
def test_windows(offsets, span, want):
    assert MAX_WINDOW_DIAGS == 8
    assert dia_spmm_windows(offsets, span) == want


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_plan_takes_column_chunks_past_256_groups(dtype):
    item = torch.empty(0, dtype=dtype).element_size()
    V = 16 // item
    at = dia_spmm_plan(256 * V, dtype, (-1, 0, 1))
    assert (at["rows"], at["passes"], at["chunks"]) == (SLAB_PASSES,
                                                        SLAB_PASSES, 1)
    past = dia_spmm_plan(256 * V + 1, dtype, (-1, 0, 1))
    assert (past["rows"], past["passes"], past["chunks"],
            past["chunk_cols"]) == (1, 1, 2, 256 * V)
    assert past["windows"] == [(0, 0), (1, 1), (2, 2)]
    assert past["x_stage_bytes"] >= 256 * V * item + 30


# ---------------------------------------------------------------- the walk


@pytest.mark.parametrize("case", sorted(MATRICES))
@pytest.mark.parametrize("k", KS)
def test_walk_matches_plain_and_pallas(k, case):
    """The slab walk at k columns, X aligned and 8 bytes past a 16-byte
    boundary: the plain version and JAX's Pallas kernel at rtol 1e-12,
    float64."""
    A, Aj = _matrix(case)
    X = np.random.default_rng(10 + k).standard_normal((A.num_columns, k))
    want = dia_spmm_reference(A, torch.from_numpy(X)).numpy()
    pallas = np.asarray(jpk.dia_spmm(Aj, jnp.asarray(X), tile_rows=8,
                                     interpret=True))
    np.testing.assert_allclose(pallas, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    for x_base in (0, 8):
        plan = dia_spmm_plan(k, torch.float64, A.offsets, x_base == 0, True,
                             "slab")
        Y = slab_walk(A, X, plan, x_base)
        for ref in (want, pallas):
            np.testing.assert_allclose(Y, ref, rtol=RTOL,
                                       atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("k", [513, 700])
def test_walk_in_column_chunks(k):
    """Past 256 groups a row (float64: k > 512), units of one row and a
    chunk of 512 columns, each diagonal alone: the plain version."""
    A, _ = _matrix("tall")
    X = np.random.default_rng(k).standard_normal((A.num_columns, k))
    plan = dia_spmm_plan(k, torch.float64, A.offsets, False, True, "slab")
    assert plan["chunks"] == 2
    Y = slab_walk(A, X, plan, 8)
    want = dia_spmm_reference(A, torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(Y, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_cpu_wrapper_checks_the_path_it_is_asked_for():
    """On CPU tensors the wrapper runs the plain version, but a path
    that cannot take the inputs raises there as on the card."""
    A, _ = _matrix("banded")
    X = torch.ones(A.num_columns, 3, dtype=torch.float64)
    want = dia_spmm_reference(A, X)
    assert torch.equal(dia_spmm_core(A, X, path="slab"), want)
    with pytest.raises(KernelError, match="row path"):
        dia_spmm_core(A, X, path="row")

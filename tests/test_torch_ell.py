"""The port's ELL and hybrid formats (host copies, ``DeviceEll``,
``DeviceHybrid``, the ELL kernels' plain versions and the hybrid
product) against the JAX package.

Inputs come from numpy with fixed seeds: poisson2d(32, 32),
banded_random(500, 16, 6), powerlaw(600, 600, 6.0), random_sparse(300,
250, 5) with every third row and the last ten emptied, each with and
without ``skip_padding``, and the hybrid split at its 2/3-median width,
at width 0 (everything in the COO part) and at the longest row (an empty
COO part).  They go through both packages:

- the host copies' arrays equal JAX's bit for bit;
- the port's ``DeviceEll`` / ``DeviceHybrid`` built from the host
  matrix equal ``ell_from_spmv_tpu`` / ``hybrid_from_spmv_tpu`` of the
  JAX containers, and hold the JAX tiles transposed to slot-major;
- ``spmv`` and ``spmm`` (k = 1, 3, 8, 11), the plain versions the
  wrappers run for CPU tensors, against JAX's XLA ``spmv`` / ``spmm`` at
  rtol 1e-12 in float64 (the sums differ in order: the port adds slots
  0..L-1 in order, XLA's row sum and segment sum in no fixed order);
- the wrappers' checks, ``accumulate``, and the hybrid product's two
  launches (none on the COO part where it is empty).
"""

import numpy as np
import pytest
import torch

from spmv_tpu.io import generate as jgen
from spmv_tpu.models import EllMatrix as JEll
from spmv_tpu.models import HybridMatrix as JHybrid
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import spmm as jspmm
from spmv_tpu.ops import spmv as jspmv
from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.io import generate as pgen
from spmv_tpu_torch.models import (
    ELL_PAD_SENTINEL,
    DeviceEll,
    DeviceHybrid,
    EllMatrix,
    HybridMatrix,
    ell_from_spmv_tpu,
    hybrid_from_spmv_tpu,
)
from spmv_tpu_torch.models.device import LONG_ROW
from spmv_tpu_torch.ops import (
    ell_kernels,
    ell_spmm_core,
    ell_spmv_core,
    ell_spmv_reference,
    hybrid_spmm_core,
    hybrid_spmv_core,
    hybrid_spmv_reference,
    spmm,
    spmv,
)

RTOL = 1e-12
KS = (1, 3, 8, 11)


def _case(gen, name):
    if name == "poisson":
        return gen.poisson2d(32, 32)
    if name == "banded":
        return gen.banded_random(500, 16, 6, seed=3)
    if name == "powerlaw":
        return gen.powerlaw(600, 600, 6.0, seed=4)
    mm = gen.random_sparse(300, 250, 5, seed=5)          # "empty_rows"
    r = np.asarray(mm.rows_1based) - 1
    keep = (r % 3 != 1) & (r < 290)
    return gen.from_coo_arrays(300, 250, r[keep],
                               np.asarray(mm.cols_1based)[keep] - 1,
                               np.asarray(mm.values)[keep])


CASES = ("poisson", "banded", "powerlaw", "empty_rows")
# hybrid ELL widths: the 2/3 median, none, the longest row
WIDTHS = ("median", "zero", "longest")


def _width(mm, width):
    return {"median": None, "zero": 0,
            "longest": int(mm.max_row_length())}[width]


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _x(m, k=None, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(m if k is None else (m, k))


def _ell_pair(name, skip):
    p = EllMatrix.from_matrix_market(_case(pgen, name), skip_padding=skip)
    j = JEll.from_matrix_market(_case(jgen, name), skip_padding=skip)
    return p, j


def _hybrid_pair(name, width):
    pmm, jmm = _case(pgen, name), _case(jgen, name)
    L = _width(pmm, width)
    return (HybridMatrix.from_matrix_market(pmm, ell_row_length=L),
            JHybrid.from_matrix_market(jmm, ell_row_length=L))


@pytest.mark.parametrize("skip", [False, True], ids=["pad", "skip"])
@pytest.mark.parametrize("name", CASES)
def test_host_ell_matches_jax(name, skip):
    p, j = _ell_pair(name, skip)
    for f in ("num_rows", "num_columns", "num_entries", "row_length",
              "skip_padding", "num_padding_entries"):
        assert getattr(p, f) == getattr(j, f), f
    for f in ("column_index", "value"):
        a, b = getattr(p, f), getattr(j, f)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    x = _x(p.num_columns)
    np.testing.assert_array_equal(p.spmv(x), j.spmv(x))


HYBRID_FIELDS = ("ell_column_index", "ell_value", "coo_row_index",
                 "coo_column_index", "coo_value")


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", CASES)
def test_host_hybrid_matches_jax(name, width):
    p, j = _hybrid_pair(name, width)
    for f in ("num_rows", "num_columns", "num_entries", "ell_row_length",
              "num_ell_entries", "num_coo_entries", "num_padding_entries"):
        assert getattr(p, f) == getattr(j, f), f
    for f in HYBRID_FIELDS:
        a, b = getattr(p, f), getattr(j, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b)
    x = _x(p.num_columns)
    np.testing.assert_array_equal(p.spmv(x), j.spmv(x))
    if width == "longest":
        assert p.num_coo_entries == 0


def _same_ell(a: DeviceEll, b: DeviceEll):
    for f in ("num_rows", "num_columns", "num_entries", "row_length",
              "padded_row_length"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.column_index.dtype == b.column_index.dtype == torch.int32
    assert torch.equal(a.column_index, b.column_index)
    assert a.value.dtype == b.value.dtype
    assert torch.equal(a.value, b.value)


@pytest.mark.parametrize("skip", [False, True], ids=["pad", "skip"])
@pytest.mark.parametrize("name", CASES)
def test_device_ell_matches_jax_container(name, skip):
    p, j = _ell_pair(name, skip)
    A = DeviceEll.from_host(p, dtype=torch.float64, device="cpu")
    Aj = jdev.DeviceEll.from_host(j)
    _same_ell(A, ell_from_spmv_tpu(Aj))
    # slot-major, no row padding: the JAX tile transposed
    assert tuple(A.value.shape) == (max(p.row_length, 1), p.num_rows)
    cols = np.asarray(Aj.column_index)[: p.num_rows].T
    np.testing.assert_array_equal(A.column_index.numpy(), cols)
    if skip:
        assert (A.column_index.numpy() != ELL_PAD_SENTINEL).all()
        pad = p.column_index.T == ELL_PAD_SENTINEL
        assert (A.column_index.numpy()[pad] == 0).all()
        assert (A.value.numpy()[pad] == 0).all()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", CASES)
def test_device_hybrid_matches_jax_container(name, width):
    p, j = _hybrid_pair(name, width)
    A = DeviceHybrid.from_host(p, dtype=torch.float64, device="cpu")
    B = hybrid_from_spmv_tpu(jdev.DeviceHybrid.from_host(j))
    for f in ("num_rows", "num_columns", "num_entries"):
        assert getattr(A, f) == getattr(B, f), f
    _same_ell(A.ell, B.ell)
    assert A.ell.padded_row_length == max(p.ell_row_length, 1)
    for f in ("row_ptr", "column_index", "value"):
        assert torch.equal(getattr(A.coo, f), getattr(B.coo, f)), f
    # the short rows that own a COO entry (an empty tensor where none
    # does), None where every row owns one; the long ones apart
    lengths = np.bincount(p.coo_row_index, minlength=p.num_rows)
    if (lengths > 0).all():
        assert A.coo.row_list is None
    else:
        np.testing.assert_array_equal(
            A.coo.row_list.numpy(),
            np.flatnonzero((lengths > 0) & (lengths <= LONG_ROW)))
    long = np.flatnonzero(lengths > LONG_ROW)
    if long.size == 0:
        assert A.coo.long_rows is None
    else:
        assert sorted(A.coo.long_rows.tolist()) == long.tolist()


@pytest.mark.parametrize("skip", [False, True], ids=["pad", "skip"])
@pytest.mark.parametrize("name", CASES)
def test_ell_spmv_matches_jax(name, skip):
    p, j = _ell_pair(name, skip)
    A = DeviceEll.from_host(p, dtype=torch.float64, device="cpu")
    x = _x(p.num_columns)
    y = spmv(A, torch.from_numpy(x))
    want = np.asarray(jspmv(jdev.DeviceEll.from_host(j), x))
    assert y.dtype == torch.float64 and y.shape == (p.num_rows,)
    assert _rel(y.numpy(), want) <= RTOL
    assert _rel(y.numpy(), p.spmv(x)) <= RTOL


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", CASES)
def test_ell_spmm_matches_jax(name, k):
    p, j = _ell_pair(name, False)
    A = DeviceEll.from_host(p, dtype=torch.float64, device="cpu")
    X = _x(p.num_columns, k)
    Y = spmm(A, torch.from_numpy(X))
    want = np.asarray(jspmm(jdev.DeviceEll.from_host(j), X))
    assert Y.shape == (p.num_rows, k)
    assert _rel(Y.numpy(), want) <= RTOL
    # column j is the SpMV of column j, in the same order of adds
    for c in range(k):
        assert torch.equal(Y[:, c], ell_spmv_reference(
            A, torch.from_numpy(X[:, c].copy())))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", CASES)
def test_hybrid_spmv_matches_jax(name, width):
    p, j = _hybrid_pair(name, width)
    A = DeviceHybrid.from_host(p, dtype=torch.float64, device="cpu")
    x = _x(p.num_columns, seed=2)
    y = spmv(A, torch.from_numpy(x))
    want = np.asarray(jspmv(jdev.DeviceHybrid.from_host(j), x))
    assert _rel(y.numpy(), want) <= RTOL
    assert _rel(y.numpy(), p.spmv(x)) <= RTOL


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", ("powerlaw", "empty_rows"))
def test_hybrid_spmm_matches_jax(name, width, k):
    p, j = _hybrid_pair(name, width)
    A = DeviceHybrid.from_host(p, dtype=torch.float64, device="cpu")
    X = _x(p.num_columns, k, seed=3)
    Y = spmm(A, torch.from_numpy(X))
    want = np.asarray(jspmm(jdev.DeviceHybrid.from_host(j), X))
    assert _rel(Y.numpy(), want) <= RTOL
    assert _rel(Y.numpy(), hybrid_spmv_reference(
        A, torch.from_numpy(X)).numpy()) <= RTOL


@pytest.mark.parametrize("spmm_k", [None, 3])
@pytest.mark.parametrize("width", WIDTHS)
def test_hybrid_launches_the_csr_part_only_where_it_has_entries(
        width, spmm_k, monkeypatch):
    """The hybrid product is the ELL product, then the CSR product adding
    the COO part; none where that part is empty."""
    p, _ = _hybrid_pair("powerlaw", width)
    A = DeviceHybrid.from_host(p, dtype=torch.float64, device="cpu")
    calls = []
    name = "csr_spmv_core" if spmm_k is None else "csr_spmm_core"
    real = getattr(ell_kernels, name)

    def spy(B, v, out=None, accumulate=False):
        calls.append(accumulate)
        return real(B, v, out=out, accumulate=accumulate)

    monkeypatch.setattr(ell_kernels, name, spy)
    shape = (p.num_columns,) if spmm_k is None else (p.num_columns, spmm_k)
    v = torch.from_numpy(_x(*shape, seed=4))
    core = hybrid_spmv_core if spmm_k is None else hybrid_spmm_core
    y = core(A, v)
    assert calls == ([] if p.num_coo_entries == 0 else [True])
    assert _rel(y.numpy(), hybrid_spmv_reference(A, v).numpy()) <= RTOL
    out = torch.full_like(y, np.nan)
    assert core(A, v, out=out) is out
    assert torch.equal(out, y)


@pytest.mark.parametrize("spmm_k", [None, 3])
def test_ell_wrappers_accumulate_and_out(spmm_k):
    p, _ = _ell_pair("banded", False)
    A = DeviceEll.from_host(p, dtype=torch.float64, device="cpu")
    shape = (p.num_columns,) if spmm_k is None else (p.num_columns, spmm_k)
    v = torch.from_numpy(_x(*shape, seed=5))
    core = ell_spmv_core if spmm_k is None else ell_spmm_core
    want = ell_spmv_reference(A, v)
    out = torch.full_like(want, 0.5)
    assert core(A, v, out=out, accumulate=True) is out
    assert _rel(out.numpy(), (want + 0.5).numpy()) <= RTOL
    assert torch.equal(core(A, v, out=torch.empty_like(want)), want)


def test_ell_wrappers_refuse_what_the_kernels_do_not_take():
    p, _ = _ell_pair("poisson", False)
    A = DeviceEll.from_host(p, dtype=torch.float64, device="cpu")
    x = torch.ones(p.num_columns, dtype=torch.float64)
    X = torch.ones(p.num_columns, 2, dtype=torch.float64)
    with pytest.raises(KernelError, match="dtype"):
        ell_spmv_core(A, x.float())
    with pytest.raises(KernelError, match="shape"):
        ell_spmv_core(A, x[:-1])
    with pytest.raises(KernelError, match="needs an out"):
        ell_spmv_core(A, x, accumulate=True)
    with pytest.raises(KernelError, match="overlap"):
        ell_spmv_core(A, x, out=x)
    with pytest.raises(KernelError, match="contiguous"):
        ell_spmm_core(A, torch.ones(2, p.num_columns,
                                    dtype=torch.float64).t())
    with pytest.raises(KernelError, match="X must be"):
        ell_spmm_core(A, x)
    with pytest.raises(KernelError, match="different devices"):
        ell_spmm_core(A, X.to("meta"))
    M = DeviceEll.from_host(p, dtype=torch.float64, device="meta")
    with pytest.raises(KernelError, match="no ELL kernel"):
        ell_spmv_core(M, x.to("meta"))
    B = DeviceEll.from_host(p, dtype=torch.bfloat16, device="cpu")
    with pytest.raises(KernelError, match="unsupported ELL value dtype"):
        ell_spmv_core(B, x.to(torch.bfloat16))


def test_one_shot_wrappers_cast_x():
    p, _ = _hybrid_pair("powerlaw", "median")
    A = DeviceHybrid.from_host(p, dtype=torch.float64, device="cpu")
    x = torch.from_numpy(_x(p.num_columns, seed=6)).float()
    y = spmv(A, x)
    assert y.dtype == torch.float64
    assert _rel(y.numpy(), p.spmv(x.double().numpy())) <= RTOL
    Y = spmm(A.ell, torch.stack([x, x], dim=1))
    assert Y.dtype == torch.float64 and torch.equal(Y[:, 0], Y[:, 1])

"""The CSR kernels' row split and their order of adds on long rows, on
the CPU.

- ``csr_row_split`` (``spmv_tpu_torch/models/device.py``): the long, the
  short and the empty rows partition a matrix's rows, the long ones
  longest first (ties by row), None on stencils and banded matrices; the
  row list holds exactly the short rows that own an entry; ``DeviceCsr``
  holds the split its module's thresholds give.
- A numpy walk in the kernels' order (``tests/_csr_walk.py``: strided
  lane sums, the warp's shuffle tree, the block's tree), with the
  thresholds small so that powerlaw(4096, 4096, 8.0, seed 5) has warp
  rows and block rows, held against ``csr_spmv_reference`` and against
  the JAX package's ``spmv`` / ``spmm`` on its ``DeviceCsr`` and
  ``DeviceHybrid`` from the same host matrix, rtol 1e-12 in float64 (the
  sums differ in order), SpMV and SpMM at k = 1, 3, 8; each column of
  the SpMM walk is bitwise the SpMV walk of that column.
- The walk's vectorised trees against a step-by-step run of the
  kernels' shuffles, and the hybrid product (the wrappers' plain path)
  on a container with long rows against JAX.
"""

import numpy as np
import pytest
import torch
from _csr_walk import BLOCK, WARP, _long_row_sum, csr_walk

from spmv_tpu.io import generate as jgen
from spmv_tpu.models import CsrMatrix as JCsr
from spmv_tpu.models import HybridMatrix as JHybrid
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import spmm as jspmm
from spmv_tpu.ops import spmv as jspmv
from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.io import generate as pgen
from spmv_tpu_torch.models import (
    CsrMatrix,
    DeviceCsr,
    DeviceHybrid,
    HybridMatrix,
)
from spmv_tpu_torch.models import device as pdev
from spmv_tpu_torch.ops import (
    csr_spmm_core,
    csr_spmv_core,
    csr_spmv_reference,
    ell_spmv_reference,
    spmm,
    spmv,
)

RTOL = 1e-12
# small thresholds: powerlaw(4096)'s hybrid COO part (longest row 526)
# then has 180 warp rows and 6 block rows
SMALL = (16, 128)
KS = (None, 1, 3, 8)


def _mm(gen, name):
    if name == "poisson":
        return gen.poisson2d(32, 32)
    if name == "banded":
        return gen.banded_random(500, 16, 6, seed=3)
    if name == "empty_rows":
        mm = gen.powerlaw(3000, 2000, 8.0, seed=6)
        r = np.asarray(mm.rows_1based) - 1
        keep = r % 4 != 1
        return gen.from_coo_arrays(3000, 2000, r[keep],
                                   np.asarray(mm.cols_1based)[keep] - 1,
                                   np.asarray(mm.values)[keep])
    return gen.powerlaw(4096, 4096, 8.0, seed=5)         # "powerlaw"


def _host(name, part):
    """(row_ptr, column_index, value, num_columns) of a case: the whole
    matrix or its hybrid COO part."""
    mm = _mm(pgen, name)
    if part == "whole":
        h = CsrMatrix.from_matrix_market(mm)
        stored = int(h.row_ptr[-1])
        return (np.asarray(h.row_ptr, np.int64), h.column_index[:stored],
                h.value[:stored], h.num_columns)
    h = HybridMatrix.from_matrix_market(mm)
    R = DeviceHybrid.from_host(h, dtype=torch.float64, device="cpu").coo
    return (R.row_ptr.numpy().astype(np.int64), R.column_index.numpy(),
            R.value.numpy(), R.num_columns)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _x(m, k, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(m if k is None else (m, k))


@pytest.fixture
def small(monkeypatch):
    """The module's thresholds set small while the containers are built."""
    monkeypatch.setattr(pdev, "LONG_ROW", SMALL[0])
    monkeypatch.setattr(pdev, "BLOCK_ROW", SMALL[1])


@pytest.mark.parametrize("limits", [SMALL, (pdev.LONG_ROW, pdev.BLOCK_ROW)],
                         ids=["small", "module"])
@pytest.mark.parametrize("case", [
    ("poisson", "whole"), ("banded", "whole"), ("empty_rows", "whole"),
    ("powerlaw", "whole"), ("powerlaw", "coo")], ids="-".join)
def test_row_split_partitions_the_rows(case, limits):
    row_ptr = _host(*case)[0]
    long_row, block_row = limits
    long_rows, num_block, row_list = pdev.csr_row_split(row_ptr, long_row,
                                                        block_row)
    n = np.diff(row_ptr)
    want_long = np.flatnonzero(n > long_row)
    if case[0] in ("poisson", "banded"):
        assert long_rows is None and num_block == 0
    if want_long.size == 0:
        assert long_rows is None and num_block == 0
    else:
        assert long_rows.dtype == np.int32
        assert sorted(long_rows.tolist()) == want_long.tolist()
        ln = n[long_rows]
        # longest first, ties by row
        assert all((a > b) or (a == b and r < s) for a, b, r, s in zip(
            ln[:-1], ln[1:], long_rows[:-1], long_rows[1:]))
        assert num_block == int((ln > block_row).sum())
        assert (ln[:num_block] > block_row).all()
        assert (ln[num_block:] <= block_row).all()
    if (n > 0).all():
        assert row_list is None
    else:
        assert row_list.dtype == np.int32
        np.testing.assert_array_equal(
            row_list, np.flatnonzero((n > 0) & (n <= long_row)))
    # long, listed-or-short and empty rows partition the rows
    short = (np.arange(n.size) if row_list is None
             else row_list.astype(np.int64))
    short = short[n[short] <= long_row]
    parts = [short, want_long, np.flatnonzero(n == 0)]
    assert sum(p.size for p in parts) == n.size
    assert np.array_equal(np.sort(np.concatenate(parts)), np.arange(n.size))


def test_small_thresholds_give_warp_and_block_rows():
    long_rows, num_block, _ = pdev.csr_row_split(
        _host("powerlaw", "coo")[0], *SMALL)
    assert long_rows.size == 180 and num_block == 6
    assert pdev.BLOCK_ROW > pdev.LONG_ROW >= 1


@pytest.mark.parametrize("case", [("powerlaw", "coo"), ("empty_rows",
                                                         "whole"),
                                  ("poisson", "whole")], ids="-".join)
def test_device_csr_holds_the_split(case, small):
    row_ptr, col, val, m = _host(*case)
    n = row_ptr.size - 1
    R = DeviceCsr(n, m, col.size, torch.from_numpy(row_ptr),
                  torch.from_numpy(col), torch.from_numpy(val))
    long_rows, num_block, row_list = pdev.csr_row_split(row_ptr, *SMALL)
    assert R.long_row_entries == SMALL[0]
    assert R.num_block_rows == num_block
    for got, want in ((R.long_rows, long_rows), (R.row_list, row_list)):
        if want is None:
            assert got is None
        else:
            assert got.dtype == torch.int32 and got.is_contiguous()
            np.testing.assert_array_equal(got.numpy(), want)


def test_hybrid_coo_part_holds_the_split(small):
    h = HybridMatrix.from_matrix_market(_mm(pgen, "powerlaw"))
    R = DeviceHybrid.from_host(h, dtype=torch.float64, device="cpu").coo
    assert R.long_rows.numel() == 180 and R.num_block_rows == 6


def _jax_csr(name):
    return jdev.DeviceCsr.from_host(JCsr.from_matrix_market(
        _mm(jgen, name)))


@pytest.mark.parametrize("k", KS, ids=lambda k: f"k{k}")
@pytest.mark.parametrize("name", ["powerlaw", "empty_rows"])
def test_walk_matches_reference_and_jax_csr(name, k):
    """The whole matrix as one CSR: the walk against the plain version
    and JAX's XLA product, fp64."""
    row_ptr, col, val, m = _host(name, "whole")
    n = row_ptr.size - 1
    X = _x(m, k, seed=11)
    got = csr_walk(row_ptr, col, val, X, *SMALL)
    R = DeviceCsr(n, m, col.size, torch.from_numpy(row_ptr),
                  torch.from_numpy(col), torch.from_numpy(val))
    assert _rel(got, csr_spmv_reference(R, torch.from_numpy(X))) <= RTOL
    A = _jax_csr(name)
    want = jspmv(A, X) if k is None else jspmm(A, X)
    assert _rel(got, np.asarray(want)) <= RTOL


@pytest.mark.parametrize("k", KS, ids=lambda k: f"k{k}")
def test_walk_matches_jax_hybrid(k, small):
    """The hybrid product with its COO part in the kernels' order (the
    ELL part's plain product, then the walk adding the COO part) against
    JAX's XLA product on its DeviceHybrid, fp64."""
    p = HybridMatrix.from_matrix_market(_mm(pgen, "powerlaw"))
    H = DeviceHybrid.from_host(p, dtype=torch.float64, device="cpu")
    R = H.coo
    X = _x(H.num_columns, k, seed=12)
    y = ell_spmv_reference(H.ell, torch.from_numpy(X)).numpy()
    got = csr_walk(R.row_ptr.numpy(), R.column_index.numpy(),
                   R.value.numpy(), X, *SMALL, out=y)
    A = jdev.DeviceHybrid.from_host(JHybrid.from_matrix_market(
        _mm(jgen, "powerlaw")))
    want = jspmv(A, X) if k is None else jspmm(A, X)
    assert _rel(got, np.asarray(want)) <= RTOL
    assert _rel(got, p.spmv(X) if k is None else np.stack(
        [p.spmv(X[:, j]) for j in range(k)], axis=1)) <= RTOL


@pytest.mark.parametrize("k", KS, ids=lambda k: f"k{k}")
def test_walk_adds_into_out_and_leaves_empty_rows(k):
    """With ``out``: every row that owns an entry gets out + sum; a row
    with none keeps its -0.0."""
    row_ptr, col, val, m = _host("empty_rows", "whole")
    n = row_ptr.size - 1
    X = _x(m, k, seed=13)
    shape = (n,) if k is None else (n, k)
    out = np.full(shape, -0.0)
    got = csr_walk(row_ptr, col, val, X, *SMALL, out=out)
    empty = np.diff(row_ptr) == 0
    assert empty.any()
    assert np.signbit(got[empty]).all() and (got[empty] == 0).all()
    R = DeviceCsr(n, m, col.size, torch.from_numpy(row_ptr),
                  torch.from_numpy(col), torch.from_numpy(val))
    assert _rel(got, csr_spmv_reference(R, torch.from_numpy(X))) <= RTOL


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=str)
@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("case", [("powerlaw", "coo"),
                                  ("powerlaw", "whole")], ids="-".join)
def test_walk_spmm_columns_bitwise_spmv(case, k, dtype):
    row_ptr, col, val, m = _host(*case)
    X = _x(m, k, seed=14).astype(dtype)
    Y = csr_walk(row_ptr, col, val, X, *SMALL)
    assert Y.dtype == dtype
    for j in range(k):
        assert np.array_equal(
            Y[:, j], csr_walk(row_ptr, col, val, X[:, j].copy(), *SMALL)), j


def _shuffle_run(col, val, x, S):
    """A long row's sum as the kernel runs it, step by step: each thread's
    strided sum, then ``__shfl_down_sync`` rounds (a lane past the warp
    keeps its own value), then thread 0's loop over the warps."""
    m = x.size
    lanes = []
    for t in range(S):
        acc = x.dtype.type(0)
        for e in range(t, col.size, S):
            if 0 <= col[e] < m:
                acc = acc + val[e] * x[col[e]]
        lanes.append(acc)
    totals = []
    for w in range(S // WARP):
        s = lanes[w * WARP:(w + 1) * WARP]
        for off in (16, 8, 4, 2, 1):
            s = [s[l] + (s[l + off] if l + off < WARP else s[l])
                 for l in range(WARP)]
        totals.append(s[0])
    off = len(totals) // 2
    while off:
        for w in range(off):
            totals[w] = totals[w] + totals[w + off]
        off //= 2
    return totals[0]


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=str)
@pytest.mark.parametrize("S", [WARP, BLOCK])
@pytest.mark.parametrize("length", [33, 257, 1000, 4099])
def test_walk_trees_are_the_kernels_shuffles(length, S, dtype):
    """The walk's vectorised lane sums and trees against a step-by-step
    run of the kernel's; a column past the end is skipped."""
    rng = np.random.default_rng(length)
    m = 5000
    col = rng.integers(0, m, length)
    col[::7] = m + 3
    val = rng.standard_normal(length).astype(dtype)
    x = rng.standard_normal(m).astype(dtype)
    got = _long_row_sum(col, val, x[:, None], S)[0]
    assert got == _shuffle_run(col, val, x, S)


@pytest.mark.parametrize("k", KS, ids=lambda k: f"k{k}")
def test_hybrid_with_long_rows_matches_jax(k, small):
    """The hybrid product through the port's entry points (the wrappers'
    plain path on the CPU) on a container with warp and block rows, and
    the plain version on the COO part alone against the walk."""
    p = HybridMatrix.from_matrix_market(_mm(pgen, "powerlaw"))
    H = DeviceHybrid.from_host(p, dtype=torch.float64, device="cpu")
    X = _x(H.num_columns, k, seed=15)
    Xt = torch.from_numpy(X)
    got = spmv(H, Xt) if k is None else spmm(H, Xt)
    A = jdev.DeviceHybrid.from_host(JHybrid.from_matrix_market(
        _mm(jgen, "powerlaw")))
    want = jspmv(A, X) if k is None else jspmm(A, X)
    assert _rel(got.numpy(), np.asarray(want)) <= RTOL
    R = H.coo
    core = csr_spmv_core if k is None else csr_spmm_core
    walk = csr_walk(R.row_ptr.numpy(), R.column_index.numpy(),
                    R.value.numpy(), X, *SMALL)
    assert _rel(core(R, Xt).numpy(), walk) <= RTOL


def test_wrappers_refuse_a_long_row_list_not_int32(small):
    row_ptr, col, val, m = _host("powerlaw", "coo")
    R = DeviceCsr(row_ptr.size - 1, m, col.size, torch.from_numpy(row_ptr),
                  torch.from_numpy(col), torch.from_numpy(val))
    R.long_rows = R.long_rows.long()
    x = torch.zeros(m, dtype=torch.float64)
    for call in (lambda: csr_spmv_core(R, x),
                 lambda: csr_spmm_core(R, x[:, None].contiguous())):
        with pytest.raises(KernelError, match="long_rows"):
            call()

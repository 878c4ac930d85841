"""Kernels K1, K2, K3a-c, K4a-c, K5a-b (the spill folded in), K6a-b, K7,
K8, the CSR kernels, the ELL kernels (alone and in the hybrid
product) on the card against their plain versions, ``-s xla-csr``'s
``torch.sparse`` product against the CSR kernel, and the generic and
block AMG V-cycles on the card against their CPU runs; the
traffic-isolation variants of the CSR, ELL and WELL SpMV (stream-only
and gather-only, ``--traffic-split``) against their plain versions; and
the triangular solve (``tri_solve``, its level, chained and sweep
modes) against its plain version, the chained mode bitwise against the
level mode, with ``BlockTriSolve``'s rectangular DIA and CSR blocks
against its CPU run; and LOBPCG (``ops.eigen.lobpcg``) with K2, the CSR
SpMM and the block AMG apply against its CPU run (float64 eigenvalues
at rtol 1e-10, one SpMM launch for X, one for P and one a step), and its
float32 products kept off TF32 when the process switches TF32 on; and the
sharded paths (``parallel``) on 1, 2 and 4 virtual shards of the card:
each sharded SpMV and SpMM against its CPU run and the unsharded kernel,
one launch a shard (two for the halo CSR path's shards that read a
halo), CG within 2 iterations of its CPU run; the WELL, WELL-CW and BSR
sharded products and the block-Jacobi IC(0) apply (launches exactly the
container's ``launches_a_product`` / ``launches_an_apply``, twice
bitwise), Chebyshev, Jacobi-PCG, block-IC(0) PCG and masked LOBPCG over
sharded operators against their CPU runs, and ``dryrun_multichip(4)``;
and a one-rank NCCL process mesh (``parallel.global_mesh``) whose DIA,
CSR, WELL, WELL-CW and BSR products and block-IC(0) apply are bitwise
the virtual shards'.

Marked ``cuda``: they skip where no CUDA device is present.  This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances (relative max-norm): float64 1e-12 and float32 1e-5 (the
kernel fuses multiply-add where the plain version rounds twice);
bfloat16 storage 1e-2 (both accumulate in float32 and round y once, so
they differ by at most one bfloat16 step); the fused dot 1e-10 in
float64 and 1e-4 in float32, relative to sum |x_i y_i| (the scale of
the rounding error of any summation order).  The WELL-CW, WELL, BSR,
CSR and ELL kernels (float64 and float32 only, and bfloat16 blocks for BSR) are
also launched twice on the same input, and the two outputs must be
bitwise equal; each column of an SpMM kernel's output is also held
against the SpMV kernel on that column.  The CSR kernels also run with
their long-row thresholds set small, so that a matrix has warp rows,
block rows and empty rows, and on float64 must give the bits of a numpy
walk in their order (``tests/_csr_walk.py``, a short row's fused
multiply-add done exactly with fractions).  K3b and K3c also run with each
cluster size the host can choose, on pools of 0, 1 and more chunks a
block, on lane slices, and beside an inf in x.  BSR with bfloat16
blocks: both the kernel (on the tensor cores or the SIMT path) and its
plain version multiply the same bfloat16 values and sum in float32, so
they agree to 1e-5 of the output's scale.  K8 (the fused V-cycle) is
held to its plain version by relative 2-norm: 1e-12 in float64 and 5e-6
in float32, the JAX fused V-cycle test's bound
(tests/test_fused_vcycle.py:65).  The six traffic variants are held to
their plain versions at the same tolerances, launched twice (bitwise
equal), each moving its own launch count and no other kernel's; and
since each is its full kernel's walk with one stream left out, the full
kernel on x = ones gives the stream-only variant's bits and the full
kernel on the matrix with every stored value 1 (the same slots live)
the gather-only variant's bits: the full kernels keep their walk.
"""

import functools
from fractions import Fraction

import numpy as np
import pytest
import torch
from _csr_walk import csr_walk

from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.io.generate import (
    banded_random,
    from_coo_arrays,
    poisson2d,
    powerlaw,
    random_sparse,
)
from spmv_tpu_torch.io.matrix_market import MatrixMarket
from spmv_tpu_torch.models import (
    BsrMatrix,
    CsrMatrix,
    DeviceBsr,
    DeviceCsr,
    DeviceEll,
    DeviceHybrid,
    DeviceSparseCsr,
    EllMatrix,
    HybridMatrix,
    DeviceCwLevel,
    DeviceCwMerged,
    DeviceCwPool,
    DeviceDia,
    DeviceWell,
    DeviceWellCw,
    DiaMatrix,
    WellCwMatrix,
    WellMatrix,
)
from spmv_tpu_torch.ops import (
    bsr_path,
    bsr_spmm_core,
    bsr_spmm_reference,
    csr_irregular_core,
    csr_irregular_reference,
    csr_regular_core,
    csr_regular_reference,
    csr_spmm_core,
    csr_spmv_core,
    csr_spmv_reference,
    cw_level_reference,
    cw_merged_reference,
    cw_pool_reference,
    dia_spmm_core,
    dia_spmm_reference,
    dia_spmv_core,
    dia_spmv_reference,
    ell_irregular_core,
    ell_irregular_reference,
    ell_regular_core,
    ell_regular_reference,
    ell_spmm_core,
    ell_spmv_core,
    ell_spmv_reference,
    hybrid_spmm_core,
    hybrid_spmv_core,
    hybrid_spmv_reference,
    sparse_csr_core,
    well_chunks_reference,
    well_irregular_core,
    well_irregular_reference,
    well_regular_core,
    well_regular_reference,
    well_seg_core,
    well_seg_spmm_core,
    well_spmm_core,
    well_spmv_core,
    well_spmv_reference,
    well_whole_core,
    well_whole_spmm_core,
    wellcw_level_core,
    wellcw_level_spmm_core,
    wellcw_merged_core,
    wellcw_merged_spmm_core,
    wellcw_pool_core,
    wellcw_pool_spmm_core,
    wellcw_spmm_core,
    wellcw_spmv_core,
    wellcw_spmv_reference,
)
from spmv_tpu_torch.models import device as device_module
from spmv_tpu_torch.ops import wellcw_kernels
from spmv_tpu_torch.ops._launch import ELL_MAX_SLOTS, ell_spmv_plan
from spmv_tpu_torch.ops.well_kernels import well_spmm_plan
from spmv_tpu_torch.ops.wellcw_kernels import column_block

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 1e-2}
DOT_TOL = {torch.float64: 1e-10, torch.float32: 1e-4, torch.bfloat16: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _matrix(case):
    if case == "poisson":
        return DiaMatrix.from_matrix_market(poisson2d(64, 48))
    if case == "large_offsets":
        rng = np.random.default_rng(7)
        n, rows, cols = 5000, [], []
        for off in (-300, -129, -128, -3, 0, 1, 127, 128, 300):
            i = np.arange(max(0, -off), min(n, n - off))
            rows.append(i)
            cols.append(i + off)
        rows, cols = np.concatenate(rows), np.concatenate(cols)
        return DiaMatrix.from_matrix_market(from_coo_arrays(
            n, n, rows, cols, rng.standard_normal(rows.size)))
    rows, cols = np.array([0, 0, 1, 2, 3, 3, 3]), np.array([0, 1, 1, 2, 0, 3, 4])
    return DiaMatrix.from_matrix_market(from_coo_arrays(
        4, 5, rows, cols, np.array([1.0, 2.0, 1.0, 3.0, -1.0, 2.0, 1.0])))


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("case", ["poisson", "large_offsets", "rectangular"])
def test_k1_matches_plain(case, dtype, cuda):
    A = DeviceDia.from_host(_matrix(case), dtype=dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(A.num_columns, generator=g, device=cuda).to(dtype)
    before = dia_spmv_core.launches
    y = dia_spmv_core(A, x)
    y2, dot = dia_spmv_core(A, x, with_dot=True)
    torch.cuda.synchronize()
    assert dia_spmv_core.launches == before + 2
    want, want_dot = dia_spmv_reference(A, x, with_dot=True)
    assert _rel(y, want) <= TOL[dtype]
    assert torch.equal(y, y2)
    r = min(A.num_rows, A.num_columns)
    scale = float((x[:r].double() * want[:r].double()).abs().sum())
    assert abs(float(dot) - float(want_dot)) / scale <= DOT_TOL[dtype]


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("k", [1, 4, 11])
def test_k2_matches_plain(k, dtype, cuda):
    A = DeviceDia.from_host(_matrix("large_offsets"), dtype=dtype,
                            device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    X = torch.randn(A.num_columns, k, generator=g, device=cuda).to(dtype)
    before = dia_spmm_core.launches
    Y = dia_spmm_core(A, X)
    torch.cuda.synchronize()
    assert dia_spmm_core.launches == before + 1
    assert _rel(Y, dia_spmm_reference(A, X)) <= TOL[dtype]


# name -> (matrix, host packing options, device options)
WELLCW_CASES = {
    "merged": (lambda: banded_random(16384, 512, 6, seed=20), {}, {}),
    "fallback": (lambda: banded_random(4096, 128, 8, seed=1), {}, {}),
    "forced_fallback": (lambda: banded_random(16384, 512, 6, seed=20), {},
                        {"chunks_per_step": 32}),
    "remainder": (lambda: random_sparse(256, 256, 12, seed=7),
                  {"levels": [(2, 1, 0.0)], "pool_cap": 0}, {}),
}


@functools.lru_cache(maxsize=None)
def _wellcw_host(case):
    make, host_kw, _ = WELLCW_CASES[case]
    return WellCwMatrix.from_matrix_market(make(), **host_kw)


def _parts(A):
    """(wrapper, part, plain version) of every kernel launch of A."""
    out = []
    if A.merged is not None:
        out.append((wellcw_merged_core, A.merged, cw_merged_reference))
    out += [(wellcw_level_core, lv, cw_level_reference) for lv in A.levels]
    pools = ([A.pool] if A.pool is not None else []) + list(A.tail_pools)
    out += [(wellcw_pool_core, p, cw_pool_reference) for p in pools]
    if A.remainder is not None:
        out.append((lambda R, x, n: csr_spmv_core(R, x), A.remainder,
                    lambda R, x, n: csr_spmv_reference(R, x)))
    return out


def _rel_err(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() /
                 max(float(want.abs().max()), 1e-300))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", list(WELLCW_CASES))
def test_wellcw_kernels_match_plain(case, dtype, cuda):
    w = _wellcw_host(case)
    A = DeviceWellCw.from_host(w, dtype=dtype, device=cuda,
                               **WELLCW_CASES[case][2])
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(A.num_columns, generator=g, device=cuda, dtype=dtype)
    n = A.num_rows
    counters = (wellcw_merged_core, wellcw_level_core, wellcw_pool_core,
                csr_spmv_core)
    before = [c.launches for c in counters]
    for wrapper, part, plain in _parts(A):
        y1 = wrapper(part, x, n)
        y2 = wrapper(part, x, n)
        torch.cuda.synchronize()
        assert torch.equal(y1, y2), wrapper
        assert _rel_err(y1, plain(part, x, n)) <= TOL[dtype], wrapper
    y = wellcw_spmv_core(A, x)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    expect = [3 * (A.merged is not None),
              3 * len(A.levels),
              3 * ((A.pool is not None) + len(A.tail_pools)),
              3 * (A.remainder is not None)]
    assert launched == expect
    assert _rel_err(y, wellcw_spmv_reference(A, x)) <= TOL[dtype]
    want = torch.from_numpy(w.spmv(x.double().cpu().numpy()))
    assert _rel_err(y.cpu(), want) <= TOL[dtype]


def _spmm_parts(A):
    """(SpMM wrapper, part, plain version, SpMV wrapper) of every kernel
    launch of A's SpMM."""
    out = []
    if A.merged is not None:
        out.append((wellcw_merged_spmm_core, A.merged, cw_merged_reference,
                    wellcw_merged_core))
    out += [(wellcw_level_spmm_core, lv, cw_level_reference,
             wellcw_level_core) for lv in A.levels]
    pools = ([A.pool] if A.pool is not None else []) + list(A.tail_pools)
    out += [(wellcw_pool_spmm_core, p, cw_pool_reference, wellcw_pool_core)
            for p in pools]
    if A.remainder is not None:
        out.append((lambda R, X, n: csr_spmm_core(R, X), A.remainder,
                    lambda R, X, n: csr_spmv_reference(R, X),
                    lambda R, x, n: csr_spmv_core(R, x)))
    return out


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", list(WELLCW_CASES))
def test_wellcw_spmm_kernels_match_plain(case, dtype, k, cuda):
    w = _wellcw_host(case)
    A = DeviceWellCw.from_host(w, dtype=dtype, device=cuda,
                               **WELLCW_CASES[case][2])
    g = torch.Generator(device=cuda).manual_seed(4)
    X = torch.randn(A.num_columns, k, generator=g, device=cuda, dtype=dtype)
    n = A.num_rows
    counters = (wellcw_merged_spmm_core, wellcw_level_spmm_core,
                wellcw_pool_spmm_core, csr_spmm_core)
    before = [c.launches for c in counters]
    for wrapper, part, plain, spmv_wrapper in _spmm_parts(A):
        Y1 = wrapper(part, X, n)
        Y2 = wrapper(part, X, n)
        torch.cuda.synchronize()
        assert Y1.shape == (n, k)
        assert torch.equal(Y1, Y2), wrapper
        assert _rel_err(Y1, plain(part, X, n)) <= TOL[dtype], wrapper
        for j in range(k):
            y = spmv_wrapper(part, X[:, j].contiguous(), n)
            assert _rel_err(Y1[:, j], y) <= TOL[dtype], (wrapper, j)
    Y = wellcw_spmm_core(A, X)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    expect = [3 * (A.merged is not None),
              3 * len(A.levels),
              3 * ((A.pool is not None) + len(A.tail_pools)),
              3 * (A.remainder is not None)]
    assert launched == expect
    assert _rel_err(Y, wellcw_spmv_reference(A, X)) <= TOL[dtype]
    want = torch.from_numpy(w.spmm(X.double().cpu().numpy()))
    assert _rel_err(Y.cpu(), want) <= TOL[dtype]


def test_wellcw_spmm_wide_tail_pool_float64(cuda):
    """k = 8 in float64 on a 128-group tail pool: K4c holds a row's 8
    column sums in registers, so the product is one launch of one column
    block (a shared tile of 128 rows would have needed 256 KB)."""
    A = DeviceWellCw.from_host(_wellcw_host("merged"), dtype=torch.float64,
                               device=cuda)
    tails = [p for p in A.tail_pools if p.out_rows == 128]
    assert tails, [p.out_rows for p in A.tail_pools]
    assert column_block(8) == 8
    g = torch.Generator(device=cuda).manual_seed(5)
    X = torch.randn(A.num_columns, 8, generator=g, device=cuda,
                    dtype=torch.float64)
    for pool in tails:
        before = wellcw_pool_spmm_core.launches
        Y1 = wellcw_pool_spmm_core(pool, X, A.num_rows)
        Y2 = wellcw_pool_spmm_core(pool, X, A.num_rows)
        torch.cuda.synchronize()
        assert wellcw_pool_spmm_core.launches == before + 2
        assert torch.equal(Y1, Y2)
        assert _rel_err(Y1, cw_pool_reference(pool, X, A.num_rows)) <= 1e-12


# K4c, one thread a row over the pool's row list, on synthetic pools:
# blocks of 1, 0, 5 and 2 chunks (an empty block, rows ending inside a
# group), 64- and 128-row blocks, every column-block width, 16-byte X
# loads (aligned rows of 16-byte runs) or one value at a time.
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned",
                                                        "misaligned"])
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("k", [1, 3, 8, 9, 17])
@pytest.mark.parametrize("out_rows", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_wellcw_pool_spmm_paths(dtype, out_rows, k, accumulate, aligned,
                                cuda):
    m = 4 * out_rows * 128 - 3
    pool = synthetic_pool(out_rows, (1, 0, 5, 2), dtype, cuda, m,
                          seed=out_rows)
    if aligned:
        g = torch.Generator(device=cuda).manual_seed(24)
        X = torch.randn(m, k, generator=g, device=cuda, dtype=dtype)
    else:
        X = _misaligned(m, k, cuda, dtype, 24)
    n = m - 70
    plan = wellcw_kernels.spmm_plan(k, dtype, X.data_ptr(), 0)
    assert plan["vector_x"] == (aligned and (k * X.element_size()) % 16
                                == 0)
    want = cw_pool_reference(pool, X, n)
    runs = []
    for _ in range(2):
        out = None
        if accumulate:
            out = torch.full((n, k), 0.5, device=cuda, dtype=dtype)
        runs.append(wellcw_pool_spmm_core(pool, X, n, out=out,
                                          accumulate=accumulate))
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    if accumulate:
        want = want + 0.5
    assert _rel_err(runs[0], want) <= TOL[dtype]
    for j in (0, k - 1):
        y = wellcw_pool_core(pool, X[:, j].contiguous(), n)
        if accumulate:
            y = y + 0.5
        assert _rel_err(runs[0][:, j], y) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_wellcw_pool_spmm_past_the_end_next_to_inf(dtype, cuda):
    """K4c's cells reading the first row of X past the end read 0, while
    X's last row, beside it, is inf (read by no cell): Y stays finite."""
    m, k = 3 * 64 * 128 - 3, 8
    pool = synthetic_pool(64, (2, 4, 3), dtype, cuda, m)
    move_past_the_end(pool, m, merged=False)
    pool = rebuilt_pool(pool)
    g = torch.Generator(device=cuda).manual_seed(16)
    X = torch.randn(m, k, generator=g, device=cuda, dtype=dtype)
    X[m - 1] = float("inf")
    Y = wellcw_pool_spmm_core(pool, X, m)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(Y).all())
    assert _rel_err(Y, cw_pool_reference(pool, X, m)) <= TOL[dtype]


def test_wellcw_pool_spmm_writes_no_row_without_cells(cuda):
    """The stated deviation: with accumulate, K4c writes only the rows
    that own a cell, so a -0.0 there stays -0.0 (the plain version, and
    the tile of the kernel before it, add +0.0 and give +0.0); without
    accumulate every row below num_rows is written, +0.0 where no cell."""
    m, k = 3 * 64 * 128 - 3, 4
    pool = synthetic_pool(64, (1, 0, 2), torch.float64, cuda, m)
    n = m - 70
    listed = torch.zeros(n, dtype=torch.bool, device=cuda)
    rows = pool.list_rows.long()
    listed[rows[rows < n]] = True
    assert 0 < int(listed.sum()) < n
    g = torch.Generator(device=cuda).manual_seed(17)
    X = torch.randn(m, k, generator=g, device=cuda, dtype=torch.float64)
    out = torch.full((n, k), -0.0, device=cuda, dtype=torch.float64)
    got = wellcw_pool_spmm_core(pool, X, n, out=out, accumulate=True)
    plain = cw_pool_reference(pool, X, n)
    fresh = wellcw_pool_spmm_core(pool, X, n)
    torch.cuda.synchronize()
    assert bool(torch.signbit(got[~listed]).all())
    assert not bool(torch.signbit(plain[~listed]).any())
    assert bool((got[~listed] == plain[~listed]).all())
    assert _rel_err(got, plain) <= 1e-12
    assert bool((fresh[~listed] == 0).all())
    assert not bool(torch.signbit(fresh[~listed]).any())
    assert torch.equal(fresh[listed], got[listed])


# K3b and K3c stream chunks through a ring, a cluster of C CTAs an output
# block (csrc/wellcw_spmv.cu).  Synthetic containers give the edges a
# packed matrix seldom shows; tests/test_torch_wellcw_paths.py holds their
# plain versions to a dense definition on the CPU.
def synthetic_pool(out_rows, counts, dtype, device, num_columns, seed=0):
    """A ``DeviceCwPool`` (d = 1, one chunk a step) of len(counts) output
    blocks of out_rows groups, block b holding counts[b] chunks: random
    values, windows over every column block of x (so some columns lie
    past ``num_columns``) and rows of the block."""
    rng = np.random.default_rng(seed)
    blocks = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    chunks = blocks.size
    windows = -(-num_columns // 128)
    rowmap = blocks[:, None, None] * out_rows + rng.integers(
        0, out_rows, size=(chunks, 8, 128))
    return DeviceCwPool(
        1, 1, 0, rng.standard_normal((chunks, 8, 128)),
        rng.integers(0, 8 * 128, size=(chunks, 8, 128)),
        rng.integers(0, windows, size=(chunks, 1, 1)), rowmap, blocks,
        len(counts) * out_rows, dtype, device, out_rows=out_rows)


def synthetic_merged(num_blocks, cap, pool_per_block, dtype, device,
                     num_columns, seed=0):
    """A ``DeviceCwMerged`` (d = 1) of num_blocks blocks of 64 * cap level
    chunks and pool_per_block pool chunks, whose rows (local_index bits 14
    and up) lie in the block; windows as in ``synthetic_pool``."""
    rng = np.random.default_rng(seed)
    lvl = 64 * cap
    kl = lvl + pool_per_block
    loc = rng.integers(0, 8 * 128, size=(num_blocks, kl, 8, 128))
    loc[:, lvl:] |= rng.integers(0, 64, size=loc[:, lvl:].shape) << 14
    return DeviceCwMerged(
        1, kl, cap, lvl, pool_per_block, num_blocks, 0,
        rng.standard_normal((num_blocks * kl, 8, 128)),
        loc.reshape(-1, 8, 128),
        rng.integers(0, -(-num_columns // 128), size=(num_blocks, 1, kl)),
        dtype, device)


def move_past_the_end(part, m, merged):
    """Point slot 0 of the first chunk at x's last column, m - 1, then
    move every cell that reads it one column on (local_index ^ 1; m % 128
    is 125): onto the first column past the end."""
    assert m % 128 == 125 and part.d == 1
    part.anchor4.view(-1)[0] = (m - 1) // 128
    part.local_index[0, 0] = (part.local_index[0, 0] & ~1023) | (m - 1) % 128
    loc = part.local_index.long()
    w = loc >> 7
    if merged:
        w = w & (8 * part.d - 1)
    a4 = part.anchor4.reshape(-1, 1, 1).long()
    hit = (a4 * part.d + w) * 128 + (loc & 127) == m - 1
    part.local_index[hit] ^= 1


def _force_cluster(monkeypatch, c):
    """Make the wrappers launch clusters of c CTAs, whatever the host
    would pick."""
    monkeypatch.setattr(wellcw_kernels, "cluster_size",
                        lambda units, num_sms: c)


def _stream_check(wrapper, part, plain, x, n, dtype):
    """Two launches bitwise equal, and within TOL of the plain version;
    returns y."""
    y1, y2 = wrapper(part, x, n), wrapper(part, x, n)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    assert _rel_err(y1, plain(part, x, n)) <= TOL[dtype]
    return y1


@pytest.mark.parametrize("c", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_wellcw_stream_kernels_each_cluster_size(dtype, c, cuda,
                                                 monkeypatch):
    """K3c and K3b on the merged case (two merged blocks, a 128- and a
    64-group tail pool) with clusters of 1, 2 and 4 CTAs: every size the
    kernels take, the host's picks among them."""
    A = DeviceWellCw.from_host(_wellcw_host("merged"), dtype=dtype,
                               device=cuda)
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(A.num_columns, generator=g, device=cuda, dtype=dtype)
    n = A.num_rows
    _force_cluster(monkeypatch, c)
    _stream_check(wellcw_merged_core, A.merged, cw_merged_reference, x, n,
                  dtype)
    for pool in A.tail_pools:
        _stream_check(wellcw_pool_core, pool, cw_pool_reference, x, n, dtype)


@pytest.mark.parametrize("c", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_wellcw_pool_blocks_of_0_1_and_5_chunks(dtype, c, cuda,
                                                monkeypatch):
    """Output blocks with no chunk, one chunk and more chunks than a
    cluster has CTAs; the last block's rows end inside a group."""
    pool = synthetic_pool(64, (1, 0, 5, 2), dtype, cuda, 4 * 64 * 128 - 3)
    _force_cluster(monkeypatch, c)
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn(4 * 64 * 128 - 3, generator=g, device=cuda, dtype=dtype)
    n = 4 * 64 * 128 - 70
    y = _stream_check(wellcw_pool_core, pool, cw_pool_reference, x, n, dtype)
    assert not bool(y[64 * 128:2 * 64 * 128].any())   # the empty block
    out = torch.ones(n, device=cuda, dtype=dtype)
    wellcw_pool_core(pool, x, n, out=out, accumulate=True)
    torch.cuda.synchronize()
    assert _rel_err(out, y + 1) <= TOL[dtype]


@pytest.mark.parametrize("dtype,out_rows,lanes", [
    (torch.float64, 64, 128), (torch.float64, 128, 128),
    (torch.float64, 256, 64), (torch.float64, 448, 32),
    (torch.float32, 128, 128), (torch.float32, 512, 64)],
    ids=lambda v: str(v).replace("torch.", ""))
def test_wellcw_pool_lane_slices(dtype, out_rows, lanes, cuda):
    """Pools whose (out_rows x 128) tile does not fit a block's shared
    memory take 64 or 32 lanes a CTA."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert wellcw_kernels.stream_plan(out_rows, itemsize, True)[0] == lanes
    m = 2 * out_rows * 128
    pool = synthetic_pool(out_rows, (3, 2), dtype, cuda, m, seed=out_rows)
    g = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn(m, generator=g, device=cuda, dtype=dtype)
    _stream_check(wellcw_pool_core, pool, cw_pool_reference, x, m - 5, dtype)


@pytest.mark.parametrize("kind", ["merged", "pool"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_wellcw_stream_past_the_end_next_to_inf(kind, dtype, cuda):
    """Cells reading the first column past the end read 0, while x's last
    entry, beside it, is inf (read by no cell): y stays finite."""
    m = 3 * 64 * 128 - 3
    if kind == "merged":
        part = synthetic_merged(3, 2, 3, dtype, cuda, m)
        wrapper, plain = wellcw_merged_core, cw_merged_reference
    else:
        part = synthetic_pool(64, (2, 4, 3), dtype, cuda, m)
        wrapper, plain = wellcw_pool_core, cw_pool_reference
    move_past_the_end(part, m, merged=kind == "merged")
    g = torch.Generator(device=cuda).manual_seed(15)
    x = torch.randn(m, generator=g, device=cuda, dtype=dtype)
    x[m - 1] = float("inf")
    y = _stream_check(wrapper, part, plain, x, m, dtype)
    assert bool(torch.isfinite(y).all())


def rebuilt_pool(part):
    """The pool rebuilt from its current arrays, so that its row list
    follows an edit of ``local_index``."""
    return DeviceCwPool(
        part.d, part.chunks_per_step, part.xr4, part.value.cpu().numpy(),
        part.local_index.cpu().numpy(), part.anchor4.cpu().numpy(),
        part.rowmap.cpu().numpy(), part.block_of_step.cpu().numpy(),
        part.num_blocks * part.out_rows, part.value.dtype,
        part.value.device, out_rows=part.out_rows)


def rebuilt_merged(part):
    """The merged grid rebuilt from its current arrays, so that the pool
    list and the int16 copy follow an edit of ``local_index``."""
    return DeviceCwMerged(
        part.d, part.kl, part.cap, part.lvl_per_block, part.pool_per_block,
        part.num_blocks, part.xr4, part.value.cpu().numpy(),
        part.local_index.cpu().numpy(), part.anchor4.cpu().numpy(),
        part.value.dtype, part.value.device)


# K3a reads the level's int16 indices where it has them (d <= 32), else
# the int32 ones; both paths sum alike.
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", ["fallback", "forced_fallback",
                                  "remainder"])
def test_wellcw_level_int16_and_int32_paths(case, dtype, cuda):
    A = DeviceWellCw.from_host(_wellcw_host(case), dtype=dtype, device=cuda,
                               **WELLCW_CASES[case][2])
    g = torch.Generator(device=cuda).manual_seed(21)
    x = torch.randn(A.num_columns, generator=g, device=cuda, dtype=dtype)
    n = A.num_rows
    assert A.levels
    for lvl in A.levels:
        assert lvl.local_index16 is not None
        y16 = _stream_check(wellcw_level_core, lvl, cw_level_reference, x,
                            n, dtype)
        out = torch.ones(n, device=cuda, dtype=dtype)
        wellcw_level_core(lvl, x, n, out=out, accumulate=True)
        keep = lvl.local_index16
        lvl.local_index16 = None
        try:
            y32 = _stream_check(wellcw_level_core, lvl, cw_level_reference,
                                x, n, dtype)
        finally:
            lvl.local_index16 = keep
        torch.cuda.synchronize()
        assert torch.equal(y16, y32)
        assert torch.equal(out, torch.ones_like(out) + y16)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_wellcw_level_int32_path_at_d64(dtype, cuda):
    """A synthetic level of window multiple 64: its indices reach 65535,
    so it has no int16 copy and K3a reads the int32 array."""
    rng = np.random.default_rng(22)
    chunks, groups, d = 12, 6, 64
    m = 4 * d * 1024 - 3                      # some cells read past the end
    grp = np.repeat(np.arange(groups), 2).reshape(chunks, 1, 1)
    lvl = DeviceCwLevel(
        d, 1, 0, rng.standard_normal((chunks, 8, 128)),
        rng.integers(0, 1024 * d, size=(chunks, 8, 128)),
        rng.integers(0, 4, size=(chunks, 1, 1)), grp, np.zeros(chunks),
        groups, dtype, cuda)
    assert lvl.local_index16 is None
    x = torch.from_numpy(rng.standard_normal(m)).to(cuda, dtype)
    _stream_check(wellcw_level_core, lvl, cw_level_reference, x,
                  groups * 128 - 5, dtype)


def _misaligned(rows, k, device, dtype, seed):
    """A contiguous (rows, k) X one element past a 16-byte boundary."""
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(rows * k + 1, generator=g, device=device, dtype=dtype)
    X = buf[1:].view(rows, k)
    assert X.is_contiguous() and X.data_ptr() % 16 != 0
    return X


# K4b walks a level as K4a walks its level chunks: the level's int16
# indices or its int32 ones, X and Y in 16-byte moves (aligned rows of
# 16-byte runs) or one value at a time (X and Y one element off a 16-byte
# boundary): every path gives the same Y bit for bit.
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("k", [1, 3, 8, 9])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", ["fallback", "forced_fallback",
                                  "remainder"])
def test_wellcw_level_spmm_index_and_x_paths(case, dtype, k, accumulate,
                                             cuda):
    A = DeviceWellCw.from_host(_wellcw_host(case), dtype=dtype, device=cuda,
                               **WELLCW_CASES[case][2])
    m, n = A.num_columns, A.num_rows
    g = torch.Generator(device=cuda).manual_seed(26)
    X = torch.randn(m, k, generator=g, device=cuda, dtype=dtype)
    Xs = _misaligned(m, k, cuda, dtype, 26).copy_(X)
    assert A.levels
    for lvl in A.levels:
        assert lvl.local_index16 is not None
        runs = {}
        for index in ("int16", "int32"):
            for x in (X, Xs):
                out = None
                if accumulate:
                    out = (torch.empty(n, k, device=cuda, dtype=dtype)
                           if x is X else _misaligned(n, k, cuda, dtype, 27))
                    out.fill_(0.5)
                keep = lvl.local_index16
                if index == "int32":
                    lvl.local_index16 = None
                try:
                    Y = wellcw_level_spmm_core(lvl, x, n, out=out,
                                               accumulate=accumulate)
                finally:
                    lvl.local_index16 = keep
                vec = wellcw_kernels.spmm_plan(k, dtype, x.data_ptr(),
                                               Y.data_ptr())["vector_x"]
                assert vec == (x is X and (k * X.element_size()) % 16 == 0)
                runs[(index, x is X)] = Y
        torch.cuda.synchronize()
        first = runs[("int16", True)]
        for Y in runs.values():
            assert torch.equal(Y, first)
        want = cw_level_reference(lvl, X, n)
        if accumulate:
            want = want + 0.5
        assert _rel_err(first, want) <= TOL[dtype]


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_wellcw_level_spmm_int32_path_at_d64(dtype, k, cuda):
    """K4b on a synthetic level of window multiple 64: its indices reach
    65535, so it has no int16 copy and K4b reads the int32 array; some
    cells read past the end."""
    rng = np.random.default_rng(28)
    chunks, groups, d = 12, 6, 64
    m = 4 * d * 1024 - 3
    grp = np.repeat(np.arange(groups), 2).reshape(chunks, 1, 1)
    lvl = DeviceCwLevel(
        d, 1, 0, rng.standard_normal((chunks, 8, 128)),
        rng.integers(0, 1024 * d, size=(chunks, 8, 128)),
        rng.integers(0, 4, size=(chunks, 1, 1)), grp, np.zeros(chunks),
        groups, dtype, cuda)
    assert lvl.local_index16 is None
    X = torch.from_numpy(rng.standard_normal((m, k))).to(cuda, dtype)
    n = groups * 128 - 5
    before = wellcw_level_spmm_core.launches
    Y1 = wellcw_level_spmm_core(lvl, X, n)
    Y2 = wellcw_level_spmm_core(lvl, X, n)
    torch.cuda.synchronize()
    assert wellcw_level_spmm_core.launches == before + 2
    assert torch.equal(Y1, Y2)
    assert _rel_err(Y1, cw_level_reference(lvl, X, n)) <= TOL[dtype]
    for j in (0, k - 1):
        y = wellcw_level_core(lvl, X[:, j].contiguous(), n)
        assert _rel_err(Y1[:, j], y) <= TOL[dtype]


# K4a, one thread a row: the pool list of 0, 1 and 16 chunks a block, the
# column blocks of k = 1 .. 17, with and without accumulate, and X in
# 16-byte loads (aligned rows of 16-byte runs) or one value at a time.
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned",
                                                        "misaligned"])
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("k", [1, 3, 8, 9, 17])
@pytest.mark.parametrize("pool_per_block", [0, 1, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_wellcw_merged_spmm_paths(dtype, pool_per_block, k, accumulate,
                                  aligned, cuda):
    m = 3 * 64 * 128 - 3
    mg = synthetic_merged(3, 2, pool_per_block, dtype, cuda, m,
                          seed=pool_per_block)
    if aligned:
        g = torch.Generator(device=cuda).manual_seed(23)
        X = torch.randn(m, k, generator=g, device=cuda, dtype=dtype)
    else:
        X = _misaligned(m, k, cuda, dtype, 23)
    n = m - 70
    plan = wellcw_kernels.spmm_plan(k, dtype, X.data_ptr(), 0)
    assert plan["vector_x"] == (aligned and (k * X.element_size()) % 16
                                == 0)
    want = cw_merged_reference(mg, X, n)
    runs = []
    for _ in range(2):
        out = None
        if accumulate:
            out = torch.full((n, k), 0.5, device=cuda, dtype=dtype)
        runs.append(wellcw_merged_spmm_core(mg, X, n, out=out,
                                            accumulate=accumulate))
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    if accumulate:
        want = want + 0.5
    assert _rel_err(runs[0], want) <= TOL[dtype]
    for j in (0, k - 1):
        y = wellcw_merged_core(mg, X[:, j].contiguous(), n)
        if accumulate:
            y = y + 0.5
        assert _rel_err(runs[0][:, j], y) <= TOL[dtype]


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("pool_per_block", [0, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_wellcw_merged_spmm_vector_and_scalar_x_sum_alike(dtype,
                                                         pool_per_block, k,
                                                         cuda):
    """X in 16-byte loads or one value at a time: the same Y bit for
    bit."""
    m = 3 * 64 * 128 - 3
    mg = synthetic_merged(3, 2, pool_per_block, dtype, cuda, m, seed=24)
    g = torch.Generator(device=cuda).manual_seed(24)
    X = torch.randn(m, k, generator=g, device=cuda, dtype=dtype)
    assert wellcw_kernels.spmm_plan(k, dtype, X.data_ptr(),
                                           0)["vector_x"]
    want = wellcw_merged_spmm_core(mg, X, m)
    got = wellcw_merged_spmm_core(mg, _misaligned(m, k, cuda, dtype, 24)
                                  .copy_(X), m)
    torch.cuda.synchronize()
    assert _rel_err(want, cw_merged_reference(mg, X, m)) <= TOL[dtype]
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 8, 9])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_wellcw_merged_spmm_past_the_end_next_to_inf(dtype, k, cuda):
    """Level and pool cells reading the first column past the end read 0,
    while X's last row, beside it, is inf (read by no cell): Y stays
    finite."""
    m = 3 * 64 * 128 - 3
    part = synthetic_merged(3, 2, 3, dtype, cuda, m)
    move_past_the_end(part, m, merged=True)
    part = rebuilt_merged(part)
    g = torch.Generator(device=cuda).manual_seed(25)
    X = torch.randn(m, k, generator=g, device=cuda, dtype=dtype)
    X[m - 1] = float("inf")
    Y1 = wellcw_merged_spmm_core(part, X, m)
    Y2 = wellcw_merged_spmm_core(part, X, m)
    torch.cuda.synchronize()
    assert torch.equal(Y1, Y2)
    assert bool(torch.isfinite(Y1).all())
    assert _rel_err(Y1, cw_merged_reference(part, X, m)) <= TOL[dtype]


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_csr_spmm_matches_plain(dtype, k, cuda):
    A = DeviceCsr.from_host(
        CsrMatrix.from_matrix_market(random_sparse(3000, 2000, 9, seed=8)),
        dtype=dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    X = torch.randn(A.num_columns, k, generator=g, device=cuda, dtype=dtype)
    before = csr_spmm_core.launches
    Y1, Y2 = csr_spmm_core(A, X), csr_spmm_core(A, X)
    out = torch.ones(A.num_rows, k, device=cuda, dtype=dtype)
    csr_spmm_core(A, X, out=out, accumulate=True)
    torch.cuda.synchronize()
    assert csr_spmm_core.launches == before + 3
    assert torch.equal(Y1, Y2)
    want = csr_spmv_reference(A, X)
    assert _rel_err(Y1, want) <= TOL[dtype]
    assert _rel_err(out, want + 1) <= TOL[dtype]
    for j in range(k):
        assert _rel_err(Y1[:, j], csr_spmv_core(A, X[:, j].contiguous())) \
            <= TOL[dtype]


def _csr_empty_rows(dtype, device):
    """random_sparse(3000, 2000, 9) with every fourth row and the last
    one emptied: a row list of 2,249 rows."""
    mm = random_sparse(3000, 2000, 9, seed=8)
    r, c = np.asarray(mm.rows_1based) - 1, np.asarray(mm.cols_1based) - 1
    keep = (r % 4 != 1) & (r != 2999)
    A = DeviceCsr.from_host(CsrMatrix.from_matrix_market(from_coo_arrays(
        3000, 2000, r[keep], c[keep], np.asarray(mm.values)[keep])),
        dtype=dtype, device=device)
    assert A.row_list is not None and A.row_list.numel() == 2249
    return A


# The CSR SpMM runs one thread a listed row: with the container's row
# list, with every row listed, and with no list (thread i on row i) it
# gives the same Y bit for bit, X in 16-byte moves or one value at a time.
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned",
                                                        "misaligned"])
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("k", [1, 3, 8, 9, 17])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_csr_spmm_row_list_paths(dtype, k, accumulate, aligned, cuda):
    A = _csr_empty_rows(dtype, cuda)
    n, m = A.num_rows, A.num_columns
    if aligned:
        g = torch.Generator(device=cuda).manual_seed(29)
        X = torch.randn(m, k, generator=g, device=cuda, dtype=dtype)
    else:
        X = _misaligned(m, k, cuda, dtype, 29)
    want = csr_spmv_reference(A, X)
    listed = A.row_list
    runs = []
    for rows in (listed, torch.arange(n, dtype=torch.int32, device=cuda),
                 None):
        out = None
        if accumulate:
            out = torch.full((n, k), 0.5, device=cuda, dtype=dtype)
        A.row_list = rows
        try:
            runs.append(csr_spmm_core(A, X, out=out, accumulate=accumulate))
        finally:
            A.row_list = listed
    torch.cuda.synchronize()
    for Y in runs[1:]:
        assert torch.equal(Y, runs[0])
    assert _rel_err(runs[0], want + 0.5 if accumulate else want) \
        <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_csr_spmm_rows_without_entries(dtype, cuda):
    """A product's first launch writes +0.0 in a row with no entry (the
    buffer held -0.0 and NaN there); adding into Y leaves a -0.0 there
    untouched."""
    A = _csr_empty_rows(dtype, cuda)
    n, k = A.num_rows, 8
    empty = torch.ones(n, dtype=torch.bool, device=cuda)
    empty[A.row_list.long()] = False
    g = torch.Generator(device=cuda).manual_seed(30)
    X = torch.randn(A.num_columns, k, generator=g, device=cuda, dtype=dtype)
    first = torch.full((n, k), -0.0, device=cuda, dtype=dtype)
    first[::2] = float("nan")
    csr_spmm_core(A, X, out=first)
    added = torch.full((n, k), -0.0, device=cuda, dtype=dtype)
    csr_spmm_core(A, X, out=added, accumulate=True)
    torch.cuda.synchronize()
    assert bool((first[empty] == 0).all())
    assert not bool(torch.signbit(first[empty]).any())
    assert bool((added[empty] == 0).all())
    assert bool(torch.signbit(added[empty]).all())
    want = csr_spmv_reference(A, X)
    assert _rel_err(first, want) <= TOL[dtype]
    assert _rel_err(added, want) <= TOL[dtype]


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", ["empty_rows", "every_row"])
def test_csr_spmm_columns_bitwise_equal_to_spmv(case, dtype, k, cuda):
    """Column j of the CSR SpMM is bit for bit the CSR SpMV of X[:, j],
    with a row list and without one."""
    if case == "empty_rows":
        A = _csr_empty_rows(dtype, cuda)
    else:
        A = DeviceCsr.from_host(CsrMatrix.from_matrix_market(
            random_sparse(3000, 2000, 9, seed=8)), dtype=dtype, device=cuda)
        assert A.row_list is None
    g = torch.Generator(device=cuda).manual_seed(31)
    X = torch.randn(A.num_columns, k, generator=g, device=cuda, dtype=dtype)
    Y = csr_spmm_core(A, X)
    cols = [csr_spmv_core(A, X[:, j].contiguous()) for j in range(k)]
    torch.cuda.synchronize()
    for j in range(k):
        assert torch.equal(Y[:, j], cols[j]), j


def _two_clusters():
    # a near and a far diagonal in one row group: with segment_rows=2 the
    # far slots escape their segment and spill (tests/test_well.py:188)
    r = np.concatenate([np.arange(128)] * 2)
    c = np.concatenate([np.arange(128), np.arange(128) + 3000])
    return MatrixMarket("matrix", "coordinate", "real", "general", 128,
                        4000, r.size, r + 1, c + 1, np.ones(r.size))


def _empty_blocks():
    # rows 0..127 and 2176..2303 populated: two whole 8-group output
    # blocks in between have no entries (tests/test_well.py:304)
    r = np.concatenate([np.arange(128), np.arange(2176, 2304)])
    return MatrixMarket("matrix", "coordinate", "real", "general", 2304,
                        2304, r.size, r + 1, r + 1, np.ones(r.size))


# name -> (matrix, window_rows, device options)
WELL_CASES = {
    "whole": (lambda: poisson2d(40, 40), 2, {}),
    "whole_blocks_per_out_2": (lambda: poisson2d(40, 40), 2,
                               {"blocks_per_out": 2}),
    "whole_chunks_per_step_2": (lambda: poisson2d(40, 40), 2,
                                {"chunks_per_step": 2}),
    "banded_16384": (lambda: banded_random(16384, 256, 8, seed=3), 4, {}),
    "segment_rows_4": (lambda: banded_random(2000, 60, 5, seed=30), 2,
                       {"segment_rows": 4}),
    "segment_rows_2_spill": (_two_clusters, 1, {"segment_rows": 2}),
    "segmented_blocks_per_out_4": (lambda: poisson2d(64, 64), 2,
                                   {"segment_rows": 8,
                                    "blocks_per_out": 4}),
    "empty_blocks": (_empty_blocks, 1, {"segment_rows": 4}),
    "rectangular": (lambda: random_sparse(200, 150, 5, seed=6), 2, {}),
    "window_spill": (lambda: random_sparse(300, 300, 6, seed=4), 1, {}),
}


@functools.lru_cache(maxsize=None)
def _well_host(case):
    make, window_rows, _ = WELL_CASES[case]
    return WellMatrix.from_matrix_market(make(), window_rows=window_rows)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", list(WELL_CASES))
def test_well_kernels_match_plain(case, dtype, cuda):
    w = _well_host(case)
    A = DeviceWell.from_host(w, dtype=dtype, device=cuda,
                             **WELL_CASES[case][2])
    segmented = A.segment_of_step is not None
    assert segmented == ("segment_rows" in WELL_CASES[case][2])
    core = well_seg_core if segmented else well_whole_core
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(A.num_columns, generator=g, device=cuda, dtype=dtype)
    counters = (well_whole_core, well_seg_core, csr_spmv_core)
    before = [c.launches for c in counters]
    y1, y2 = core(A, x), core(A, x)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    assert _rel_err(y1, well_spmv_reference(A, x)) <= TOL[dtype]
    y = well_spmv_core(A, x)
    torch.cuda.synchronize()
    # one launch a product: the spill is folded into K5
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched == [0 if segmented else 3, 3 if segmented else 0, 0]
    assert torch.equal(y, y1)
    want = torch.from_numpy(w.spmv(x.double().cpu().numpy()))
    assert _rel_err(y.cpu(), want) <= TOL[dtype]


def test_well_unvisited_blocks_read_zero(cuda):
    """An output block that no step visits (and that has no spill) is
    written with zeros (the Pallas kernels never write it): a NaN-filled
    out buffer comes back clean there.  The host packer gives every block
    a chunk, so the inert chunk of the empty block 1 is taken out by
    hand."""
    A0 = DeviceWell.from_host(_well_host("empty_blocks"),
                              dtype=torch.float32, chunks_per_step=1,
                              segment_rows=4)
    keep = (A0.block_of_step != 1).numpy()      # one chunk per step
    assert not keep.all()
    A = DeviceWell(
        A0.num_rows, A0.num_columns, A0.num_entries, A0.window_rows,
        A0.num_groups, 1, 1, A0.segment_rows, A0.value[keep],
        A0.local_index[keep], A0.window_start[keep],
        A0.group_of_chunk[keep], A0.block_of_step[keep],
        A0.segment_of_step[keep], device=cuda)
    assert int(A.step_ptr[1]) == int(A.step_ptr[2])
    x = torch.ones(A.num_columns, device=cuda)
    out = torch.full((A.num_rows,), float("nan"), device=cuda)
    well_seg_core(A, x, out=out)
    torch.cuda.synchronize()
    assert torch.equal(out, well_spmv_reference(A, x))
    assert not out.isnan().any()


def _synthetic_well(dtype, device, segmented):
    """A hand-made container for K5's edges: output block 0 holds chunks
    of 0 (a slot the segment spill emptied: zero values, a nonzero local
    index), 1, 5 (not a prefix) and 8 live slots in groups 0, 3, 3 and
    7; block 1 has no step but has spill entries, one lane of them 200;
    block 2 holds an 8-slot chunk and an inert padding chunk.  x holds
    inf at the one column that only the slots whose bit is clear point
    at; some live columns lie past the end (they read 0)."""
    rng = np.random.default_rng(21)
    n, m, k, inf_col = 24 * 128 - 50, 6000, 2, 5999
    masks = [0, 1 << 3, 0b10101101, 0xff, 0xff, 0]
    groups = [0, 3, 3, 7, 16, 16]
    block_of_step = np.array([0, 0, 2], np.int32)
    seg = np.array([1, 3, 2]) if segmented else np.zeros(3, np.int64)
    value = np.zeros((6, 8, 128))
    loc = np.zeros((6, 8, 128), np.int32)
    ws = np.zeros((6, 8), np.int64)
    for c, mask in enumerate(masks):
        off = seg[c // k]
        for s in range(8):
            if mask >> s & 1:
                ws[c, s] = rng.integers(0, 44)
                loc[c, s] = rng.integers(0, 512, 128)
                col = (ws[c, s] + off) * 128 + loc[c, s]
                loc[c, s][col == inf_col] += 1          # past the end
                value[c, s] = rng.standard_normal(128)
            elif c < 4:
                ws[c, s] = inf_col // 128 - off
                loc[c, s] = inf_col - (ws[c, s] + off) * 128
    window_start = ws.reshape(3, k, 8).transpose(0, 2, 1)
    rows = [5, 130, 1000, 1100, 1500, 2047, 2100, n - 1] + [1425] * 200
    cols = np.concatenate([rng.integers(0, inf_col, 8),
                           rng.choice(inf_col, 200, replace=False)])
    order = np.lexsort((cols, rows))
    rows, cols = np.asarray(rows)[order], cols[order]
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=ptr[1:])
    spill = DeviceCsr(n, m, rows.size, torch.from_numpy(ptr),
                      torch.from_numpy(cols),
                      torch.from_numpy(rng.standard_normal(rows.size))
                      .to(dtype)).to(device)
    A = DeviceWell(n, m, int((value != 0).sum()) + rows.size, 4, 24, k, 1,
                   64 if segmented else None, value, loc, window_start,
                   np.asarray(groups).reshape(3, 1, k), block_of_step,
                   seg if segmented else None, spill, dtype=dtype,
                   device=device)
    x = torch.randn(m, generator=torch.Generator().manual_seed(22),
                    dtype=dtype)
    x[inf_col] = float("inf")
    return A, x.to(device)


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_well_k5_live_slots_and_folded_spill(dtype, segmented, cuda):
    """K5 with the spill folded in against its plain version, twice
    (bitwise equal), on chunks of 0, 1, 5 and 8 live slots, a block that
    no step visits but whose lanes have spill entries, and a lane with
    200 of them; the inf under the slots whose bit is clear stays out."""
    A, x = _synthetic_well(dtype, cuda, segmented)
    assert A.slot_mask.tolist() == [0, 8, 0b10101101, 255, 255, 0]
    assert int(A.step_ptr[1]) == int(A.step_ptr[2])
    lane_counts = (A.spill_ptr[1:] - A.spill_ptr[:-1]).cpu()
    assert int(lane_counts.max()) == 200
    assert int(lane_counts[128:256].sum()) > 0          # block 1's lanes
    core = well_seg_core if segmented else well_whole_core
    counters = (core, csr_spmv_core)
    before = [c.launches for c in counters]
    y1, y2 = core(A, x), core(A, x)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 0]
    assert torch.equal(y1, y2)
    assert torch.isfinite(y1).all()
    want = well_spmv_reference(A, x)
    assert torch.isfinite(want).all()
    assert _rel_err(y1, want) <= TOL[dtype]
    # reading every slot, as the JAX kernels do, meets the inf
    assert not torch.isfinite(
        well_chunks_reference(A, x, masked=False)).all()


WELL_SPMM_KS = (1, 3, 4, 8, 9, 17)
WELL_SPMM_COUNTERS = (well_whole_spmm_core, well_seg_spmm_core,
                      csr_spmm_core)


def _launched(before):
    return [c.launches - b for c, b in zip(WELL_SPMM_COUNTERS, before)]


@pytest.mark.parametrize("k", WELL_SPMM_KS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", list(WELL_CASES))
def test_well_spmm_kernels_match_plain(case, dtype, k, cuda):
    """K6a / K6b, the spill folded in, twice (bitwise equal), against the
    plain version, the fp64 host product and, column by column, K5 on
    that column; ``well_spmm_core`` makes one K6 launch a product and no
    CSR launch."""
    w = _well_host(case)
    A = DeviceWell.from_host(w, dtype=dtype, device=cuda,
                             **WELL_CASES[case][2])
    segmented = A.segment_of_step is not None
    core = well_seg_spmm_core if segmented else well_whole_spmm_core
    spmv_core = well_seg_core if segmented else well_whole_core
    g = torch.Generator(device=cuda).manual_seed(8)
    X = torch.randn(A.num_columns, k, generator=g, device=cuda, dtype=dtype)
    before = [c.launches for c in WELL_SPMM_COUNTERS]
    Y1, Y2 = core(A, X), core(A, X)
    torch.cuda.synchronize()
    assert Y1.shape == (A.num_rows, k)
    assert torch.equal(Y1, Y2)
    assert _rel_err(Y1, well_spmv_reference(A, X)) <= TOL[dtype]
    Y = well_spmm_core(A, X)
    torch.cuda.synchronize()
    assert _launched(before) == [0 if segmented else 3,
                                 3 if segmented else 0, 0]
    assert torch.equal(Y, Y1)
    for j in range(k):
        assert _rel_err(Y[:, j], spmv_core(A, X[:, j].contiguous())) \
            <= TOL[dtype], j
    want = torch.from_numpy(np.stack(
        [w.spmv(X[:, j].double().cpu().numpy()) for j in range(k)], 1))
    assert _rel_err(Y.cpu(), want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", ["whole", "window_spill",
                                  "segment_rows_2_spill",
                                  "segmented_blocks_per_out_4"])
def test_well_spmm_column_blocks_agree(case, dtype, cuda):
    """A column's sums do not depend on its column block: the k = 17
    product (blocks of 8, 8 and 1 columns) equals, bit for bit, the
    products of its 8-, 8- and 1-column slices."""
    A = DeviceWell.from_host(_well_host(case), dtype=dtype, device=cuda,
                             **WELL_CASES[case][2])
    g = torch.Generator(device=cuda).manual_seed(9)
    X = torch.randn(A.num_columns, 17, generator=g, device=cuda,
                    dtype=dtype)
    assert well_spmm_plan(17, dtype, 0, 0)["column_blocks"] == 3
    Y = well_spmm_core(A, X)
    parts = [well_spmm_core(A, X[:, j0:j0 + 8].contiguous())
             for j0 in (0, 8, 16)]
    torch.cuda.synchronize()
    assert torch.equal(Y, torch.cat(parts, dim=1))


@pytest.mark.parametrize("k", [2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", ["whole", "banded_16384",
                                  "segment_rows_2_spill",
                                  "segmented_blocks_per_out_4",
                                  "empty_blocks"])
def test_well_spmm_vector_and_scalar_x_sum_alike(case, dtype, k, cuda):
    """X in 16-byte loads (aligned) or one value at a time (one element
    past a 16-byte boundary): the same Y bit for bit."""
    A = DeviceWell.from_host(_well_host(case), dtype=dtype, device=cuda,
                             **WELL_CASES[case][2])
    g = torch.Generator(device=cuda).manual_seed(10)
    X = torch.randn(A.num_columns, k, generator=g, device=cuda, dtype=dtype)
    Xm = _misaligned(A.num_columns, k, cuda, dtype, 10).copy_(X)
    assert well_spmm_plan(k, dtype, X.data_ptr(), 0)["vector_x"] == (
        (k * X.element_size()) % 16 == 0)
    assert not well_spmm_plan(k, dtype, Xm.data_ptr(), 0)["vector_x"]
    Y, Ym = well_spmm_core(A, X), well_spmm_core(A, Xm)
    torch.cuda.synchronize()
    assert torch.equal(Y, Ym)
    assert _rel_err(Y, well_spmv_reference(A, X)) <= TOL[dtype]


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned",
                                                        "misaligned"])
@pytest.mark.parametrize("k", WELL_SPMM_KS)
@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_well_spmm_live_slots_and_folded_spill(dtype, segmented, k,
                                               aligned, cuda):
    """K6 on the synthetic container of K5's test: chunks of 0, 1, 5 and
    8 live slots, a block that no step visits but whose lanes have spill
    entries, a lane with 200 of them, live columns past the end (they
    read 0) beside X's last row, inf, which only the slots whose bit is
    clear point at: finite, against the plain version, twice (bitwise
    equal), one K6 launch and no CSR launch; X aligned (16-byte loads
    where k allows) or one element past a 16-byte boundary (scalar
    loads), the two bitwise equal."""
    A, _ = _synthetic_well(dtype, cuda, segmented)
    m = A.num_columns
    X = _misaligned(m, k, cuda, dtype, 26)
    X[m - 1] = float("inf")
    if aligned:
        X = X.clone()
    plan = well_spmm_plan(k, dtype, X.data_ptr(), 0)
    assert plan["vector_x"] == (aligned and (k * X.element_size()) % 16
                                == 0)
    core = well_seg_spmm_core if segmented else well_whole_spmm_core
    before = [c.launches for c in WELL_SPMM_COUNTERS]
    Y1, Y2 = core(A, X), well_spmm_core(A, X)
    torch.cuda.synchronize()
    assert _launched(before) == [0 if segmented else 2,
                                 2 if segmented else 0, 0]
    assert torch.equal(Y1, Y2)
    assert bool(torch.isfinite(Y1).all())
    want = well_spmv_reference(A, X)
    assert bool(torch.isfinite(want).all())
    assert _rel_err(Y1, want) <= TOL[dtype]
    other = well_spmm_core(A, X.clone() if not aligned else
                           _misaligned(m, k, cuda, dtype, 26).copy_(X))
    torch.cuda.synchronize()
    assert torch.equal(other, Y1)


def test_well_spmm_unvisited_blocks_read_zero(cuda):
    """An output block that no step visits (and that has no spill) is
    written with zeros in every column: a NaN-filled out buffer comes back
    clean there (the container of test_well_unvisited_blocks_read_zero)."""
    A0 = DeviceWell.from_host(_well_host("empty_blocks"),
                              dtype=torch.float32, chunks_per_step=1,
                              segment_rows=4)
    keep = (A0.block_of_step != 1).numpy()
    A = DeviceWell(
        A0.num_rows, A0.num_columns, A0.num_entries, A0.window_rows,
        A0.num_groups, 1, 1, A0.segment_rows, A0.value[keep],
        A0.local_index[keep], A0.window_start[keep],
        A0.group_of_chunk[keep], A0.block_of_step[keep],
        A0.segment_of_step[keep], device=cuda)
    assert int(A.step_ptr[1]) == int(A.step_ptr[2])
    X = torch.ones(A.num_columns, 9, device=cuda)
    out = torch.full((A.num_rows, 9), float("nan"), device=cuda)
    well_seg_spmm_core(A, X, out=out)
    torch.cuda.synchronize()
    assert torch.equal(out, well_spmv_reference(A, X))
    assert not out.isnan().any()


def _bsr_blocklets(bh, n=1024):
    # dense 8 x 128 blocklets scattered at random (tests/test_bsr.py:172)
    rng = np.random.default_rng(bh)
    base = random_sparse(n // 8, n // 128, 2, seed=bh)
    rows = np.repeat((base.rows_1based - 1) * 8, 8 * 128) \
        + np.tile(np.repeat(np.arange(8), 128), base.num_entries)
    cols = np.repeat((base.cols_1based - 1) * 128, 8 * 128) \
        + np.tile(np.arange(128), 8 * base.num_entries)
    return BsrMatrix._build(n, n, rows, cols, rng.standard_normal(rows.size),
                            None, bh)


def _bsr_empty_row():
    # rows 128..255 empty: the host gives that block row an inert block
    return BsrMatrix.from_matrix_market(MatrixMarket(
        "matrix", "coordinate", "real", "general", 384, 384, 2,
        np.array([1, 384]), np.array([1, 384]), np.array([2.0, 3.0])))


def _bsr_dense_blocks(bh, num_rows, num_columns, per_row, seed):
    """Dense (bh, 128) blocks at random, per_row a block row, cut to a
    ragged (num_rows, num_columns) shape: the last block row and block
    column are partial (TMA's zero fill, rows past num_rows)."""
    rng = np.random.default_rng(seed)
    nbr, nbc = -(-num_rows // bh), -(-num_columns // 128)
    rows, cols = [], []
    for br in range(nbr):
        for bc in rng.choice(nbc, size=min(per_row, nbc), replace=False):
            r, c = np.meshgrid(br * bh + np.arange(bh), bc * 128
                               + np.arange(128), indexing="ij")
            rows.append(r.ravel())
            cols.append(c.ravel())
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    keep = (rows < num_rows) & (cols < num_columns)
    rows, cols = rows[keep], cols[keep]
    return BsrMatrix._build(num_rows, num_columns, rows, cols,
                            rng.standard_normal(rows.size), None, bh)


def _bsr_empty_row_at(bh):
    # block row 1 empty at block height bh: an inert block from the host
    n = 3 * bh
    return BsrMatrix._build(n, 384, np.array([0, n - 1]), np.array([0, 383]),
                            np.array([2.0, 3.0]), None, bh)


# name -> (host matrix, blocks_per_step); bh 64 and 128 with k a multiple
# of 8 are the tensor-core path's shapes for bf16 blocks
BSR_CASES = {
    "bh_8": (lambda: _bsr_blocklets(8), 8),
    "bh_32": (lambda: _bsr_blocklets(32), 8),
    "bh_128_kb_3": (lambda: _bsr_blocklets(128), 3),
    "kb_1": (lambda: BsrMatrix.from_matrix_market(
        banded_random(2048, 300, 24, seed=5)), 1),
    "empty_block_row": (_bsr_empty_row, 8),
    "rect_300x200": (lambda: BsrMatrix.from_matrix_market(
        random_sparse(300, 200, 4, seed=3)), 8),
    "poisson": (lambda: BsrMatrix.from_matrix_market(poisson2d(40, 40),
                                                     block_rows="auto"), 8),
    "bh_64": (lambda: _bsr_dense_blocks(64, 1024, 1024, 3, 1), 1),
    "bh_128": (lambda: _bsr_dense_blocks(128, 1024, 1024, 3, 2), 1),
    "ragged_64": (lambda: _bsr_dense_blocks(64, 1000, 900, 3, 3), 1),
    "ragged_128": (lambda: _bsr_dense_blocks(128, 1000, 900, 3, 4), 1),
    "empty_block_row_64": (lambda: _bsr_empty_row_at(64), 1),
    "empty_block_row_128": (lambda: _bsr_empty_row_at(128), 1),
}


def _bsr_expected_path(dtype, bh, k):
    return ("tensor_core" if dtype == torch.bfloat16 and bh in (64, 128)
            and k % 8 == 0 else "simt")


@pytest.mark.parametrize("k", [1, 3, 8, 16, 40, 128, 136, 256])
@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("case", list(BSR_CASES))
def test_bsr_kernel_matches_plain(case, dtype, k, cuda):
    """K7 twice (bitwise equal) against its plain version, on the path its
    shape selects (that path's counter moves, the other's does not);
    float32 and float64 also against the fp64 host product; the first and
    last column against K7 on that column alone."""
    make, kb = BSR_CASES[case]
    b = make()
    A = DeviceBsr.from_host(b, dtype=dtype, blocks_per_step=kb, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(10)
    X = torch.randn(A.num_columns, k, generator=g, device=cuda).to(dtype)
    path = _bsr_expected_path(dtype, A.block_rows, k)
    assert bsr_path(dtype, A.block_rows, k, X.data_ptr()) == path
    before = (bsr_spmm_core.launches, bsr_spmm_core.tensor_core_launches,
              bsr_spmm_core.simt_launches)
    Y1, Y2 = bsr_spmm_core(A, X), bsr_spmm_core(A, X)
    torch.cuda.synchronize()
    tc = 2 if path == "tensor_core" else 0
    assert (bsr_spmm_core.launches, bsr_spmm_core.tensor_core_launches,
            bsr_spmm_core.simt_launches) == (before[0] + 2, before[1] + tc,
                                             before[2] + 2 - tc)
    assert Y1.dtype == (torch.float32 if dtype == torch.bfloat16 else dtype)
    assert Y1.shape == (A.num_rows, k)
    assert torch.equal(Y1, Y2)
    tol = 1e-5 if dtype == torch.bfloat16 else TOL[dtype]
    assert _rel_err(Y1, bsr_spmm_reference(A, X)) <= tol
    for j in (0, k - 1):
        assert _rel_err(Y1[:, j], bsr_spmm_core(A, X[:, j:j + 1].contiguous()
                                                )[:, 0]) <= tol
    if dtype != torch.bfloat16:
        want = torch.from_numpy(b.spmm(X.double().cpu().numpy()))
        assert _rel_err(Y1.cpu(), want) <= TOL[dtype]


@pytest.mark.parametrize("case", ["bh_64", "ragged_128"])
def test_bsr_misaligned_x_takes_the_simt_path(case, cuda):
    """bf16 X whose base is not 16-byte aligned cannot be a TMA tensor
    map: the SIMT path takes it, with the same result as an aligned
    copy on the tensor cores."""
    A = DeviceBsr.from_host(BSR_CASES[case][0](), dtype=torch.bfloat16,
                            blocks_per_step=1, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(11)
    flat = torch.randn(A.num_columns * 16 + 1, generator=g,
                       device=cuda).to(torch.bfloat16)
    X = flat[1:].view(A.num_columns, 16)
    assert X.data_ptr() % 16 != 0 and X.is_contiguous()
    assert bsr_path(torch.bfloat16, A.block_rows, 16, X.data_ptr()) == "simt"
    before = bsr_spmm_core.simt_launches
    Y = bsr_spmm_core(A, X)
    torch.cuda.synchronize()
    assert bsr_spmm_core.simt_launches == before + 1
    assert _rel_err(Y, bsr_spmm_reference(A, X)) <= 1e-5
    assert _rel_err(Y, bsr_spmm_core(A, X.clone())) <= 1e-5


# ---------------------------------------------------------------- AMG, K8

# (grid, smooth_levels, block): aligned with 1 and 0 smoothed levels,
# identity padding (1,920 rows to 2,048), an offset of 64 rows past the
# JAX lane chunk (the guard the port drops), a 3-level hierarchy, and
# aggregates of 3 rows (K8's restriction without the warp shuffle), and
# 65,536 rows (seven levels, the coarse ones a few threads' worth)
FUSED_CASES = {
    "p16x128": ((16, 128), 1, 4),
    "p16x128_plain": ((16, 128), 0, 4),
    "p16x120": ((16, 120), 1, 4),
    "p64x16": ((64, 16), 1, 4),
    "p32x512": ((32, 512), 1, 4),
    "p48x64_block3": ((48, 64), 1, 3),
    "p256x256": ((256, 256), 1, 4),
}
# the JAX fused V-cycle test's bound in float32 (tests/test_fused_vcycle.py:65)
FUSED_TOL = {torch.float64: 1e-12, torch.float32: 5e-6}


def _fused(case, dtype, device):
    from spmv_tpu_torch.ops import fused_block_setup, fused_vcycle_device

    shape, smooth, block = FUSED_CASES[case]
    hier = fused_block_setup(CsrMatrix.from_matrix_market(poisson2d(*shape)),
                             smooth_levels=smooth, block=block)
    return fused_vcycle_device(hier, dtype=dtype, device=device)


def _norm_rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


@pytest.mark.parametrize("dtype", list(FUSED_TOL), ids=str)
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_vcycle_matches_plain(case, dtype, cuda):
    """K8 twice (bitwise equal) against fused_vcycle_reference on the same
    card tensors: relative 2-norm 1e-12 in float64, 5e-6 in float32."""
    from spmv_tpu_torch.ops import fused_vcycle_core, fused_vcycle_reference

    fv = _fused(case, dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    b = torch.randn(fv.padded_rows, generator=g, device=cuda,
                    dtype=torch.float64).to(dtype)
    before = fused_vcycle_core.launches
    y1, y2 = fused_vcycle_core(fv, b), fused_vcycle_core(fv, b)
    torch.cuda.synchronize()
    assert fused_vcycle_core.launches == before + 2
    assert torch.equal(y1, y2)
    assert torch.isfinite(y1).all()
    assert _norm_rel(y1, fused_vcycle_reference(fv, b)) <= FUSED_TOL[dtype]


@pytest.mark.parametrize("dtype", list(FUSED_TOL), ids=str)
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_vcycle_barrier_counter_back_at_zero(case, dtype, cuda):
    """After each launch K8's grid barrier's arrival counter is back at 0,
    and its generation word has advanced by the barriers of one cycle:
    2 degree + 2 a smoothed level, 2 degree a plain one (the pre-smoother's
    first step and a plain level's prolongation fused into the next), one
    after the coarse solve, none after the last step."""
    from spmv_tpu_torch.ops import fused_vcycle_core

    fv = _fused(case, dtype, cuda)
    b = torch.ones(fv.padded_rows, device=cuda, dtype=dtype)
    gens = []
    for _ in range(3):
        fused_vcycle_core(fv, b)
        torch.cuda.synchronize()
        assert int(fv.barrier[0]) == 0
        gens.append(int(fv.barrier[1]))
    d = fv.degree
    assert d >= 2
    want = sum(2 * d + 2 if sm else 2 * d for sm in fv.smoothed)
    assert gens[2] - gens[1] == gens[1] - gens[0] == want


def test_fused_vcycle_one_launch_per_apply(cuda):
    """PCG with the fused preconditioner: K8 launches once per apply."""
    from spmv_tpu_torch.ops import (
        fused_vcycle_core,
        fused_vcycle_preconditioner,
        preconditioned_conjugate_gradient,
    )

    mm = poisson2d(32, 64)
    apply, info = fused_vcycle_preconditioner(
        CsrMatrix.from_matrix_market(mm), dtype=torch.float64, device=cuda)
    A = DeviceDia.from_host(DiaMatrix.from_matrix_market(mm),
                            dtype=torch.float64, device=cuda)
    applies = [0]

    def counted(r):
        applies[0] += 1
        return apply(r)

    before = fused_vcycle_core.launches
    b = A(torch.ones(mm.num_rows, dtype=torch.float64, device=cuda))
    res = preconditioned_conjugate_gradient(A, b, counted, tol=1e-10,
                                            max_iterations=100)
    assert info["kind"] == "sa-amg-fused"
    assert 0 < res.iterations < 40
    assert fused_vcycle_core.launches - before == applies[0] \
        == res.iterations + 1
    assert float((res.x - 1).abs().max()) < 1e-7


def test_fused_vcycle_refusals(cuda):
    """bfloat16 and a hierarchy padded between levels are refused."""
    from spmv_tpu_torch.errors import MatrixError
    from spmv_tpu_torch.ops import block_aggregation_setup

    with pytest.raises(MatrixError, match="float32 or float64"):
        _fused("p16x128", torch.bfloat16, cuda)
    from spmv_tpu_torch.ops import fused_vcycle_device

    hier = block_aggregation_setup(
        CsrMatrix.from_matrix_market(poisson2d(65, 63)))
    with pytest.raises(MatrixError, match="fused-aligned"):
        fused_vcycle_device(hier, device=cuda)


def test_generic_vcycle_on_card_matches_cpu(cuda):
    """The generic V-cycle (A, P, P^T on the CSR kernel) on the card
    against its CPU run, float64."""
    from spmv_tpu_torch.ops import amg_preconditioner, smoothed_aggregation_setup

    m = CsrMatrix.from_matrix_market(poisson2d(48, 48))
    hier = smoothed_aggregation_setup(m, coarse_size=64)
    r = torch.from_numpy(np.random.default_rng(4).standard_normal(m.num_rows))
    want = amg_preconditioner(hierarchy=hier, dtype=torch.float64,
                              device="cpu")[0](r)
    before = csr_spmv_core.launches
    got = amg_preconditioner(hierarchy=hier, dtype=torch.float64,
                             device=cuda)[0](r.to(cuda))
    torch.cuda.synchronize()
    assert csr_spmv_core.launches > before
    assert _norm_rel(got, want) <= 1e-12


@pytest.mark.parametrize("max_diagonals", [96, 6])
def test_block_vcycle_on_card_matches_cpu(max_diagonals, cuda):
    """The block V-cycle (K1 per level; max_diagonals 6 forces the
    Galerkin levels onto the CSR kernel) on the card against its CPU run,
    float64."""
    from spmv_tpu_torch.ops import block_aggregation_setup
    from spmv_tpu_torch.ops.amg import block_amg_device, block_vcycle

    m = CsrMatrix.from_matrix_market(poisson2d(40, 36))
    hier = block_aggregation_setup(m, coarse_size=64)
    r = torch.from_numpy(np.random.default_rng(5).standard_normal(
        hier.levels[0].n_pad))
    devs = {d: block_amg_device(hier, dtype=torch.float64, device=d,
                                max_diagonals=max_diagonals)
            for d in ("cpu", cuda)}
    kinds = [type(lv.a).__name__ for lv in devs[cuda].levels]
    assert kinds[0] == "DeviceDia"
    assert ("DeviceCsr" in kinds) == (max_diagonals == 6)
    before = dia_spmv_core.launches
    got = block_vcycle(devs[cuda], r.to(cuda))
    torch.cuda.synchronize()
    assert dia_spmv_core.launches > before
    assert _norm_rel(got, block_vcycle(devs["cpu"], r)) <= 1e-12


# ELL: slot-major arrays, one thread a row adding its slots in order.
# Rows not a multiple of 32 (1001), a skewed matrix with empty rows
# (powerlaw, 2,000 rows of 1 to about 300 slots) and a stencil.
ELL_CASES = {
    "poisson": lambda: poisson2d(40, 30),
    "powerlaw": lambda: powerlaw(2000, 1500, 5.0, seed=2),
    "rows_1001": lambda: random_sparse(1001, 700, 7, seed=1),
}


def _ell(case, dtype, device, skip_padding=False):
    return DeviceEll.from_host(EllMatrix.from_matrix_market(
        ELL_CASES[case](), skip_padding=skip_padding), dtype=dtype,
        device=device)


def _ell_width(width, rows, dtype, device, aligned=True):
    """A DeviceEll of ``rows`` rows and ``width`` slots (padded_row_length
    = width, so the SpMV runs that template or the rounds past 8): random
    columns below 700 with about a fifth of the slots padding (column 0,
    value 0) and one row all padding; with ``aligned`` False its index
    and value buffers start one element past a 16-byte boundary."""
    rng = np.random.default_rng(1000 * width + rows)
    cols = rng.integers(0, 700, size=(width, rows)).astype(np.int32)
    vals = rng.standard_normal((width, rows))
    pad = rng.random((width, rows)) < 0.2
    pad[:, rows // 2] = True
    cols[pad], vals[pad] = 0, 0.0
    ci = torch.from_numpy(cols).to(device)
    va = torch.from_numpy(vals).to(device, dtype)
    if not aligned:
        ci = torch.cat([ci.new_zeros(1), ci.reshape(-1)])[1:].view(width,
                                                                   rows)
        va = torch.cat([va.new_zeros(1), va.reshape(-1)])[1:].view(width,
                                                                   rows)
    A = DeviceEll(rows, 700, int((~pad).sum()), width, ci, va)
    assert (A.column_index.data_ptr() % 16 == 0) == aligned
    return A


def _ell_check(A, dtype, cuda, seed, k=3):
    """The ELL SpMV on A against its plain version, twice bitwise and
    under accumulate, and the ELL SpMM's columns (k of them) bitwise the
    SpMV's."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(A.num_columns, generator=g, device=cuda, dtype=dtype)
    X = torch.randn(A.num_columns, k, generator=g, device=cuda, dtype=dtype)
    before = ell_spmv_core.launches
    y1, y2 = ell_spmv_core(A, x), ell_spmv_core(A, x)
    out = torch.full((A.num_rows,), 0.5, device=cuda, dtype=dtype)
    ell_spmv_core(A, x, out=out, accumulate=True)
    Y = ell_spmm_core(A, X)
    cols = torch.stack([ell_spmv_core(A, X[:, j].contiguous())
                        for j in range(k)], dim=1)
    torch.cuda.synchronize()
    assert ell_spmv_core.launches == before + 3 + k
    assert torch.equal(y1, y2)
    assert torch.equal(Y, cols)
    want = ell_spmv_reference(A, x)
    assert _rel_err(y1, want) <= TOL[dtype]
    assert _rel_err(out, want + 0.5) <= TOL[dtype]


@pytest.mark.parametrize("skip", [False, True], ids=["pad", "skip"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", list(ELL_CASES))
def test_ell_spmv_matches_plain(case, dtype, skip, cuda):
    _ell_check(_ell(case, dtype, cuda, skip), dtype, cuda, 40)


# The ELL SpMV's paths (ell_spmv_plan): row lengths on both sides of the
# template's 8 slots and of a round of 8; rows a multiple of a block and
# not; buffers aligned or a view one element off a 16-byte boundary.
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("rows", [1024, 1001])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("width", [1, 4, 5, 6, 8, 9, 12])
def test_ell_spmv_paths_match_plain(width, dtype, rows, aligned, cuda):
    A = _ell_width(width, rows, dtype, cuda, aligned)
    assert ell_spmv_plan(width)["slots"] == (
        width if width <= ELL_MAX_SLOTS else 0)
    _ell_check(A, dtype, cuda, 43 + width)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("k", [1, 3, 8, 11])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", list(ELL_CASES))
def test_ell_spmm_matches_plain(case, dtype, k, aligned, cuda):
    """Against the plain version, twice bitwise, under accumulate, and
    column by column bitwise the SpMV kernel's (the same order of adds);
    X aligned to 16 bytes (16-byte moves where k allows) or one element
    off (scalar moves)."""
    A = _ell(case, dtype, cuda)
    if aligned:
        g = torch.Generator(device=cuda).manual_seed(41)
        X = torch.randn(A.num_columns, k, generator=g, device=cuda,
                        dtype=dtype)
    else:
        X = _misaligned(A.num_columns, k, cuda, dtype, 41)
    before = ell_spmm_core.launches
    Y1, Y2 = ell_spmm_core(A, X), ell_spmm_core(A, X)
    out = torch.full((A.num_rows, k), 0.5, device=cuda, dtype=dtype)
    ell_spmm_core(A, X, out=out, accumulate=True)
    cols = torch.stack([ell_spmv_core(A, X[:, j].contiguous())
                        for j in range(k)], dim=1)
    torch.cuda.synchronize()
    assert ell_spmm_core.launches == before + 3
    assert torch.equal(Y1, Y2)
    assert torch.equal(Y1, cols)
    want = ell_spmv_reference(A, X)
    assert _rel_err(Y1, want) <= TOL[dtype]
    assert _rel_err(out, want + 0.5) <= TOL[dtype]


@pytest.mark.parametrize("rows", [2000, 2001])
@pytest.mark.parametrize("k", [None, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("width", ["median", "zero", "longest", 5, 6, 9])
def test_hybrid_matches_plain(width, dtype, k, rows, cuda):
    """The ELL launch writes every row, then the CSR launch adds the COO
    part; where the part is empty (width = the longest row) no CSR
    kernel is launched and nothing raises.  ELL widths on both sides of
    the SpMV's 8-slot template, rows a multiple of its R and not."""
    mm = powerlaw(rows, 1500, 5.0, seed=2)
    L = {"median": None, "zero": 0,
         "longest": int(mm.max_row_length())}.get(width, width)
    host = HybridMatrix.from_matrix_market(mm, ell_row_length=L)
    A = DeviceHybrid.from_host(host, dtype=dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(42)
    shape = (A.num_columns,) if k is None else (A.num_columns, k)
    v = torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    ell_w, csr_w = ((ell_spmv_core, csr_spmv_core) if k is None
                    else (ell_spmm_core, csr_spmm_core))
    before = (ell_w.launches, csr_w.launches)
    core = hybrid_spmv_core if k is None else hybrid_spmm_core
    out = torch.full((A.num_rows,) + shape[1:], float("nan"), device=cuda,
                     dtype=dtype)
    y = core(A, v, out=out)
    y2 = core(A, v)
    torch.cuda.synchronize()
    coo = host.num_coo_entries > 0
    assert ell_w.launches == before[0] + 2
    assert csr_w.launches == before[1] + (2 if coo else 0)
    assert torch.equal(y, y2)
    assert _rel_err(y, hybrid_spmv_reference(A, v)) <= TOL[dtype]
    if k is not None:
        cols = torch.stack([hybrid_spmv_core(A, v[:, j].contiguous())
                            for j in range(k)], dim=1)
        assert torch.equal(y, cols)


@pytest.mark.parametrize("k", [None, 3])
def test_csr_wrappers_on_an_empty_part_raise_nothing(k, cuda):
    """A ``DeviceCsr`` with no entry (a hybrid's empty COO part: its row
    list is an empty tensor) through both CSR wrappers, adding into y:
    y is unchanged."""
    mm = poisson2d(20, 20)
    host = HybridMatrix.from_matrix_market(
        mm, ell_row_length=int(mm.max_row_length()))
    R = DeviceHybrid.from_host(host, dtype=torch.float32, device=cuda).coo
    assert R.value.numel() == 0 and R.row_list.numel() == 0
    shape = (R.num_columns,) if k is None else (R.num_columns, k)
    v = torch.ones(shape, device=cuda)
    out = torch.full((R.num_rows,) + shape[1:], 2.0, device=cuda)
    if k is None:
        csr_spmv_core(R, v, out=out, accumulate=True)
    else:
        csr_spmm_core(R, v, out=out, accumulate=True)
        first = torch.full_like(out, float("nan"))
        csr_spmm_core(R, v, out=first)
        torch.cuda.synchronize()
        assert bool((first == 0).all())
    torch.cuda.synchronize()
    assert bool((out == 2.0).all())


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_xla_csr_matches_csr_kernel(dtype, k, cuda):
    """``-s xla-csr``'s ``torch.sparse`` product (cuSPARSE) against the
    port's CSR kernel on the same entries, which it never launches."""
    A = DeviceCsr.from_host(CsrMatrix.from_matrix_market(
        random_sparse(3000, 2000, 9, seed=8)), dtype=dtype, device=cuda)
    S = DeviceSparseCsr(A)
    g = torch.Generator(device=cuda).manual_seed(43)
    shape = (A.num_columns,) if k is None else (A.num_columns, k)
    v = torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    before = (csr_spmv_core.launches, csr_spmm_core.launches)
    got = sparse_csr_core(S, v)
    torch.cuda.synchronize()
    assert (csr_spmv_core.launches, csr_spmm_core.launches) == before
    want = csr_spmv_core(A, v) if k is None else csr_spmm_core(A, v)
    assert _rel_err(got, want) <= TOL[dtype]


# The CSR kernels on long rows (csrc/csr_rows.cuh): the thresholds set
# small (a warp past 16 entries, a block past 128) so that a 4096-row
# powerlaw matrix with every fourth row emptied has warp rows, block rows
# and empty rows.
LONG_SMALL = (16, 128)


@pytest.fixture
def long_small(monkeypatch):
    monkeypatch.setattr(device_module, "LONG_ROW", LONG_SMALL[0])
    monkeypatch.setattr(device_module, "BLOCK_ROW", LONG_SMALL[1])


def _long_rows_mm():
    mm = powerlaw(4096, 3000, 8.0, seed=5)
    r, c = np.asarray(mm.rows_1based) - 1, np.asarray(mm.cols_1based) - 1
    keep = r % 4 != 1
    return from_coo_arrays(4096, 3000, r[keep], c[keep],
                           np.asarray(mm.values)[keep])


def _long_rows_csr(dtype, device):
    A = DeviceCsr.from_host(CsrMatrix.from_matrix_market(_long_rows_mm()),
                            dtype=dtype, device=device)
    n = np.diff(A.row_ptr.cpu().numpy())
    assert A.long_rows is not None and A.num_block_rows > 0
    assert A.long_rows.numel() > A.num_block_rows and (n == 0).any()
    return A


def _fma_exact(a, b, c):
    """a * b + c rounded once, element by element (float64)."""
    return np.array([float(Fraction(float(a)) * Fraction(float(bb))
                           + Fraction(float(cc)))
                     for bb, cc in zip(np.ravel(b), np.ravel(c))])


def _csr_core(k):
    return csr_spmv_core if k is None else csr_spmm_core


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("k", [None, 1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_csr_long_rows_match_plain(dtype, k, accumulate, cuda, long_small):
    """Both CSR kernels with warp, block and empty rows against the plain
    version, twice bitwise; under accumulate an empty row keeps its
    -0.0."""
    A = _long_rows_csr(dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(44)
    shape = (A.num_columns,) if k is None else (A.num_columns, k)
    v = torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    core = _csr_core(k)
    oshape = (A.num_rows,) + shape[1:]
    runs = []
    for _ in range(2):
        out = torch.full(oshape, -0.0 if accumulate else float("nan"),
                         device=cuda, dtype=dtype)
        before = core.launches
        runs.append(core(A, v, out=out, accumulate=accumulate))
        assert core.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert bool(torch.isfinite(runs[0]).all())
    assert _rel_err(runs[0], csr_spmv_reference(A, v)) <= TOL[dtype]
    if accumulate:
        empty = A.row_ptr[1:] == A.row_ptr[:-1]
        assert bool(torch.signbit(runs[0][empty]).all())


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_csr_long_rows_spmm_columns_bitwise_spmv(dtype, k, cuda,
                                                  long_small):
    A = _long_rows_csr(dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(45)
    X = torch.randn(A.num_columns, k, generator=g, device=cuda, dtype=dtype)
    out = torch.full((A.num_rows, k), 0.25, device=cuda, dtype=dtype)
    Y = csr_spmm_core(A, X)
    Ya = csr_spmm_core(A, X, out=out.clone(), accumulate=True)
    for j in range(k):
        xj = X[:, j].contiguous()
        assert torch.equal(Y[:, j], csr_spmv_core(A, xj)), j
        assert torch.equal(Ya[:, j], csr_spmv_core(
            A, xj, out=out[:, j].contiguous(), accumulate=True)), j


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("case", ["long_rows", "no_long_row"])
def test_csr_kernels_repeat_the_walk_bitwise(case, k, accumulate, cuda,
                                             long_small):
    """float64: the kernels give the numpy walk's bits, long rows in the
    walk's lane and tree order, short rows a fused multiply-add an entry
    in storage order (the kernel of no split, as before it)."""
    mm = (_long_rows_mm() if case == "long_rows"
          else random_sparse(3000, 2000, 9, seed=8))
    A = DeviceCsr.from_host(CsrMatrix.from_matrix_market(mm),
                            dtype=torch.float64, device=cuda)
    assert (A.long_rows is None) == (case == "no_long_row")
    rng = np.random.default_rng(46)
    X = rng.standard_normal(A.num_columns if k is None
                            else (A.num_columns, k))
    shape = (A.num_rows,) if k is None else (A.num_rows, k)
    out = rng.standard_normal(shape) if accumulate else None
    got = _csr_core(k)(
        A, torch.from_numpy(X).to(cuda),
        out=None if out is None else torch.from_numpy(out).to(cuda),
        accumulate=accumulate).cpu().numpy()
    want = csr_walk(A.row_ptr.cpu().numpy(), A.column_index.cpu().numpy(),
                    A.value.cpu().numpy(), X, *LONG_SMALL, out=out,
                    fma=_fma_exact)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [None, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_hybrid_with_long_rows_matches_plain(dtype, k, cuda, long_small):
    """The hybrid product whose COO part has warp and block rows: two
    launches, twice bitwise, against the plain version."""
    host = HybridMatrix.from_matrix_market(powerlaw(4096, 4096, 8.0, seed=5))
    A = DeviceHybrid.from_host(host, dtype=dtype, device=cuda)
    assert A.coo.long_rows is not None and A.coo.num_block_rows > 0
    g = torch.Generator(device=cuda).manual_seed(47)
    shape = (A.num_columns,) if k is None else (A.num_columns, k)
    v = torch.randn(shape, generator=g, device=cuda, dtype=dtype)
    core = hybrid_spmv_core if k is None else hybrid_spmm_core
    y1, y2 = core(A, v), core(A, v)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    assert _rel_err(y1, hybrid_spmv_reference(A, v)) <= TOL[dtype]


@pytest.mark.parametrize("k", [3, 8])
def test_csr_spmm_long_rows_with_every_row_listed(k, cuda, long_small):
    """A row list that holds the long rows too (every row listed), and
    no list: the short walk leaves the long rows to their warps and
    blocks, and Y is the container's bit for bit."""
    A = _long_rows_csr(torch.float32, cuda)
    X = _misaligned(A.num_columns, k, cuda, torch.float32, 48)
    listed = A.row_list
    runs = []
    for rows in (listed, torch.arange(A.num_rows, dtype=torch.int32,
                                      device=cuda), None):
        A.row_list = rows
        try:
            runs.append(csr_spmm_core(A, X))
        finally:
            A.row_list = listed
    torch.cuda.synchronize()
    for Y in runs[1:]:
        assert torch.equal(Y, runs[0])


# The traffic-isolation variants: name -> (variant wrapper, plain version,
# full product), each variant taking (A, x) (x unused by the stream-only
# ones).
TRAFFIC = {
    "csr_regular": (lambda A, x: csr_regular_core(A),
                    lambda A, x: csr_regular_reference(A), csr_spmv_core),
    "csr_irregular": (csr_irregular_core, csr_irregular_reference,
                      csr_spmv_core),
    "ell_regular": (lambda A, x: ell_regular_core(A),
                    lambda A, x: ell_regular_reference(A), ell_spmv_core),
    "ell_irregular": (ell_irregular_core, ell_irregular_reference,
                      ell_spmv_core),
    "well_regular": (lambda A, x: well_regular_core(A),
                     lambda A, x: well_regular_reference(A), well_spmv_core),
    "well_irregular": (well_irregular_core, well_irregular_reference,
                       well_spmv_core),
}
TRAFFIC_COUNTERS = (csr_regular_core, csr_irregular_core, ell_regular_core,
                    ell_irregular_core, well_regular_core,
                    well_irregular_core, csr_spmv_core, ell_spmv_core,
                    well_whole_core, well_seg_core)


def _traffic_cases(fmt):
    """(label, maker) of the matrices each format's variants run
    on: CSR with and without long rows (the thresholds patched small),
    ELL at row lengths on both sides of the 8-slot template, every WELL
    case (whole x and segmented, with and without a spill)."""
    if fmt == "csr":
        return {"rect": lambda dt, dev: DeviceCsr.from_host(
                    CsrMatrix.from_matrix_market(
                        random_sparse(300, 250, 7, seed=3)), dtype=dt,
                    device=dev),
                "long_rows": _long_rows_csr}
    if fmt == "ell":
        cases = {c: functools.partial(lambda c, dt, dev: _ell(c, dt, dev),
                                      c) for c in ELL_CASES}
        for w in (1, 6, 9, 12):
            cases[f"width_{w}"] = functools.partial(
                lambda w, dt, dev: _ell_width(w, 1001, dt, dev), w)
        return cases
    return {c: functools.partial(
        lambda c, dt, dev: DeviceWell.from_host(
            _well_host(c), dtype=dt, device=dev, **WELL_CASES[c][2]), c)
        for c in WELL_CASES}


def _unit(A):
    """A with every stored value 1 (a WELL container keeps its
    slot_mask, so the same slots stay live)."""
    if isinstance(A, DeviceWell):
        B = DeviceWell.__new__(DeviceWell)
        B.__dict__.update(A.__dict__)
        B._buffers = dict(A._buffers, value=torch.ones_like(A.value),
                          spill_value=None if A.spill_value is None
                          else torch.ones_like(A.spill_value))
        return B
    if isinstance(A, DeviceEll):
        return DeviceEll(A.num_rows, A.num_columns, A.num_entries,
                         A.row_length, A.column_index,
                         torch.ones_like(A.value))
    B = DeviceCsr(A.num_rows, A.num_columns, A.num_entries, A.row_ptr,
                  A.column_index, torch.ones_like(A.value))
    B.long_rows, B.num_block_rows = A.long_rows, A.num_block_rows
    return B


_TRAFFIC_PARAMS = [(name, case) for name in TRAFFIC
                   for case in _traffic_cases(name.split("_")[0])]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("name,case", _TRAFFIC_PARAMS,
                         ids=[f"{n}-{c}" for n, c in _TRAFFIC_PARAMS])
def test_traffic_variants_match_plain(name, case, dtype, cuda, long_small):
    """Each variant against its plain version, twice bitwise, its own
    count moving by its launches and no other kernel's; the full kernel
    on ones (stream-only) or on unit values (gather-only) gives the
    variant's bits."""
    variant, plain, full = TRAFFIC[name]
    A = _traffic_cases(name.split("_")[0])[case](dtype, cuda)
    g = torch.Generator(device=cuda).manual_seed(53)
    x = torch.randn(A.num_columns, generator=g, device=cuda, dtype=dtype)
    before = [c.launches for c in TRAFFIC_COUNTERS]
    y1, y2 = variant(A, x), variant(A, x)
    torch.cuda.synchronize()
    moved = [c.launches - b for c, b in zip(TRAFFIC_COUNTERS, before)]
    own = [c.__name__ for c in TRAFFIC_COUNTERS].index(f"{name}_core")
    assert moved == [2 if i == own else 0 for i in range(len(moved))]
    assert torch.equal(y1, y2)
    assert _rel_err(y1, plain(A, x)) <= TOL[dtype]
    if name.endswith("_regular"):
        same = full(A, torch.ones_like(x))
    else:
        same = full(_unit(A), x)
    torch.cuda.synchronize()
    assert torch.equal(same, y1)


@pytest.mark.parametrize("coo", [True, False], ids=["coo", "no_coo"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_hybrid_traffic_variants_match_plain(dtype, coo, cuda, long_small):
    """The hybrid's variants: the ELL variant, then the CSR variant adding
    the COO part (its long rows on warps and blocks; not launched where
    the part is empty), each against the parts' plain versions."""
    from spmv_tpu_torch.ops import (
        hybrid_irregular_core,
        hybrid_regular_core,
    )

    mm = powerlaw(4096, 4096, 8.0, seed=5)
    host = HybridMatrix.from_matrix_market(
        mm, ell_row_length=None if coo else int(mm.max_row_length()))
    A = DeviceHybrid.from_host(host, dtype=dtype, device=cuda)
    assert (A.coo.value.numel() > 0) == coo
    g = torch.Generator(device=cuda).manual_seed(54)
    x = torch.randn(A.num_columns, generator=g, device=cuda, dtype=dtype)
    counters = (ell_regular_core, csr_regular_core, ell_irregular_core,
                csr_irregular_core)
    before = [c.launches for c in counters]
    reg, irr = hybrid_regular_core(A), hybrid_irregular_core(A, x)
    reg2, irr2 = hybrid_regular_core(A), hybrid_irregular_core(A, x)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [
        2, 2 * coo, 2, 2 * coo]
    assert torch.equal(reg, reg2) and torch.equal(irr, irr2)
    want_reg = ell_regular_reference(A.ell)
    want_irr = ell_irregular_reference(A.ell, x)
    if coo:
        want_reg = want_reg + csr_regular_reference(A.coo)
        want_irr = want_irr + csr_irregular_reference(A.coo, x)
    assert _rel_err(reg, want_reg) <= TOL[dtype]
    assert _rel_err(irr, want_irr) <= TOL[dtype]


# ------------------------------------------------ level-scheduled tri solve
# The kernels' tolerances (TOL): an error made at one level feeds every
# later level, but 2,047 levels measured 1.7e-7 in float32 and 1.5e-16 in
# float64 on an H100 (chip_smoke.py phase 28).
TRI_TOL = TOL


def _diag_dominant(n, seed):
    """A random non-symmetric sparse matrix with a dominant diagonal."""
    mm = random_sparse(n, n, 4, seed=seed)
    rows = np.asarray(mm.rows_1based, np.int64) - 1
    cols = np.asarray(mm.cols_1based, np.int64) - 1
    vals = np.asarray(mm.values, np.float64)
    off = rows != cols
    rows, cols, vals = rows[off], cols[off], vals[off]
    dom = np.bincount(rows, weights=np.abs(vals), minlength=n) + 1.0
    return from_coo_arrays(n, n, np.concatenate([rows, np.arange(n)]),
                           np.concatenate([cols, np.arange(n)]),
                           np.concatenate([vals, dom]))


def _tri_factors(case):
    """(factor, lower, unit_diag) triangles of each kind the solves see."""
    from spmv_tpu_torch.models import reorder
    from spmv_tpu_torch.ops import ic0_factor, ilu0_factor
    from spmv_tpu_torch.ops.incomplete import _transpose_csr

    if case == "ic0_natural":
        L = ic0_factor(CsrMatrix.from_matrix_market(poisson2d(40, 30)))
        return [(L, True, False), (_transpose_csr(L), False, False)]
    if case in ("ilu0_natural", "ilu0_colored", "ilu0_colored_stencil"):
        # the stencil's two colors make every level a row range (the
        # kernel's Contig path: L's shifts 0, U's not); the random
        # pattern's colors do not
        mm = (poisson2d(40, 30) if case == "ilu0_colored_stencil"
              else _diag_dominant(600, seed=3))
        if case != "ilu0_natural":
            mm = mm.permute(reorder.find_new_order_coloring(mm))
        L, U = ilu0_factor(CsrMatrix.from_matrix_market(mm))
        return [(L, True, True), (U, False, False)]
    if case == "one_row_levels":
        # a bidiagonal chain: every level holds one row
        n = 300
        i = np.arange(1, n)
        mm = from_coo_arrays(n, n, np.concatenate([np.arange(n), i]),
                             np.concatenate([np.arange(n), i - 1]),
                             np.concatenate([np.full(n, 2.0),
                                             np.full(n - 1, -0.5)]))
        return [(CsrMatrix.from_matrix_market(mm), True, False)]
    # no dependency at all: the diagonal alone, and a unit diagonal with
    # an empty strict part
    n = 257
    d = from_coo_arrays(n, n, np.arange(n), np.arange(n),
                        np.linspace(1.0, 3.0, n))
    empty = CsrMatrix(n, n, 0, 1, np.zeros(n + 1, np.int64),
                      np.zeros(0, np.int32), np.zeros(0))
    return [(CsrMatrix.from_matrix_market(d), True, False),
            (empty, True, True)]


TRI_CASES = ("ic0_natural", "ilu0_natural", "ilu0_colored",
             "ilu0_colored_stencil", "one_row_levels", "no_dependencies")


@pytest.mark.parametrize("sweeps", [None, 0, 1, 3], ids=lambda s: (
    "levels" if s is None else f"sweeps{s}"))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", TRI_CASES)
def test_tri_solve_matches_plain(case, dtype, sweeps, cuda):
    """The kernel against its plain version in the mode its plan picks
    (one launch a non-empty level, or one chained launch a solve) and the
    sweep mode (one launch a sweep), twice bitwise; the exact solve also
    against a dense solve in float64."""
    from spmv_tpu_torch.ops import (
        DeviceTriSolve,
        tri_solve_core,
        tri_solve_plan,
        tri_solve_reference,
        tri_sweeps_reference,
    )

    for t, lower, unit in _tri_factors(case):
        T = DeviceTriSolve.from_host(t, lower=lower, unit_diag=unit,
                                     dtype=dtype, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(71)
        b = torch.randn(T.n, generator=g, device=cuda, dtype=dtype)
        before = tri_solve_core.launches
        z1 = tri_solve_core(T, b, sweeps=sweeps)
        z2 = tri_solve_core(T, b, sweeps=sweeps)
        torch.cuda.synchronize()
        per = (sweeps if sweeps is not None else
               1 if tri_solve_plan(T) == "chained" else T.num_levels)
        assert tri_solve_core.launches - before == 2 * per
        assert torch.equal(z1, z2)
        want = (tri_solve_reference(T, b) if sweeps is None
                else tri_sweeps_reference(T, b, sweeps))
        if sweeps == 0:
            assert torch.equal(z1, torch.zeros_like(z1))
            continue
        assert _rel(z1, want) <= TRI_TOL[dtype]
        if sweeps is None and dtype == torch.float64:
            dense = np.zeros((t.num_rows, t.num_columns))
            rows = np.repeat(np.arange(t.num_rows), np.diff(t.row_ptr))
            np.add.at(dense, (rows, t.column_index), t.value)
            if unit:
                np.fill_diagonal(dense, 1.0)
            exact = np.linalg.solve(dense, b.cpu().numpy())
            assert _rel(z1.cpu(), torch.from_numpy(exact)) <= 1e-10


def test_tri_solve_sweeps_reach_the_exact_solve(cuda):
    """num_levels sweeps give the level solve (Jacobi on a triangle is
    exact after as many sweeps as levels)."""
    from spmv_tpu_torch.ops import DeviceTriSolve, tri_solve_core

    L, _ = _tri_factors("ic0_natural")[0][:2]
    T = DeviceTriSolve.from_host(L, dtype=torch.float64, device=cuda)
    b = torch.ones(T.n, dtype=torch.float64, device=cuda)
    exact = tri_solve_core(T, b)
    swept = tri_solve_core(T, b, sweeps=T.num_levels)
    assert _rel(swept, exact) <= 1e-12


@pytest.mark.parametrize("sweeps", [None, 3], ids=lambda s: (
    "levels" if s is None else f"sweeps{s}"))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_tri_solve_skips_what_it_need_not_read(dtype, sweeps, cuda):
    """After coloring a stencil, every level is a row range
    (``level_shift``) and ILU(0)'s L has a unit diagonal: the kernel's
    level mode then reads neither
    ``level_rows`` nor ``diag_inv``, so overwriting them (rows with 0,
    1/diagonal with NaN) leaves its z unchanged.  U's sweep has shifted
    levels, so it still reads ``level_rows`` there and is left as is.
    The exact solve runs in the level mode here, whatever the plan picks
    (the chained mode reads ``level_rows`` where a shift is not 0)."""
    from spmv_tpu_torch.ops import DeviceTriSolve, tri_solve_core

    for t, lower, unit in _tri_factors("ilu0_colored_stencil"):
        T = DeviceTriSolve.from_host(t, lower=lower, unit_diag=unit,
                                     dtype=dtype, device=cuda)
        assert T.level_shift is not None and T.unit_diag == lower
        assert T.level_shift.any() != lower
        b = torch.randn(T.n, generator=torch.Generator(
            device=cuda).manual_seed(72), device=cuda, dtype=dtype)
        mode = "levels" if sweeps is None else None
        want = tri_solve_core(T, b, sweeps=sweeps, mode=mode)
        identity = not T.level_shift.any()
        if sweeps is None or identity:
            T.level_rows.zero_()
        if unit:
            T.diag_inv.fill_(float("nan"))
        assert torch.equal(tri_solve_core(T, b, sweeps=sweeps, mode=mode),
                           want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", TRI_CASES)
def test_tri_solve_chained_matches_levels(case, dtype, cuda):
    """The chained mode (one launch a solve, rows waiting on ready flags)
    bitwise against the level mode and against the plain version, on
    every triangle kind (lower and upper, unit and not, colored and
    natural), whichever mode the plan would pick."""
    from spmv_tpu_torch.ops import (
        DeviceTriSolve,
        tri_solve_core,
        tri_solve_reference,
    )

    for t, lower, unit in _tri_factors(case):
        T = DeviceTriSolve.from_host(t, lower=lower, unit_diag=unit,
                                     dtype=dtype, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(73)
        b = torch.randn(T.n, generator=g, device=cuda, dtype=dtype)
        levels = tri_solve_core(T, b, mode="levels")
        before = tri_solve_core.launches
        chained = tri_solve_core(T, b, mode="chained")
        torch.cuda.synchronize()
        assert tri_solve_core.launches - before == 1
        assert torch.equal(chained, levels)
        assert _rel(chained, tri_solve_reference(T, b)) <= TRI_TOL[dtype]


def _chain(n):
    """A bidiagonal chain of n rows: every level holds one row."""
    i = np.arange(1, n)
    return CsrMatrix.from_matrix_market(from_coo_arrays(
        n, n, np.concatenate([np.arange(n), i]),
        np.concatenate([np.arange(n), i - 1]),
        np.concatenate([np.full(n, 2.0), np.full(n - 1, -0.5)])))


@pytest.mark.parametrize("n", [1, 31, 33, 1025, 2 * 256 * 7 + 5])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_tri_solve_chained_ragged_rows(n, dtype, cuda):
    """Row counts that fill no whole ticket (32 rows) or block: a chain
    of n rows and a natural-order IC(0) L of about n rows (where its
    count is not a multiple of 32 either), chained against levels."""
    from spmv_tpu_torch.ops import DeviceTriSolve, ic0_factor, tri_solve_core

    assert n % 32 != 0
    nx = max(1, int(np.sqrt(n)))
    cases = [_chain(n)]
    if nx * (n // nx) % 32:
        cases.append(ic0_factor(CsrMatrix.from_matrix_market(
            poisson2d(nx, n // nx))))
    for t in cases:
        T = DeviceTriSolve.from_host(t, dtype=dtype, device=cuda)
        b = torch.randn(T.n, generator=torch.Generator(
            device=cuda).manual_seed(n), device=cuda, dtype=dtype)
        assert torch.equal(tri_solve_core(T, b, mode="chained"),
                           tri_solve_core(T, b, mode="levels"))


_LONG_CHAIN = """
import sys
import numpy as np
import torch
from spmv_tpu_torch.io.generate import from_coo_arrays
from spmv_tpu_torch.models import CsrMatrix
from spmv_tpu_torch.ops import DeviceTriSolve, tri_solve_core
n = int(sys.argv[1])
i = np.arange(1, n)
chain = CsrMatrix.from_matrix_market(from_coo_arrays(
    n, n, np.concatenate([np.arange(n), i]),
    np.concatenate([np.arange(n), i - 1]),
    np.concatenate([np.full(n, 2.0), np.full(n - 1, -0.5)])))
T = DeviceTriSolve.from_host(chain, dtype=torch.float64,
                             device=torch.device("cuda"))
b = torch.linspace(-1.0, 1.0, n, dtype=torch.float64, device="cuda")
z = tri_solve_core(T, b, mode="chained")
torch.cuda.synchronize()
np.save(sys.argv[2], z.cpu().numpy())
print(T.num_levels)
"""


def test_tri_solve_chained_long_chain_ends(cuda, tmp_path):
    """20,000 levels of one row, chained, in a process of its own that
    must end within 300 s (a deadlock would hold the launch): z against
    the recurrence z[i] = (b[i] + 0.5 z[i-1]) / 2 at float64."""
    import os
    import subprocess
    import sys

    n = 20_000
    out = tmp_path / "z.npy"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", _LONG_CHAIN, str(n),
                        str(out)], cwd=repo, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [str(n)]
    b = np.linspace(-1.0, 1.0, n)
    want = np.empty(n)
    prev = 0.0
    for i in range(n):
        prev = want[i] = (b[i] + 0.5 * prev) * 0.5
    got = np.load(out)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_tri_solve_chained_graph_replays(dtype, cuda):
    """One CUDA graph of a chained solve, replayed three times on new b
    with z set to NaN before each: every replay gives the level mode's
    bits for its b (a stale epoch would let rows read unset z)."""
    from spmv_tpu_torch.ops import DeviceTriSolve, tri_solve_core

    for t, lower, unit in _tri_factors("ic0_natural"):
        T = DeviceTriSolve.from_host(t, lower=lower, unit_diag=unit,
                                     dtype=dtype, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(74)
        bs = [torch.randn(T.n, generator=g, device=cuda, dtype=dtype)
              for _ in range(4)]
        b, z = bs[0].clone(), torch.empty(T.n, device=cuda, dtype=dtype)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            tri_solve_core(T, b, out=z, mode="chained")   # warm up
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            tri_solve_core(T, b, out=z, mode="chained")
        for new in bs[1:]:
            b.copy_(new)
            z.fill_(float("nan"))
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(z, tri_solve_core(T, new, mode="levels"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_tri_solve_chained_twice_in_a_row(dtype, cuda):
    """Two chained solves of one container queued back to back (no
    synchronisation between), on two right-hand sides: each the level
    mode's bits."""
    from spmv_tpu_torch.ops import DeviceTriSolve, tri_solve_core

    for t, lower, unit in _tri_factors("ilu0_natural"):
        T = DeviceTriSolve.from_host(t, lower=lower, unit_diag=unit,
                                     dtype=dtype, device=cuda)
        g = torch.Generator(device=cuda).manual_seed(75)
        b1, b2 = (torch.randn(T.n, generator=g, device=cuda, dtype=dtype)
                  for _ in range(2))
        z1 = tri_solve_core(T, b1, mode="chained")
        z2 = tri_solve_core(T, b2, mode="chained")
        torch.cuda.synchronize()
        assert torch.equal(z1, tri_solve_core(T, b1, mode="levels"))
        assert torch.equal(z2, tri_solve_core(T, b2, mode="levels"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("block", ["dia", "csr"])
def test_block_tri_solve_rectangular_blocks(block, dtype, cuda):
    """BlockTriSolve after --reorder color: each level's dependency block
    is a rectangular (rows of the level) x n matrix on K1 (DIA) or the
    CSR kernel; the solve on the card against its CPU run."""
    from spmv_tpu_torch.models import reorder
    from spmv_tpu_torch.ops import BlockTriSolve, ic0_factor

    mm = poisson2d(48, 40)
    mm = mm.permute(reorder.find_new_order_coloring(mm))
    L = ic0_factor(CsrMatrix.from_matrix_market(mm))
    kw = {} if block == "dia" else {"max_diagonals": 1}
    dev = BlockTriSolve.from_host(L, dtype=dtype, device=cuda, **kw)
    cpu = BlockTriSolve.from_host(L, dtype=dtype, device="cpu", **kw)
    blocks = [b for b in dev.blocks if b is not None]
    assert blocks and all(b.num_rows != b.num_columns for b in blocks)
    assert {b.format_name for b in blocks} == {block}
    counter = dia_spmv_core if block == "dia" else csr_spmv_core
    before = counter.launches
    g = torch.Generator().manual_seed(72)
    b = torch.randn(L.num_rows, generator=g, dtype=dtype)
    z = dev.solve(b.to(cuda))
    torch.cuda.synchronize()
    assert counter.launches - before == len(blocks)
    assert _rel(z.cpu(), cpu.solve(b)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_rectangular_dia_and_csr_kernels(dtype, cuda):
    """K1 and the CSR SpMV on a tall and a wide matrix: x of num_columns,
    y of num_rows."""
    for shape in ((300, 1000), (1000, 300)):
        mm = random_sparse(*shape, 5, seed=sum(shape))
        A = DeviceCsr.from_host(CsrMatrix.from_matrix_market(mm),
                                dtype=dtype, device=cuda)
        D = DeviceDia.from_host(DiaMatrix.from_matrix_market(mm),
                                dtype=dtype, device=cuda)
        x = torch.randn(shape[1], dtype=dtype, device=cuda)
        for y, want in ((csr_spmv_core(A, x), csr_spmv_reference(A, x)),
                        (dia_spmv_core(D, x), dia_spmv_reference(D, x))):
            assert y.shape == (shape[0],)
            assert _rel(y, want) <= TOL[dtype]


# ------------------------------------------------------------ LOBPCG

def _lobpcg_case(kind, device, dtype, tol, X0, max_iterations=200):
    """lobpcg on ``device`` with K2 (``dia``) or the CSR SpMM (``csr``) at
    poisson2d(20, 18), or K2 and the block AMG apply (``amg``) at
    poisson2d(40, 36): the result and the SpMM launches it made (K2's,
    else the CSR SpMM's)."""
    from spmv_tpu_torch.ops import amg_preconditioner, lobpcg, spmm

    mm = poisson2d(*LOBPCG_GRID[kind])
    if kind == "csr":
        A = DeviceCsr.from_host(CsrMatrix.from_matrix_market(mm),
                                dtype=dtype, device=device)
        count = csr_spmm_core
    else:
        A = DeviceDia.from_host(DiaMatrix.from_matrix_market(mm),
                                dtype=dtype, device=device)
        count = dia_spmm_core
    minv = None
    if kind == "amg":
        minv, _ = amg_preconditioner(CsrMatrix.from_matrix_market(mm),
                                     dtype=dtype, device=device,
                                     coarse_size=64)
    before = count.launches
    res = lobpcg(lambda V: spmm(A, V), X0.to(device=device, dtype=dtype),
                 preconditioner=minv, tol=tol,
                 max_iterations=max_iterations,
                 P0=_lobpcg_p0(X0.shape).to(device=device, dtype=dtype))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return res, count.launches - before


LOBPCG_GRID = {"dia": (20, 18), "csr": (20, 18), "amg": (40, 36)}


def _lobpcg_x0(kind):
    nx, ny = LOBPCG_GRID[kind]
    return torch.from_numpy(np.random.default_rng(11).standard_normal(
        (nx * ny, 4)))


def _lobpcg_p0(shape):
    return torch.from_numpy(np.random.default_rng(12).standard_normal(shape))


def _poisson_smallest(nx, ny, k):
    i, j = np.arange(1, nx + 1), np.arange(1, ny + 1)
    lam = (4.0 - 2.0 * np.cos(i * np.pi / (nx + 1))[:, None]
           - 2.0 * np.cos(j * np.pi / (ny + 1))[None, :])
    return np.sort(lam.reshape(-1))[:k]


@pytest.mark.parametrize("kind", ["dia", "csr", "amg"])
def test_lobpcg_on_card_matches_cpu(kind, cuda):
    """float64: the card's eigenvalues against the CPU run's (the
    kernels' plain versions) and the analytic ones, and one SpMM launch
    for X, one for P and one a step.  The block AMG apply launches the
    CSR SpMM and never the CSR SpMV (no column loop)."""
    X0 = _lobpcg_x0(kind)
    cpu, _ = _lobpcg_case(kind, torch.device("cpu"), torch.float64, 1e-8, X0)
    spmv_before = csr_spmv_core.launches
    amg_before = csr_spmm_core.launches
    card, launches = _lobpcg_case(kind, cuda, torch.float64, 1e-8, X0)
    assert card.eigenvalues.device.type == "cuda"
    assert card.iterations < 200
    assert launches == 2 + card.iterations
    if kind == "amg":
        assert csr_spmm_core.launches > amg_before
        assert csr_spmv_core.launches == spmv_before
    np.testing.assert_allclose(card.eigenvalues.cpu().numpy(),
                               cpu.eigenvalues.numpy(), rtol=1e-10)
    np.testing.assert_allclose(card.eigenvalues.cpu().numpy(),
                               _poisson_smallest(*LOBPCG_GRID[kind], 4),
                               rtol=1e-8)
    assert float(card.residual_norms.max()) <= 1e-8


def test_lobpcg_float32_contractions_stay_float32(cuda):
    """With TF32 switched on for the whole process, the solver's own
    products still run in float32: the float32 solve reaches tol.  The
    same solve with the products left to the switch (``_ieee_fp32``
    made a no-op) stalls above tol: TF32's 10-bit mantissa floors the
    residual near 1e-3 of ||A||."""
    import contextlib

    from spmv_tpu_torch.ops import eigen

    X0 = _lobpcg_x0("amg")
    flags = torch.backends.cuda.matmul
    old = flags.fp32_precision
    flags.fp32_precision = "tf32"
    try:
        good, launches = _lobpcg_case("amg", cuda, torch.float32, 1e-4, X0)
        pinned = eigen._ieee_fp32
        eigen._ieee_fp32 = contextlib.nullcontext
        try:
            bad, _ = _lobpcg_case("amg", cuda, torch.float32, 1e-4, X0)
        finally:
            eigen._ieee_fp32 = pinned
        assert flags.fp32_precision == "tf32"
    finally:
        flags.fp32_precision = old
    assert good.iterations < 200 and launches == 2 + good.iterations
    assert float(good.residual_norms.max()) <= 1e-4
    assert bad.iterations == 200
    assert float(bad.residual_norms.max()) > 1e-4
    np.testing.assert_allclose(good.eigenvalues.cpu().numpy(),
                               _poisson_smallest(40, 36, 4), rtol=1e-3)


# The sharded paths (``parallel``) on P virtual shards of the card: each
# shard's product one launch of the kernel of its format (two for the halo
# CSR path where a shard reads a halo), held against the same sharded
# product on the CPU (the plain versions) and against the unsharded
# kernel; CG over each strategy stops within 2 iterations of its CPU run.

SHARD_P = (1, 2, 4)


def _sharded(kind, m, d, P, dtype, device, exchange="auto"):
    """(sharded matrix, product, stack, unstack, counted wrappers)."""
    from spmv_tpu_torch import parallel as par

    mesh = par.make_mesh(P, devices=[device] * P)
    if kind == "dia":
        A = par.shard_dia(d, P, dtype=dtype, mesh=mesh)
        return (A, par.make_sharded_dia_matvec(A, mesh),
                lambda v: par.stack_dia_vector(v, A),
                lambda v: par.unstack_dia_vector(v, A), (dia_spmv_core,))
    if kind == "csr":
        A = par.shard_csr(m, P, dtype=dtype, mesh=mesh)
        return (A, par.make_sharded_matvec(A, mesh),
                lambda v: par.stack_vector(v, A),
                lambda v: par.unstack_vector(v, A), (csr_spmv_core,))
    A = par.shard_csr_halo(m, P, dtype=dtype, mesh=mesh, exchange=exchange)
    return (A, par.make_sharded_halo_matvec(A, mesh),
            lambda v: par.stack_vector(v, A),
            lambda v: par.unstack_vector(v, A), (csr_spmv_core,))


@pytest.mark.parametrize("P", SHARD_P)
@pytest.mark.parametrize("kind,exchange", [("dia", "auto"), ("csr", "auto"),
                                           ("halo", "auto"),
                                           ("halo", "all2all")])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_sharded_spmv_on_the_card(cuda, P, kind, exchange, dtype):
    mm = poisson2d(48, 40)
    m, d = CsrMatrix.from_matrix_market(mm), DiaMatrix.from_matrix_market(mm)
    x = np.random.default_rng(7).standard_normal(m.num_rows)
    A, mv, stack, unstack, wrappers = _sharded(kind, m, d, P, dtype, cuda,
                                               exchange)
    before = [w.launches for w in wrappers]
    xs = stack(x)
    y = mv(xs)
    y2 = mv(xs)
    torch.cuda.synchronize()
    launches = sum(w.launches - b for w, b in zip(wrappers, before))
    extra = 0 if kind != "halo" else sum(b is not None for b in A.boundary)
    assert launches == 2 * (P + extra)
    assert torch.equal(y, y2)
    _, cmv, cstack, _, _ = _sharded(kind, m, d, P, dtype,
                                    torch.device("cpu"), exchange)
    want = cmv(cstack(x))
    scale = float(want.abs().max())
    assert float((y.cpu() - want).abs().max()) <= TOL[dtype] * scale
    full = (DeviceDia.from_host(d, dtype=dtype, device=cuda) if kind == "dia"
            else DeviceCsr.from_host(m, dtype=dtype, device=cuda))
    core = dia_spmv_core if kind == "dia" else csr_spmv_core
    ref = core(full, torch.from_numpy(x).to(cuda, dtype)).cpu().numpy()
    assert np.abs(unstack(y) - ref).max() <= TOL[dtype] * np.abs(ref).max()


@pytest.mark.parametrize("P", SHARD_P)
def test_sharded_spmm_on_the_card(cuda, P):
    """The DIA SpMM (K2 a shard, stacked (P, k, Rb)) and the halo CSR SpMM
    (interior and boundary CSR SpMM a shard, stacked (P, R, k)) against
    their CPU runs."""
    from spmv_tpu_torch import parallel as par

    mm = poisson2d(48, 40)
    m, d = CsrMatrix.from_matrix_market(mm), DiaMatrix.from_matrix_market(mm)
    X = np.random.default_rng(8).standard_normal((m.num_rows, 3))
    for device in (cuda, torch.device("cpu")):
        mesh = par.make_mesh(P, devices=[device] * P)
        D = par.shard_dia(d, P, dtype=torch.float64, mesh=mesh)
        H = par.shard_csr_halo(m, P, dtype=torch.float64, mesh=mesh)
        k2, spmm = dia_spmm_core.launches, csr_spmm_core.launches
        Yd = par.unstack_dia_matrix(par.sharded_dia_spmm(
            D, par.stack_dia_matrix(X, D), mesh), D)
        Yh = par.unstack_block(par.sharded_halo_spmm(
            H, par.stack_block(X, H), mesh), H)
        if device.type == "cuda":
            got = (Yd, Yh)
            assert dia_spmm_core.launches - k2 == P
            assert csr_spmm_core.launches - spmm == P + sum(
                b is not None for b in H.boundary)
    for a, b in zip(got, (Yd, Yh)):
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()


@pytest.mark.parametrize("kind", ["dia", "csr", "halo"])
def test_sharded_cg_on_the_card(cuda, kind):
    """CG over each strategy at P = 4, float64: within 2 iterations of its
    CPU run, x at 1e-8 of the solution."""
    mm = poisson2d(48, 40)
    m, d = CsrMatrix.from_matrix_market(mm), DiaMatrix.from_matrix_market(mm)
    b = m.spmv(np.ones(m.num_rows))
    from spmv_tpu_torch.ops import conjugate_gradient

    res = {}
    for device in (cuda, torch.device("cpu")):
        _, mv, stack, unstack, _ = _sharded(kind, m, d, 4, torch.float64,
                                            device)
        r = conjugate_gradient(mv, stack(b), tol=1e-10, max_iterations=2000)
        res[device.type] = (r.iterations, unstack(r.x))
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 2
    assert np.abs(res["cuda"][1] - 1.0).max() <= 1e-8


# The second sharded half on P virtual shards of the card: the WELL
# all-gather and halo SpMV, the WELL-CW halo SpMV and SpMM, the BSR tile
# halo SpMM (float32 and float64 on the SIMT kernel, bfloat16 blocks of 128
# rows at k = 8 on the tensor cores) and the block-Jacobi IC(0) apply, each
# launched twice (bitwise equal), its launches exactly the container's
# ``launches_a_product`` (``launches_an_apply``), held against its CPU run
# and the fp64 host product; then Chebyshev, Jacobi-PCG, block-IC(0) PCG
# and masked LOBPCG over the sharded operators against their CPU runs, and
# ``dryrun_multichip`` on the card.

SHARD_FORMAT_CASES = {
    "well": ("poisson", "auto", 1),
    "well_halo": ("poisson", "auto", 1),
    "well_halo_all2all": ("poisson", "all2all", 1),
    "wellcw": ("banded", "auto", 1),
    "wellcw_all2all": ("scattered", "all2all", 1),
    "wellcw_spmm": ("banded", "auto", 3),
    "bsr": ("poisson", "auto", 3),
    "bsr_all2all": ("poisson", "all2all", 3),
}


@functools.lru_cache(maxsize=None)
def _shard_mm(name):
    return {"poisson": lambda: poisson2d(48, 40),
            "banded": lambda: banded_random(4000, 300, 8, seed=3),
            "scattered": lambda: random_sparse(1536, 1536, 5, seed=4),
            "blocks": lambda: _bsr_dense_blocks(128, 1024, 1024, 3, 5)}[name]()


def _shard_format(case, P, dtype, device):
    """(sharded matrix, product on a host (n,) or (n, k) array -> device
    result, unstack to host, host fp64 product)."""
    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.parallel import bsr_shard

    name, exchange, k = SHARD_FORMAT_CASES[case]
    mm = _shard_mm(name)
    m = CsrMatrix.from_matrix_market(mm)
    mesh = par.make_mesh(P, devices=[device] * P)
    if case.startswith("bsr"):
        A = par.shard_bsr_halo(BsrMatrix.from_matrix_market(mm, block_rows=8),
                               P, dtype=dtype, mesh=mesh, exchange=exchange)
        return (A, lambda X: par.sharded_bsr_spmm(
                    A, bsr_shard.stack_columns(X, A), mesh),
                lambda Y: bsr_shard.unstack_rows(Y, A), m)
    if case == "well":
        A = par.shard_well(m, P, window_rows=2, dtype=dtype, mesh=mesh)
        product = par.sharded_well_spmv
    elif case.startswith("well_halo"):
        A = par.shard_well_halo(m, P, window_rows=2, dtype=dtype, mesh=mesh,
                                exchange=exchange)
        product = par.sharded_well_halo_spmv
    else:
        A = par.shard_wellcw_halo(m, P, dtype=dtype, mesh=mesh,
                                  exchange=exchange)
        product = (par.sharded_wellcw_halo_spmm if k > 1
                   else par.sharded_wellcw_halo_spmv)
    stack = par.stack_block if k > 1 else par.stack_vector
    unstack = par.unstack_block if k > 1 else par.unstack_vector
    return (A, lambda X: product(A, stack(X, A), mesh),
            lambda Y: unstack(Y, A), m)


def _counts(names):
    from spmv_tpu_torch import ops

    return {n: getattr(ops, n).launches for n in names}


def _host_product(m, X):
    return (m.spmv(X) if X.ndim == 1
            else np.stack([m.spmv(c) for c in X.T], axis=1))


@pytest.mark.parametrize("P", SHARD_P)
@pytest.mark.parametrize("case", list(SHARD_FORMAT_CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_sharded_format_products_on_the_card(cuda, P, case, dtype):
    A, product, unstack, m = _shard_format(case, P, dtype, cuda)
    k = SHARD_FORMAT_CASES[case][2]
    rng = np.random.default_rng(9)
    X = (rng.standard_normal(m.num_rows) if k == 1
         else rng.standard_normal((m.num_rows, k)))
    want = (A.launches_a_product(spmm=True) if case == "wellcw_spmm"
            else A.launches_a_product())
    before = _counts(want)
    y1 = product(X)
    y2 = product(X)
    torch.cuda.synchronize()
    after = _counts(want)
    assert {n: after[n] - before[n] for n in want} == {
        n: 2 * c for n, c in want.items()}
    assert torch.equal(y1, y2)
    assert sum(want.values()) >= P
    C, cproduct, _, _ = _shard_format(case, P, dtype, torch.device("cpu"))
    plain = cproduct(X)
    assert _rel_err(y1.cpu(), plain) <= TOL[dtype]
    ref = _host_product(m, X)
    got = unstack(y1)
    assert np.abs(got - ref).max() <= TOL[dtype] * np.abs(ref).max()


@pytest.mark.parametrize("P", SHARD_P)
def test_sharded_bsr_tensor_cores(cuda, P):
    """bfloat16 blocks of 128 rows at k = 8: one tensor-core K7 launch a
    shard on its extended X, float32 Y, against the CPU run (the same
    bfloat16 products summed in float32) to 1e-5 of the output's scale."""
    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.parallel import bsr_shard

    host = _shard_mm("blocks")
    X = np.random.default_rng(10).standard_normal((host.num_columns, 8))
    out = {}
    for device in (cuda, torch.device("cpu")):
        mesh = par.make_mesh(P, devices=[device] * P)
        A = par.shard_bsr_halo(host, P, dtype=torch.bfloat16, mesh=mesh)
        tc = bsr_spmm_core.tensor_core_launches
        Y = par.sharded_bsr_spmm(A, bsr_shard.stack_columns(X, A), mesh)
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert bsr_spmm_core.tensor_core_launches - tc == P
        assert Y.dtype == torch.float32
        out[device.type] = Y.cpu()
    scale = float(out["cpu"].abs().max())
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("P", SHARD_P)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_sharded_block_ic0_apply_on_the_card(cuda, P, dtype):
    from spmv_tpu_torch import parallel as par

    m = CsrMatrix.from_matrix_market(_shard_mm("poisson"))
    r = np.random.default_rng(11).standard_normal(m.num_rows)
    out = {}
    for device in (cuda, torch.device("cpu")):
        mesh = par.make_mesh(P, devices=[device] * P)
        H = par.shard_csr_halo(m, P, dtype=dtype, mesh=mesh)
        M = par.block_jacobi_ic0(m, H.bounds, H.rows_per_shard, dtype=dtype,
                                 mesh=mesh)
        want = M.launches_an_apply()
        before = _counts(want)
        z = par.sharded_block_ic0_apply(M, par.stack_vector(r, H), mesh)
        if device.type == "cuda":
            torch.cuda.synchronize()
            after = _counts(want)
            assert {n: after[n] - before[n] for n in want} == want
        out[device.type] = z.cpu()
    assert _rel_err(out["cuda"], out["cpu"]) <= TOL[dtype]


def _shard_solvers(device):
    """Iterations and solutions of Chebyshev, Jacobi-PCG and block-IC(0)
    PCG over the halo CSR matvec, and masked LOBPCG (k = 2) over its
    SpMM, at P = 4 in float64."""
    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.ops import (
        chebyshev,
        extract_diagonal,
        jacobi_preconditioner,
        lanczos_bounds,
        lobpcg,
        preconditioned_conjugate_gradient,
    )

    m = CsrMatrix.from_matrix_market(_shard_mm("poisson"))
    f64 = torch.float64
    mesh = par.make_mesh(4, devices=[device] * 4)
    H = par.shard_csr_halo(m, 4, dtype=f64, mesh=mesh)
    mv = par.make_sharded_halo_matvec(H, mesh)
    rng = np.random.default_rng(12)
    bs = par.stack_vector(m.spmv(np.ones(m.num_rows)), H)
    v0 = par.stack_vector(rng.standard_normal(m.num_rows), H)
    lo, hi = lanczos_bounds(mv, tuple(bs.shape), dtype=f64, v0=v0,
                            device=device)
    out = {"bounds": (lo, hi)}
    out["chebyshev"] = chebyshev(mv, bs, lo, hi, tol=1e-10,
                                 max_iterations=5000, check_every=10)
    jac = jacobi_preconditioner(par.stack_vector(extract_diagonal(m), H))
    out["jacobi"] = preconditioned_conjugate_gradient(
        mv, bs, jac, tol=1e-10, max_iterations=2000, recompute_every=25)
    M = par.block_jacobi_ic0(m, H.bounds, H.rows_per_shard, dtype=f64,
                             mesh=mesh)
    out["block_ic0"] = preconditioned_conjugate_gradient(
        mv, bs, par.make_sharded_block_ic0_preconditioner(M, mesh),
        tol=1e-10, max_iterations=2000, recompute_every=25)
    P_, R = H.num_shards, H.rows_per_shard
    mask = np.zeros((P_, R))
    for q in range(P_):
        mask[q, : H.bounds[q + 1] - H.bounds[q]] = 1.0
    mask[:, R - 1] = 0.0
    mm = par.make_sharded_halo_matmat(H, mesh)
    X0 = par.stack_block(rng.standard_normal((m.num_rows, 2)), H)
    P0 = torch.from_numpy(rng.standard_normal((P_ * R, 2))).to(device)
    out["lobpcg"] = lobpcg(
        lambda V: mm(V.reshape(P_, R, 2)).reshape(P_ * R, 2),
        X0.reshape(P_ * R, 2), tol=1e-9, max_iterations=400,
        mask=torch.from_numpy(mask.reshape(-1)).to(device), P0=P0)
    out["unstack"] = lambda v: par.unstack_vector(v, H)
    return out


def test_sharded_solvers_on_the_card(cuda):
    gpu, cpu = _shard_solvers(cuda), _shard_solvers(torch.device("cpu"))
    np.testing.assert_allclose(gpu["bounds"], cpu["bounds"], rtol=1e-10)
    for name in ("chebyshev", "jacobi", "block_ic0"):
        assert abs(gpu[name].iterations - cpu[name].iterations) <= 2, name
        assert np.abs(gpu["unstack"](gpu[name].x) - 1.0).max() <= 1e-8
    assert gpu["block_ic0"].iterations < gpu["jacobi"].iterations
    assert abs(int(gpu["lobpcg"].iterations)
               - int(cpu["lobpcg"].iterations)) <= 2
    np.testing.assert_allclose(gpu["lobpcg"].eigenvalues.cpu().numpy(),
                               _poisson_smallest(48, 40, 2), rtol=1e-8)


def test_dryrun_multichip_on_the_card(cuda):
    from spmv_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, device=cuda)
    assert len(out) == 11
    assert all(r["rel_err"] < 1e-3 for r in out.values())


def test_one_rank_nccl_process_mesh_keeps_the_virtual_shards_bits(
        cuda, tmp_path):
    """A one-rank NCCL job over a file store: on its process mesh of 4
    shards, whose collectives (the gathers of x and of the unstacked
    vectors, the solvers' dots) go through NCCL, the DIA halo SpMV and
    SpMM, the all-gather CSR and the halo CSR SpMV (neighbor and
    all2all) are bitwise the virtual shards' products, and CG over the
    DIA halo stops at their count."""
    import torch.distributed as dist

    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.ops import conjugate_gradient

    mm = poisson2d(48, 40)
    m, d = CsrMatrix.from_matrix_market(mm), DiaMatrix.from_matrix_market(mm)
    x = np.random.default_rng(9).standard_normal(m.num_rows)
    X = np.random.default_rng(10).standard_normal((m.num_rows, 3))
    assert not dist.is_initialized()
    assert par.initialize_distributed(f"file://{tmp_path}/store", 1,
                                      0) is False
    try:
        assert dist.get_backend() == "nccl"
        mesh = par.global_mesh(4)
        assert (mesh.world_size, mesh.local_shards) == (1, range(0, 4))
        virtual = par.make_mesh(4, devices=[mesh.device] * 4)
        out = {}
        for name, on in (("process", mesh), ("virtual", virtual)):
            D = par.shard_dia(d, 4, dtype=torch.float64, mesh=on)
            y = par.sharded_dia_spmv(D, par.stack_dia_vector(x, D), on)
            Y = par.sharded_dia_spmm(D, par.stack_dia_matrix(X, D), on)
            res = {"dia": y, "dia_spmm": Y,
                   "dia_full": par.unstack_dia_vector(y, D)}
            for kind in ("all_gather", "neighbor", "all2all"):
                A = (par.shard_csr(m, 4, dtype=torch.float64, mesh=on)
                     if kind == "all_gather" else par.shard_csr_halo(
                         m, 4, dtype=torch.float64, mesh=on, exchange=kind))
                product = (par.sharded_spmv if kind == "all_gather"
                           else par.sharded_halo_spmv)
                res[kind] = product(A, par.stack_vector(x, A, on), on)
            b = par.stack_dia_vector(d.spmv(np.ones(d.num_rows)), D)
            res["cg"] = conjugate_gradient(
                par.make_sharded_dia_matvec(D, on), b, tol=1e-10,
                max_iterations=2000, mesh=on).iterations
            out[name] = res
    finally:
        dist.destroy_process_group()
    for key in ("dia", "dia_spmm", "all_gather", "neighbor", "all2all"):
        assert torch.equal(out["process"][key], out["virtual"][key]), key
    assert np.array_equal(out["process"]["dia_full"],
                          out["virtual"]["dia_full"])
    assert out["process"]["cg"] == out["virtual"]["cg"] < 2000


def test_one_rank_nccl_process_mesh_keeps_the_formats_bits(cuda, tmp_path):
    """The second half on a one-rank NCCL job's process mesh of 4 shards:
    the WELL all-gather and halo SpMV, the WELL-CW halo SpMV and SpMM
    (neighbor and all2all), the BSR halo SpMM (float32 and bfloat16
    blocks) and the block-IC(0) apply are bitwise the virtual shards'
    products; every container reports the same envelope numbers."""
    import torch.distributed as dist

    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.parallel import bsr_shard

    m = CsrMatrix.from_matrix_market(banded_random(3000, 200, 6, seed=4))
    spd = CsrMatrix.from_matrix_market(poisson2d(48, 40))
    bm = BsrMatrix.from_matrix_market(poisson2d(48, 40), block_rows=16)
    f64 = torch.float64
    x = np.random.default_rng(11).standard_normal(m.num_rows)
    X = np.random.default_rng(12).standard_normal((m.num_rows, 3))
    XB = np.random.default_rng(13).standard_normal((bm.num_rows, 16))
    assert not dist.is_initialized()
    assert par.initialize_distributed(f"file://{tmp_path}/store", 1,
                                      0) is False
    try:
        assert dist.get_backend() == "nccl"
        mesh = par.global_mesh(4)
        virtual = par.make_mesh(4, devices=[mesh.device] * 4)
        out = {}
        for name, on in (("process", mesh), ("virtual", virtual)):
            W = par.shard_well(m, 4, dtype=f64, mesh=on)
            H = par.shard_well_halo(m, 4, dtype=f64, mesh=on)
            res = {"well": par.sharded_well_spmv(
                       W, par.stack_vector(x, W, on), on),
                   "well_halo": par.sharded_well_halo_spmv(
                       H, par.stack_vector(x, H, on), on),
                   "envelope": (W.chunks_per_shard, W.spill_per_shard)}
            for ex in ("neighbor", "all2all"):
                C = par.shard_wellcw_halo(m, 4, dtype=f64, mesh=on,
                                          exchange=ex)
                res[f"wellcw_{ex}"] = par.sharded_wellcw_halo_spmv(
                    C, par.stack_vector(x, C, on), on)
                res[f"wellcw_spmm_{ex}"] = par.sharded_wellcw_halo_spmm(
                    C, par.stack_block(X, C, on), on)
            for dt in (torch.float32, torch.bfloat16):
                B = par.shard_bsr_halo(bm, 4, dtype=dt, mesh=on)
                res[f"bsr_{dt}"] = par.sharded_bsr_spmm(
                    B, bsr_shard.stack_columns(XB, B, on), on)
            A = par.shard_csr_halo(spd, 4, dtype=f64, mesh=on)
            M = par.block_jacobi_ic0(spd, A.bounds, A.rows_per_shard,
                                     dtype=f64, mesh=on)
            res["ic0"] = par.sharded_block_ic0_apply(
                M, par.stack_vector(x[: spd.num_rows], A, on), on)
            res["ic0_envelope"] = (M.num_levels, M.width, M.max_deps,
                                   M.shift_used)
            out[name] = res
    finally:
        dist.destroy_process_group()
    for key, got in out["process"].items():
        want = out["virtual"][key]
        if isinstance(got, tuple):
            assert got == want, key
        else:
            assert torch.equal(got, want), key

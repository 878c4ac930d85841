"""Kernels K1, K2, K3a-c, K4a-c, K5a-b, K6a-b, K7 and the CSR kernels on
the card against their plain versions.

Marked ``cuda``: they skip where no CUDA device is present.  This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances (relative max-norm): float64 1e-12 and float32 1e-5 (the
kernel fuses multiply-add where the plain version rounds twice);
bfloat16 storage 1e-2 (both accumulate in float32 and round y once, so
they differ by at most one bfloat16 step); the fused dot 1e-10 in
float64 and 1e-4 in float32, relative to sum |x_i y_i| (the scale of
the rounding error of any summation order).  The WELL-CW, WELL, BSR and
CSR kernels (float64 and float32 only, and bfloat16 blocks for BSR) are
also launched twice on the same input, and the two outputs must be
bitwise equal; each column of an SpMM kernel's output is also held
against the SpMV kernel on that column.  BSR with bfloat16 blocks: both
the kernel and its plain version multiply the same bfloat16 values and
sum in float32, so they agree to 1e-5 of the output's scale.
"""

import functools

import numpy as np
import pytest
import torch

from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.io.generate import (
    banded_random,
    from_coo_arrays,
    poisson2d,
    random_sparse,
)
from spmv_tpu_torch.io.matrix_market import MatrixMarket
from spmv_tpu_torch.models import (
    BsrMatrix,
    CsrMatrix,
    DeviceBsr,
    DeviceCsr,
    DeviceDia,
    DeviceWell,
    DeviceWellCw,
    DiaMatrix,
    WellCwMatrix,
    WellMatrix,
)
from spmv_tpu_torch.ops import (
    bsr_spmm_core,
    bsr_spmm_reference,
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
    well_chunks_reference,
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
from spmv_tpu_torch.ops.well_kernels import _launch_spmm, well_column_block
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
    """k = 8 in float64 on a 128-group tail pool: 8 columns of its tile
    would need 256 KB of shared memory, more than a block has, so the
    kernel takes them one column block at a time."""
    A = DeviceWellCw.from_host(_wellcw_host("merged"), dtype=torch.float64,
                               device=cuda)
    tails = [p for p in A.tail_pools if p.out_rows == 128]
    assert tails, [p.out_rows for p in A.tail_pools]
    assert column_block("pool", torch.float64, 8, rows=128) < 8
    g = torch.Generator(device=cuda).manual_seed(5)
    X = torch.randn(A.num_columns, 8, generator=g, device=cuda,
                    dtype=torch.float64)
    for pool in tails:
        Y1 = wellcw_pool_spmm_core(pool, X, A.num_rows)
        Y2 = wellcw_pool_spmm_core(pool, X, A.num_rows)
        torch.cuda.synchronize()
        assert torch.equal(Y1, Y2)
        assert _rel_err(Y1, cw_pool_reference(pool, X, A.num_rows)) <= 1e-12


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
    assert _rel_err(y1, well_chunks_reference(A, x)) <= TOL[dtype]
    y = well_spmv_core(A, x)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched == [0 if segmented else 3, 3 if segmented else 0,
                        int(A.spill is not None)]
    assert _rel_err(y, well_spmv_reference(A, x)) <= TOL[dtype]
    want = torch.from_numpy(w.spmv(x.double().cpu().numpy()))
    assert _rel_err(y.cpu(), want) <= TOL[dtype]


def test_well_unvisited_blocks_read_zero(cuda):
    """An output block that no step visits is written with zeros (the
    Pallas kernels never write it): a NaN-filled out buffer comes back
    clean there.  The host packer gives every block a chunk, so the
    inert chunk of the empty block 1 is taken out by hand."""
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
    assert torch.equal(out, well_chunks_reference(A, x))
    assert not out.isnan().any()


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", list(WELL_CASES))
def test_well_spmm_kernels_match_plain(case, dtype, k, cuda):
    """K6a / K6b twice (bitwise equal), against the plain version and,
    column by column, against K5 on that column; the whole SpMM with its
    spill against the plain composition and the fp64 host product."""
    w = _well_host(case)
    A = DeviceWell.from_host(w, dtype=dtype, device=cuda,
                             **WELL_CASES[case][2])
    segmented = A.segment_of_step is not None
    core = well_seg_spmm_core if segmented else well_whole_spmm_core
    spmv_core = well_seg_core if segmented else well_whole_core
    g = torch.Generator(device=cuda).manual_seed(8)
    X = torch.randn(A.num_columns, k, generator=g, device=cuda, dtype=dtype)
    counters = (well_whole_spmm_core, well_seg_spmm_core, csr_spmm_core)
    before = [c.launches for c in counters]
    Y1, Y2 = core(A, X), core(A, X)
    torch.cuda.synchronize()
    assert Y1.shape == (A.num_rows, k)
    assert torch.equal(Y1, Y2)
    assert _rel_err(Y1, well_chunks_reference(A, X)) <= TOL[dtype]
    for j in range(k):
        assert _rel_err(Y1[:, j], spmv_core(A, X[:, j].contiguous())) \
            <= TOL[dtype], j
    Y = well_spmm_core(A, X)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    assert launched == [0 if segmented else 3, 3 if segmented else 0,
                        int(A.spill is not None)]
    assert _rel_err(Y, well_spmv_reference(A, X)) <= TOL[dtype]
    want = torch.from_numpy(np.stack(
        [w.spmv(X[:, j].double().cpu().numpy()) for j in range(k)], 1))
    assert _rel_err(Y.cpu(), want) <= TOL[dtype]


@pytest.mark.parametrize("columns", [1, 2, 5, 7])
def test_well_spmm_column_blocks_agree(columns, cuda):
    """Every column-block width gives the same Y, bit for bit (a column's
    sums do not depend on its block), in float64 on a segmented matrix
    with blocks_per_out 4, whose default width is 2 (7, the widest, is a
    224 KB tile); a width whose tile does not fit raises."""
    A = DeviceWell.from_host(_well_host("segmented_blocks_per_out_4"),
                             dtype=torch.float64, device=cuda,
                             **WELL_CASES["segmented_blocks_per_out_4"][2])
    assert well_column_block(torch.float64, 8, A.out_rows) == 2
    g = torch.Generator(device=cuda).manual_seed(9)
    X = torch.randn(A.num_columns, 8, generator=g, device=cuda,
                    dtype=torch.float64)
    Y = _launch_spmm(well_seg_spmm_core, "well_seg_spmm", A, X, None, True,
                     columns)
    torch.cuda.synchronize()
    assert torch.equal(Y, well_seg_spmm_core(A, X))
    with pytest.raises(KernelError, match="invalid argument"):
        _launch_spmm(well_seg_spmm_core, "well_seg_spmm", A, X, None, True, 8)


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


# name -> (host matrix, blocks_per_step)
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
}


@pytest.mark.parametrize("k", [1, 3, 40])
@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("case", list(BSR_CASES))
def test_bsr_kernel_matches_plain(case, dtype, k, cuda):
    """K7 twice (bitwise equal) against its plain version; float32 and
    float64 also against the fp64 host product; every column against K7
    on that column alone."""
    make, kb = BSR_CASES[case]
    b = make()
    A = DeviceBsr.from_host(b, dtype=dtype, blocks_per_step=kb, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(10)
    X = torch.randn(A.num_columns, k, generator=g, device=cuda).to(dtype)
    before = bsr_spmm_core.launches
    Y1, Y2 = bsr_spmm_core(A, X), bsr_spmm_core(A, X)
    torch.cuda.synchronize()
    assert bsr_spmm_core.launches == before + 2
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

"""The host side of the streaming WELL-CW kernels K3b and K3c
(``csrc/wellcw_spmv.cu``), on the CPU.

- ``cluster_size``, ``stream_plan`` and ``launch_plan``
  (``ops/wellcw_kernels.py``), the plan each launch takes from the shape
  alone, against their
  definitions, at the bench leg's shapes and at every pool shape the
  kernels took before they streamed; ``DeviceCwMerged.x_window``, the
  part of x each block reads, against its definition;
- the plain versions, which the kernels are held to on the card, on
  the synthetic containers of the card tests (blocks of 0, 1 and 5
  chunks, columns past the end beside an inf in x) against a dense
  numpy definition in float64 (rtol 1e-12: the sums differ only in
  order; tests/test_torch_wellcw.py holds them to the JAX package);
- the wrappers' refusals.
"""

import numpy as np
import pytest
import torch

from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.io.generate import banded_random
from spmv_tpu_torch.models import DeviceCwMerged, DeviceWellCw, WellCwMatrix
from spmv_tpu_torch.ops import (
    cw_merged_reference,
    cw_pool_reference,
    wellcw_merged_core,
    wellcw_pool_core,
)
from spmv_tpu_torch.ops.wellcw_kernels import (
    BARRIER_BYTES,
    CLUSTER_SIZES,
    MAX_STAGES,
    PAIR_BYTES,
    RING_BYTES,
    SMEM_MAX,
    WINDOW_BYTES,
    cluster_size,
    launch_plan,
    stream_plan,
)
from test_torch_cuda import (
    move_past_the_end,
    synthetic_merged,
    synthetic_pool,
)

H100_SMS = 132


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SPMV_TPU_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("units", [0, 1, 2, 32, 33, 34, 64, 65, 66, 100,
                                   128, 131, 132, 133, 1000])
@pytest.mark.parametrize("sms", [1, 66, H100_SMS])
def test_cluster_size_definition(units, sms):
    """The fewest CTAs a cluster, of those the host picks from, whose
    grid covers every SM, else the most."""
    c = cluster_size(units, sms)
    covering = [k for k in CLUSTER_SIZES if units * k >= sms]
    assert c == (covering[0] if covering else CLUSTER_SIZES[-1])


@pytest.mark.parametrize("units,want", [
    (128, 2),      # the bench leg's merged grid: 128 output blocks
    (64, 2),       # its 128-group tail pool: 64 blocks of 16 chunks
    (132, 1), (200, 1), (66, 2), (65, 2),
    (2, 2),        # a small CG matrix's merged grid
])
def test_cluster_size_on_h100(units, want):
    assert cluster_size(units, H100_SMS) == want


def _stage_bytes(lanes, itemsize, rowmap):
    return 8 * lanes * (itemsize + (8 if rowmap else 4))


def _total(rows, itemsize, rowmap, lanes, stages, window):
    """Shared memory a CTA of that plan takes, static included."""
    return (BARRIER_BYTES + rows * lanes * itemsize
            + stages * _stage_bytes(lanes, itemsize, rowmap)
            + window * itemsize)


@pytest.mark.parametrize("rowmap,window", [
    (False, 0), (False, 12288), (False, 1 << 20), (True, 0)],
    ids=["merged", "merged-window", "merged-wide", "pool"])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("rows", [1, 64, 128, 192, 384, 448, 512, 768])
def test_stream_plan_definition(rows, itemsize, rowmap, window):
    """The widest lane slice whose tile and two stages fit; within
    PAIR_BYTES where those fit it, the x window as wide as asked (up to
    WINDOW_BYTES), then as many stages as RING_BYTES asks, at most
    MAX_STAGES, as many as fit."""
    lanes, stages, win = stream_plan(rows, itemsize, rowmap, window)

    def total(ln, st, wn):
        return _total(rows, itemsize, rowmap, ln, st, wn)

    assert lanes in (128, 64, 32)
    assert all(total(wider, 2, 0) > SMEM_MAX for wider in (128, 64)
               if wider > lanes)
    budget = PAIR_BYTES if total(lanes, 2, 0) <= PAIR_BYTES else SMEM_MAX
    assert total(lanes, stages, win) <= budget
    assert 2 <= stages <= MAX_STAGES
    assert win % 4 == 0 and win <= window and win * itemsize <= WINDOW_BYTES
    assert (win == window // 4 * 4 or (win + 4) * itemsize > WINDOW_BYTES
            or total(lanes, 2, win + 4) > budget)
    stage = _stage_bytes(lanes, itemsize, rowmap)
    want = max(2, -(-RING_BYTES // stage))
    assert stages == min(MAX_STAGES, want) or total(lanes, stages + 1,
                                                    win) > budget
    assert stages <= want


def test_stream_plan_at_the_bench_leg():
    """banded_random(1M, 2048, 8) in float32: a K3c CTA stages 48 KB of x
    and streams 8 KB chunks four deep beside its 32 KB tile, two CTAs an
    SM; the 128-group tail's CTAs take whole lanes and hold all 4 of
    their chunks at once, two an SM."""
    assert stream_plan(64, 4, rowmap=False, window=16384) == (128, 4, 12288)
    assert stream_plan(128, 4, rowmap=True) == (128, 4, 0)
    assert _total(64, 4, False, 128, 4, 12288) <= PAIR_BYTES
    assert _total(128, 4, True, 128, 4, 0) <= PAIR_BYTES
    # at least 32 KB of stream in flight an SM, in both dtypes, with the
    # widest window
    for rows, rowmap in ((64, False), (64, True), (128, True)):
        for itemsize in (4, 8):
            plan = stream_plan(rows, itemsize, rowmap, window=1 << 20)
            ctas = 2 if _total(rows, itemsize, rowmap, *plan) <= PAIR_BYTES \
                else 1
            assert (ctas * plan[1] * _stage_bytes(plan[0], itemsize, rowmap)
                    >= 32 * 1024)


def test_launch_plan_at_the_bench_leg():
    """The whole plan of each launch, from the parts' shapes: 128 merged
    blocks with a 12,280-column x window and a 64-block, 128-group tail
    pool, float32, on 132 SMs."""
    mg = synthetic_merged(1, 2, 16, torch.float32, "cpu", 64 * 128)
    mg.num_blocks, mg.max_window = 128, 12280
    assert launch_plan(mg, 4, H100_SMS) == {
        "cluster": 2, "lanes": 128, "stages": 4, "x_window_columns": 12280}
    pool = synthetic_pool(128, (1,), torch.float32, "cpu", 128 * 128)
    pool.num_blocks = 64
    assert launch_plan(pool, 4, H100_SMS) == {
        "cluster": 2, "lanes": 128, "stages": 4, "x_window_columns": 0}
    # a pool of lane slices counts each slice as a cluster's unit
    wide = synthetic_pool(512, (1,), torch.float32, "cpu", 512 * 128)
    wide.num_blocks = 40
    assert launch_plan(wide, 4, H100_SMS)["lanes"] == 64
    assert launch_plan(wide, 4, H100_SMS)["cluster"] == 2
    wide.num_blocks = 66
    assert launch_plan(wide, 4, H100_SMS)["cluster"] == 1


@pytest.mark.parametrize("itemsize", [4, 8])
def test_stream_plan_takes_every_old_pool_shape(itemsize):
    """The one-warp pool kernel took out_rows x 32 lanes x itemsize <= 48
    KB; the streaming one takes all of those."""
    for rows in range(1, 48 * 1024 // (32 * itemsize) + 1):
        lanes, stages, _ = stream_plan(rows, itemsize, rowmap=True)
        assert lanes >= 32 and stages >= 2


@pytest.mark.parametrize("itemsize", [4, 8])
def test_stream_plan_refuses_a_tile_past_shared_memory(itemsize):
    rows = SMEM_MAX // (32 * itemsize)
    with pytest.raises(KernelError, match="shared memory"):
        stream_plan(rows, itemsize, rowmap=True)


@pytest.mark.parametrize("case", ["banded", "synthetic", "empty_block"])
def test_x_window_definition(case):
    """``DeviceCwMerged.x_window``: per block, the columns its cells of
    nonzero value read, lo rounded down to a multiple of 4."""
    if case == "banded":
        w = WellCwMatrix.from_matrix_market(
            banded_random(16384, 512, 6, seed=20))
        mg = DeviceWellCw.from_host(w, dtype=torch.float64,
                                    device="cpu").merged
    else:
        mg = synthetic_merged(3, 2, 3, torch.float64, "cpu", 3 * 64 * 128)
        if case == "empty_block":
            v = mg.value.numpy().copy()
            v[mg.kl:2 * mg.kl] = 0.0
            mg = DeviceCwMerged(mg.d, mg.kl, mg.cap, mg.lvl_per_block,
                                mg.pool_per_block, mg.num_blocks, 0, v,
                                mg.local_index.numpy(), mg.anchor4.numpy(),
                                torch.float64, "cpu")
    loc = mg.local_index.numpy().astype(np.int64)
    a4 = mg.anchor4.numpy().reshape(-1, 1, 1).astype(np.int64)
    col = (a4 * mg.d + ((loc >> 7) & (8 * mg.d - 1))) * 128 + (loc & 127)
    nz = mg.value.numpy() != 0
    win = mg.x_window.numpy()
    assert win.shape == (mg.num_blocks, 2) and win.dtype == np.int32
    for b in range(mg.num_blocks):
        cols = col[b * mg.kl:(b + 1) * mg.kl][nz[b * mg.kl:(b + 1) * mg.kl]]
        if cols.size == 0:
            assert list(win[b]) == [0, 0]
        else:
            assert win[b, 0] == cols.min() // 4 * 4
            assert win[b, 1] == cols.max() + 1
    assert mg.max_window == int((win[:, 1] - win[:, 0]).max())
    if case == "banded":
        # a banded block's window is about its rows plus the band
        assert mg.max_window <= 64 * 128 + 2 * 512 + 4


def _dense_products(part, x, merged):
    """(cells, products) of a pool or merged grid in numpy: value times
    x at the cell's column, 0 past the end."""
    loc = part.local_index.numpy().astype(np.int64)
    w = loc >> 7
    if merged:
        w &= 8 * part.d - 1
    a4 = part.anchor4.numpy().reshape(-1, 1, 1).astype(np.int64)
    col = (a4 * part.d + w) * 128 + (loc & 127)
    xz = np.append(x, 0.0)
    return loc, part.value.numpy() * xz[np.minimum(col, x.size)]


def _dense_pool(pool, x, n):
    _, prod = _dense_products(pool, x, merged=False)
    rows = pool.rowmap.numpy().astype(np.int64) * 128 + np.arange(128)
    keep = rows < n
    y = np.zeros(n)
    np.add.at(y, rows[keep], prod[keep])
    return y


def _dense_merged(mg, x, n):
    loc, prod = _dense_products(mg, x, merged=True)
    kk = np.arange(loc.shape[0]) % mg.kl
    block = np.arange(loc.shape[0]) // mg.kl
    level = (kk < mg.lvl_per_block)[:, None, None]
    group = np.where(level, (block * 64 + kk // mg.cap)[:, None, None],
                     block[:, None, None] * 64 + (loc >> 14))
    rows = group * 128 + np.arange(128)
    y = np.zeros(mg.num_blocks * 64 * 128)
    np.add.at(y, rows.reshape(-1), prod.reshape(-1))
    return y[:n]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("counts", [(1, 0, 5, 2), (0, 3), (4,), (0, 0, 1)])
def test_synthetic_pool_plain_matches_dense(counts):
    """The card tests' pools: blocks of 0, 1 and more chunks than a
    cluster has CTAs, rows ending inside a group."""
    m = len(counts) * 64 * 128 - 3
    pool = synthetic_pool(64, counts, torch.float64, "cpu", m)
    assert pool.num_blocks == len(counts)
    ptr = pool.block_ptr.numpy()
    assert list(np.diff(ptr)) == list(counts)
    x = np.random.default_rng(1).standard_normal(m)
    n = m - 67
    got = wellcw_pool_core(pool, torch.from_numpy(x), n).numpy()
    assert _rel(got, _dense_pool(pool, x, n)) <= 1e-12
    for b, c in enumerate(counts):
        if c == 0:
            assert not got[b * 64 * 128:(b + 1) * 64 * 128].any()


@pytest.mark.parametrize("cap,pool_per_block", [(1, 0), (2, 3), (3, 16)])
def test_synthetic_merged_plain_matches_dense(cap, pool_per_block):
    m = 3 * 64 * 128 - 3
    mg = synthetic_merged(3, cap, pool_per_block, torch.float64, "cpu", m)
    x = np.random.default_rng(2).standard_normal(m)
    got = wellcw_merged_core(mg, torch.from_numpy(x), m).numpy()
    assert _rel(got, _dense_merged(mg, x, m)) <= 1e-12


@pytest.mark.parametrize("kind", ["merged", "pool"])
def test_past_the_end_reads_zero_beside_inf(kind):
    """The card test's input: cells moved off x's last column land on the
    first column past the end, which reads 0; x's last entry is inf."""
    m = 3 * 64 * 128 - 3
    if kind == "merged":
        part = synthetic_merged(3, 2, 3, torch.float64, "cpu", m)
        plain = cw_merged_reference
    else:
        part = synthetic_pool(64, (2, 4, 3), torch.float64, "cpu", m)
        plain = cw_pool_reference
    move_past_the_end(part, m, merged=kind == "merged")
    loc, _ = _dense_products(part, np.zeros(m), merged=kind == "merged")
    w = loc >> 7
    if kind == "merged":
        w &= 8 * part.d - 1
    a4 = part.anchor4.numpy().reshape(-1, 1, 1).astype(np.int64)
    col = (a4 * part.d + w) * 128 + (loc & 127)
    assert not (col == m - 1).any() and (col == m).any()
    x = np.random.default_rng(3).standard_normal(m)
    x[m - 1] = np.inf
    got = plain(part, torch.from_numpy(x), m).numpy()
    assert np.isfinite(got).all()
    dense = (_dense_merged if kind == "merged" else _dense_pool)(part, x, m)
    assert _rel(got, dense) <= 1e-12


def test_merged_wrapper_refuses_a_grid_of_the_wrong_length():
    mg = synthetic_merged(1, 1, 2, torch.float64, "cpu", 64 * 128)
    mg.pool_per_block = 3
    with pytest.raises(KernelError, match="kl"):
        wellcw_merged_core(mg, torch.zeros(64 * 128, dtype=torch.float64),
                           64 * 128)


def test_pool_wrapper_refuses_accumulate_without_out():
    pool = synthetic_pool(64, (1,), torch.float64, "cpu", 64 * 128)
    with pytest.raises(KernelError, match="accumulate"):
        wellcw_pool_core(pool, torch.zeros(64 * 128, dtype=torch.float64),
                         64 * 128, accumulate=True)

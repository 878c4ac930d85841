"""The host side of K3a's, K4a's and K4c's Hopper designs
(``csrc/wellcw_spmv.cu``, ``csrc/wellcw_spmm.cu``), on the CPU.

- ``DeviceCwLevel.local_index16``, the int16 copy K3a reads, against
  ``local_index`` on every fallback-layout matrix of the WELL-CW tests
  (from the port's packer and from the JAX container), and the widths
  ``level_index_bits`` gives;
- ``DeviceCwMerged``'s pool list (``merged_pool_list``), one run of
  pool cells a row, against its definition on the card tests' synthetic
  merged grids (cap 1-3, 0, 1 and 16 pool chunks a block): pointers
  monotone, each row's cells in storage order, rows outside [0, 64)
  dropped;
- a numpy walk of the merged grid in K4a's order (each row's level
  chunks, then its pool run) against ``cw_merged_reference`` in float64
  at rtol 1e-12 (the sums differ only in rounding order;
  tests/test_torch_wellcw_spmm.py holds that reference to JAX's
  ``_cw_merged_spmm_kernel`` in interpret mode);
- ``DeviceCwPool``'s row list (``pool_row_list``), one run of cells a
  Y row, against its definition on synthetic pools (64- and 128-row
  blocks, empty blocks, cells whose group lies off their block) and on
  the packed pools of the WELL-CW tests (a fallback layout's 64-row
  stage-1 pool and 128-row tail, a merged layout's tails);
- a numpy walk of that list in K4c's order against
  ``cw_pool_reference`` in float64 at rtol 1e-12 and, on a packed
  fallback matrix's stage-1 pool and 128-row tail, against JAX's
  ``_cw_pool_spmm_kernel`` in Pallas interpret mode;
- the wrappers' path choices as pure functions: ``x_vector_loads``,
  ``spmm_plan`` and ``column_block``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.io import generate as jgenerate
from spmv_tpu.models import WellCwMatrix as JaxWellCwMatrix
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import pallas_kernels as jpk
from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.io.generate import banded_random, random_sparse
from spmv_tpu_torch.models import (
    DeviceCwLevel,
    DeviceCwMerged,
    DeviceCwPool,
    DeviceWellCw,
    WellCwMatrix,
    wellcw_from_spmv_tpu,
)
from spmv_tpu_torch.models.device import (
    level_index_bits,
    merged_pool_list,
    pool_row_list,
)
from spmv_tpu_torch.ops import (
    cw_merged_reference,
    cw_pool_reference,
    wellcw_merged_spmm_core,
)
from spmv_tpu_torch.ops.wellcw_kernels import (
    column_block,
    spmm_plan,
    x_vector_loads,
)
from test_torch_cuda import synthetic_merged, synthetic_pool

# the fallback-layout matrices of tests/test_torch_wellcw.py (CASES):
# name -> (matrix, host packing options, device options)
FALLBACK = {
    "forced_fallback": (lambda g: g.banded_random(16384, 512, 6, seed=20),
                        {}, {"chunks_per_step": 32}),
    "banded_random": (lambda g: g.banded_random(1500, 400, 8, seed=2), {},
                      {}),
    "banded_4096": (lambda g: g.banded_random(4096, 128, 8, seed=1), {}, {}),
    "remainder": (lambda g: g.random_sparse(256, 256, 12, seed=7),
                  {"levels": [(2, 1, 0.0)], "pool_cap": 0}, {}),
    "scattered": (lambda g: g.random_sparse(700, 700, 10, seed=1), {}, {}),
    "rect_wide": (lambda g: g.random_sparse(300, 1100, 6, seed=3), {}, {}),
    "rect_tall": (lambda g: g.random_sparse(1100, 300, 5, seed=4), {}, {}),
}


class _Port:
    banded_random = staticmethod(banded_random)
    random_sparse = staticmethod(random_sparse)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SPMV_TPU_TORCH_DEVICE", "cpu")


@functools.lru_cache(maxsize=None)
def _host(name):
    make, host_kw, _ = FALLBACK[name]
    return WellCwMatrix.from_matrix_market(make(_Port), **host_kw)


@pytest.mark.parametrize("d,bits", [(1, 16), (2, 16), (4, 16), (16, 16),
                                    (32, 16), (33, 32), (64, 32),
                                    (128, 32)])
def test_level_index_bits_table(d, bits):
    """int16 holds w * 128 + lane < 1024 d exactly while 1024 d <= 2^15."""
    assert level_index_bits(d) == bits
    assert (1024 * d - 1 <= np.iinfo(np.int16).max) == (bits == 16)


@pytest.mark.parametrize("name", list(FALLBACK))
def test_local_index16_equals_local_index(name):
    A = DeviceWellCw.from_host(_host(name), dtype=torch.float64,
                               device="cpu", **FALLBACK[name][2])
    assert A.merged is None and A.levels
    for lvl in A.levels:
        assert level_index_bits(lvl.d) == 16
        assert lvl.local_index16.dtype == torch.int16
        assert lvl.local_index16.is_contiguous()
        assert torch.equal(lvl.local_index16.long(), lvl.local_index.long())


@pytest.mark.parametrize("name", ["forced_fallback", "banded_4096",
                                  "remainder"])
def test_local_index16_from_the_jax_container(name):
    make, host_kw, dev_kw = FALLBACK[name]
    from spmv_tpu.io import generate as jgen

    Aj = jdev.DeviceWellCw.from_host(
        JaxWellCwMatrix.from_matrix_market(make(jgen), **host_kw),
        dtype=jnp.float64, **dev_kw)
    At = wellcw_from_spmv_tpu(Aj)
    assert At.levels
    for lvl, lj in zip(At.levels, Aj.levels):
        np.testing.assert_array_equal(lvl.local_index16.numpy(),
                                      np.asarray(lj.local_index))


def _synthetic_level(d, loc_max, seed=0):
    rng = np.random.default_rng(seed)
    chunks = 4
    return DeviceCwLevel(
        d, 1, 0, rng.standard_normal((chunks, 8, 128)),
        rng.integers(0, loc_max, size=(chunks, 8, 128)),
        np.zeros((chunks, 1, 1)), np.arange(chunks).reshape(chunks, 1, 1),
        np.zeros(chunks), chunks, torch.float64, "cpu")


def test_local_index16_is_none_at_d64():
    lvl = _synthetic_level(64, 1024 * 64)
    assert lvl.local_index16 is None
    assert int(lvl.local_index.max()) > np.iinfo(np.int16).max


def test_local_index16_refuses_an_index_past_int16():
    with pytest.raises(MatrixError, match="int16"):
        _synthetic_level(2, 1 << 16)


def _pool_cells(mg):
    """(block, lane, tile row, column, value) of every pool cell of a
    merged grid, in storage order (block, chunk, slot, lane), by a plain
    loop over the chunks."""
    S, kl, lvl = mg.num_blocks, mg.kl, mg.lvl_per_block
    value = mg.value.reshape(S, kl, 8, 128).numpy()
    loc = mg.local_index.reshape(S, kl, 8, 128).numpy().astype(np.int64)
    a4 = mg.anchor4.reshape(S, kl).numpy().astype(np.int64)
    cells = []
    for b in range(S):
        for q in range(lvl, kl):
            for s in range(8):
                li = loc[b, q, s]
                col = ((a4[b, q] * mg.d + ((li >> 7) & (8 * mg.d - 1)))
                       * 128 + (li & 127))
                for lane in range(128):
                    cells.append((b, lane, int(li[lane] >> 14),
                                  int(col[lane]), value[b, q, s, lane]))
    return cells


def _with_rows_off_the_tile(mg, seed):
    """A copy of a synthetic merged grid with some pool cells' tile rows
    moved to 64 .. 127 (past the block's 64 groups)."""
    S, kl, lvl = mg.num_blocks, mg.kl, mg.lvl_per_block
    loc = mg.local_index.reshape(S, kl, 8, 128).numpy().copy()
    rng = np.random.default_rng(seed)
    off = rng.random(loc[:, lvl:].shape) < 0.05
    loc[:, lvl:] = np.where(off, (loc[:, lvl:] & ((1 << 14) - 1))
                            | ((64 + rng.integers(0, 64, off.shape)) << 14),
                            loc[:, lvl:])
    return DeviceCwMerged(
        mg.d, kl, mg.cap, lvl, mg.pool_per_block, S, 0, mg.value.numpy(),
        loc.reshape(-1, 8, 128), mg.anchor4.numpy(), torch.float64, "cpu")


@pytest.mark.parametrize("pool_per_block", [0, 1, 16])
@pytest.mark.parametrize("cap", [1, 2, 3])
def test_pool_list_matches_its_definition(cap, pool_per_block):
    m = 3 * 64 * 128 - 3
    mg = synthetic_merged(3, cap, pool_per_block, torch.float64, "cpu", m,
                          seed=cap)
    if pool_per_block:
        mg = _with_rows_off_the_tile(mg, seed=cap)
    got = merged_pool_list(mg.value.numpy(), mg.local_index.numpy(),
                           mg.anchor4.numpy(), mg.d, mg.kl,
                           mg.lvl_per_block, mg.num_blocks)
    if pool_per_block == 0:
        assert got is None and mg.pool_ptr is None
        assert mg.pool_col is None and mg.pool_value is None
        return
    ptr, col, val = got
    assert torch.equal(mg.pool_ptr, torch.from_numpy(ptr))
    assert torch.equal(mg.pool_col, torch.from_numpy(col))
    assert torch.equal(mg.pool_value, torch.from_numpy(val))
    runs = mg.num_blocks * 128 * 64
    assert ptr.dtype == np.int32 and col.dtype == np.int32
    assert ptr.shape == (runs + 1,) and ptr[0] == 0
    assert (np.diff(ptr) >= 0).all() and ptr[-1] == col.size == val.size
    want = {}
    dropped = 0
    for b, lane, r, c, v in _pool_cells(mg):
        if not 0 <= r < 64:
            dropped += 1
            continue
        want.setdefault((b * 128 + lane) * 64 + r, []).append((c, v))
    assert dropped > 0
    assert col.size == mg.num_blocks * pool_per_block * 1024 - dropped
    for key in range(runs):
        cells = want.get(key, [])
        lo, hi = ptr[key], ptr[key + 1]
        assert hi - lo == len(cells), key
        if cells:
            assert list(col[lo:hi]) == [c for c, _ in cells], key
            assert list(val[lo:hi]) == [v for _, v in cells], key


def _walk(mg, X, num_rows):
    """Y of a merged grid in K4a's order: each row sums its level chunks
    (a strip of 8 slots a chunk, in slot order, then the strips in chunk
    order), then its pool run in list order, and adds the two; a column
    past the end reads 0.  X is (m, k), float64."""
    S, kl, cap, lvl = mg.num_blocks, mg.kl, mg.cap, mg.lvl_per_block
    m, k = X.shape
    Xz = np.vstack([X, np.zeros((1, k))])
    value = mg.value.reshape(S, kl, 8, 128).numpy()
    loc = mg.local_index.reshape(S, kl, 8, 128).numpy().astype(np.int64)
    a4 = mg.anchor4.reshape(S, kl).numpy().astype(np.int64)
    acc = np.zeros((S, 64, 128, k))
    for q in range(cap):
        kk = np.arange(64) * cap + q                     # (64,) chunk
        strip = np.zeros((S, 64, 128, k))
        for s in range(8):
            li = loc[:, kk, s]                           # (S, 64, 128)
            col = ((a4[:, kk, None] * mg.d + ((li >> 7) & (8 * mg.d - 1)))
                   * 128 + (li & 127))
            strip += value[:, kk, s, :, None] * Xz[np.minimum(col, m)]
        acc += strip
    y = acc
    if mg.pool_ptr is not None:
        ptr = mg.pool_ptr.numpy().astype(np.int64)
        pc = mg.pool_col.numpy().astype(np.int64)
        pv = mg.pool_value.numpy()
        b = np.arange(S)[:, None, None]
        r = np.arange(64)[None, :, None]
        lane = np.arange(128)[None, None, :]
        i = (b * 128 + lane) * 64 + r
        lo, n = ptr[i], ptr[i + 1] - ptr[i]              # (S, 64, 128)
        pool = np.zeros((S, 64, 128, k))
        for t in range(int(n.max(initial=0))):
            live = t < n
            e = np.where(live, lo + t, 0)
            term = pv[e][..., None] * Xz[np.minimum(pc[e], m)]
            pool += np.where(live[..., None], term, 0.0)
        y = acc + pool
    return y.reshape(-1, k)[:num_rows]


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("pool_per_block", [0, 1, 16])
@pytest.mark.parametrize("cap", [1, 2, 3])
def test_walk_in_kernel_order_matches_reference(cap, pool_per_block, k):
    m = 3 * 64 * 128 - 3
    mg = synthetic_merged(3, cap, pool_per_block, torch.float64, "cpu", m,
                          seed=10 + cap)
    X = np.random.default_rng(cap + k).standard_normal((m, k))
    n = m - 70
    want = cw_merged_reference(mg, torch.from_numpy(X), n).numpy()
    np.testing.assert_allclose(_walk(mg, X, n), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


def test_walk_matches_reference_on_a_packed_merged_grid():
    """The merged case of the WELL-CW tests: banded_random(16384, 512, 6),
    two blocks of cap 2 and 16 pool chunks (padding cells of value 0
    included in the list)."""
    A = DeviceWellCw.from_host(WellCwMatrix.from_matrix_market(
        banded_random(16384, 512, 6, seed=20)), dtype=torch.float64,
        device="cpu")
    mg = A.merged
    assert mg.pool_per_block == 16
    assert mg.pool_col.numel() == mg.num_blocks * 16 * 1024
    X = np.random.default_rng(5).standard_normal((A.num_columns, 2))
    want = wellcw_merged_spmm_core(mg, torch.from_numpy(X),
                                   A.num_rows).numpy()
    np.testing.assert_allclose(_walk(mg, X, A.num_rows), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(
        mg.level_index16.reshape(mg.num_blocks, 64 * mg.cap, 8, 128).long(),
        mg.local_index.reshape(mg.num_blocks, mg.kl, 8, 128)[
            :, :64 * mg.cap].long())


@pytest.mark.parametrize("k,kb,itemsize,ptrs,want", [
    (8, 8, 4, (0, 16), True),        # the bench leg: two loads a cell
    (4, 4, 4, (32, 64), True),
    (16, 8, 4, (0, 0), True),        # column blocks at 0 and 8
    (12, 8, 4, (0, 0), True),        # a block at 8, 4 columns: one load
    (10, 8, 4, (0, 0), False),       # rows of 40 bytes
    (8, 8, 4, (4, 0), False),        # X one float off: a column slice
    (8, 8, 4, (0, 8), False),        # Y off
    (3, 3, 4, (0, 0), False),
    (9, 8, 4, (0, 0), False),
    (17, 8, 4, (0, 0), False),
    (1, 1, 4, (0, 0), False),
    (2, 2, 8, (0, 0), True),         # float64: 16 bytes are two values
    (8, 8, 8, (16, 48), True),
    (3, 3, 8, (0, 0), False),
    (8, 8, 8, (8, 0), False),
])
def test_x_vector_loads_table(k, kb, itemsize, ptrs, want):
    assert x_vector_loads(k, kb, itemsize, *ptrs) is want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("k", [1, 3, 8, 9, 17, 128])
def test_merged_column_block_is_register_bound(k, dtype):
    """K4a keeps no shared tile, nor, since K4c's redesign, does any
    WELL-CW SpMM kernel: the column block is a thread's, min(k, 8), in
    both dtypes."""
    assert column_block(k) == min(k, 8)
    assert spmm_plan(k, dtype, 0, 0)["kb"] == column_block(k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("k", [1, 3, 4, 8, 9, 16, 17])
def test_merged_spmm_plan(k, dtype):
    """K4a's (and K4c's) path from the shape and the pointers: min(k, 8)
    columns a block, 16-byte loads where rows and blocks are whole
    16-byte runs and X and Y are aligned."""
    itemsize = dtype.itemsize
    kb = min(k, 8)
    vec = (k * itemsize) % 16 == 0 and (kb * itemsize) % 16 == 0
    assert spmm_plan(k, dtype, 0, 16) == {"kb": kb, "vector_x": vec}
    assert not spmm_plan(k, dtype, itemsize, 16)["vector_x"]
    assert not spmm_plan(k, dtype, 0, 8)["vector_x"]


# ------------------------------------------------------- K4c's row list

class _JaxGen:
    banded_random = staticmethod(jgenerate.banded_random)
    random_sparse = staticmethod(jgenerate.random_sparse)


def _off_the_block(pool, seed):
    """A copy of a pool (float64, CPU) with some cells' groups moved
    anywhere in [0, (num_blocks + 1) * out_rows): onto another block or
    past every block."""
    shape = tuple(pool.rowmap.shape)
    rng = np.random.default_rng(seed)
    off = rng.random(shape) < 0.05
    rowmap = np.where(off, rng.integers(
        0, (pool.num_blocks + 1) * pool.out_rows, shape),
        pool.rowmap.numpy())
    return DeviceCwPool(
        pool.d, pool.chunks_per_step, pool.xr4, pool.value.numpy(),
        pool.local_index.numpy(), pool.anchor4.numpy(), rowmap,
        pool.block_of_step.numpy(), pool.num_blocks * pool.out_rows,
        torch.float64, "cpu", out_rows=pool.out_rows)


@functools.lru_cache(maxsize=None)
def _packed(name):
    """(port, JAX) WELL-CW containers in float64 of a case of the WELL-CW
    tests: fallback "banded_random" (a 64-row stage-1 pool and a 128-row
    tail) or "merged" (banded_random(16384, 512, 6): tails of 128 and 64
    rows)."""
    make = {"banded_random": lambda g: g.banded_random(1500, 400, 8,
                                                        seed=2),
            "merged": lambda g: g.banded_random(16384, 512, 6, seed=20)}
    port = DeviceWellCw.from_host(WellCwMatrix.from_matrix_market(
        make[name](_Port)), dtype=torch.float64, device="cpu")
    jax = jdev.DeviceWellCw.from_host(JaxWellCwMatrix.from_matrix_market(
        make[name](_JaxGen)), dtype=jnp.float64)
    return port, jax


def _pools(A):
    return ([A.pool] if A.pool is not None else []) + list(A.tail_pools)


POOLS = ["synthetic64", "synthetic128", "banded_random", "merged"]


def _pool_case(name):
    """(pools, num_rows, num_columns) of a POOLS case."""
    if name.startswith("synthetic"):
        rows = int(name[len("synthetic"):])
        m = 3 * rows * 128 - 5
        pool = synthetic_pool(rows, (2, 0, 5), torch.float64, "cpu", m,
                              seed=rows)
        return [pool, _off_the_block(pool, seed=rows)], m - 40, m
    A = _packed(name)[0]
    return _pools(A), A.num_rows, A.num_columns


def _pool_cells_by_row(pool):
    """{Y row: [(column, value), ...]} of the cells each output block of
    a pool owns (group in the block's out_rows groups), in storage order
    (chunk, slot), by a plain loop over the blocks' chunks."""
    ptr = pool.block_ptr.numpy()
    value = pool.value.numpy()
    loc = pool.local_index.numpy().astype(np.int64)
    a4 = pool.anchor4.numpy().reshape(-1).astype(np.int64)
    rowmap = pool.rowmap.numpy().astype(np.int64)
    cells, dropped = {}, 0
    for b in range(pool.num_blocks):
        for c in range(ptr[b], ptr[b + 1]):
            for s in range(8):
                col = (a4[c] * pool.d + (loc[c, s] >> 7)) * 128 \
                    + (loc[c, s] & 127)
                for lane in range(128):
                    g = rowmap[c, s, lane]
                    if not b * pool.out_rows <= g < (b + 1) * pool.out_rows:
                        dropped += 1
                        continue
                    cells.setdefault(g * 128 + lane, []).append(
                        (int(col[lane]), value[c, s, lane]))
    return cells, dropped


def _runs(pool):
    """{Y row: (columns, values)} of a pool's row list, read from its
    buffers as K4c reads them: row t's cell i at list_slice[t // 32] + 32
    i + t % 32."""
    rows, n, start, col, val = (getattr(pool, f"list_{b}").numpy() for b in
                                ("rows", "len", "slice", "col", "value"))
    at = [start[t // 32] + 32 * np.arange(n[t]) + t % 32
          for t in range(rows.size)]
    return {int(r): (col[a], val[a]) for r, a in zip(rows, at)}


@pytest.mark.parametrize("name", POOLS)
def test_pool_row_list_matches_its_definition(name):
    pools, _, _ = _pool_case(name)
    for pool in pools:
        rows, ptr, col, val = pool_row_list(
            pool.value.numpy(), pool.local_index.numpy(),
            pool.anchor4.numpy(), pool.rowmap.numpy(), pool.d,
            pool.out_rows, pool.block_ptr.numpy())
        assert rows.dtype == ptr.dtype == col.dtype == np.int32
        assert ptr.shape == (rows.size + 1,) and ptr[0] == 0
        assert (np.diff(rows) > 0).all() and (np.diff(ptr) > 0).all()
        assert ptr[-1] == col.size == val.size
        want, dropped = _pool_cells_by_row(pool)
        assert sorted(want) == rows.tolist()
        assert col.size == pool.num_chunks * 1024 - dropped
        runs = _runs(pool)
        assert sorted(runs) == rows.tolist()
        for t, row in enumerate(rows.tolist()):
            lo, hi = ptr[t], ptr[t + 1]
            assert list(col[lo:hi]) == [c for c, _ in want[row]], row
            assert list(val[lo:hi]) == [v for _, v in want[row]], row
            assert list(runs[row][0]) == list(col[lo:hi]), row
            assert list(runs[row][1]) == list(val[lo:hi]), row
    if name.startswith("synthetic"):
        assert _pool_cells_by_row(pools[1])[1] > 0       # some dropped
    else:
        assert any(0.0 in p.list_value for p in pools)   # padding kept


@pytest.mark.parametrize("name", POOLS)
def test_sliced_row_list_layout(name):
    """Rows longest run first (ties by row), slices of 32 rows as wide as
    their longest run, the places past a shorter run column -1."""
    for pool in _pool_case(name)[0]:
        rows, n, start, col = (getattr(pool, f"list_{b}").numpy() for b in
                               ("rows", "len", "slice", "col"))
        assert n.dtype == start.dtype == np.int32
        key = list(zip(-n.astype(np.int64), rows))
        assert key == sorted(key)
        slices = -(-rows.size // 32)
        assert start.shape == (slices + 1,) and start[0] == 0
        width = np.diff(start) // 32
        assert (np.diff(start) % 32 == 0).all() and start[-1] == col.size
        for k in range(slices):
            assert width[k] == n[32 * k:32 * k + 32].max()
        used = np.zeros(col.size, bool)
        for t in range(rows.size):
            used[start[t // 32] + 32 * np.arange(n[t]) + t % 32] = True
        assert int(used.sum()) == int(n.sum())
        assert (col[~used] == -1).all()
        assert (pool.list_value.numpy()[~used] == 0).all()


def _pool_walk(pool, X, num_rows):
    """Y of a pool in K4c's order: each listed row below num_rows sums its
    run in list order (a column past the end reads 0); every other row
    is 0.  X is (m, k), float64."""
    m, k = X.shape
    Xz = np.vstack([X, np.zeros((1, k))])
    Y = np.zeros((num_rows, k))
    for row, (col, val) in _runs(pool).items():
        if row < num_rows:
            acc = np.zeros(k)
            for c, v in zip(col, val):
                acc = acc + v * Xz[min(c, m)]
            Y[row] = acc
    return Y


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", POOLS)
def test_pool_walk_in_kernel_order_matches_reference(name, k):
    """Every cell of these pools lies in its block (the plain version
    scatters a cell by its group alone; the kernels drop one off its
    block, which no packer writes)."""
    pools, n, m = _pool_case(name)
    X = np.random.default_rng(k).standard_normal((m, k))
    for pool in pools[:1] if name.startswith("synthetic") else pools:
        want = cw_pool_reference(pool, torch.from_numpy(X), n).numpy()
        np.testing.assert_allclose(_pool_walk(pool, X, n), want,
                                   rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


def test_pool_walk_matches_pallas_interpret():
    """The fallback layout's 64-row stage-1 pool and its 128-row tail on
    banded_random(1500, 400, 8): the walk against JAX's pool SpMM kernel
    in Pallas interpret mode, as JAX's wellcw_spmm runs each pool."""
    At, Aj = _packed("banded_random")
    assert [p.out_rows for p in _pools(At)] == [64, 128]
    X = np.random.default_rng(9).standard_normal((At.num_columns, 2))
    XT = jnp.asarray(X).T
    groups = {64: jpk.round_up(Aj.num_groups, 8 * Aj.blocks_per_out),
              128: jpk.round_up(Aj.num_groups, 128)}
    for pt, pj in zip(_pools(At), [Aj.pool] + list(Aj.tail_pools)):
        y3d = jpk._cw_pool_spmm_call(pj, jpk._cw_tables3(pj, XT, 2),
                                     groups[pt.out_rows], pt.out_rows, 2,
                                     True)
        want = np.asarray(y3d).transpose(0, 2, 1).reshape(-1, 2)[
            :At.num_rows]
        np.testing.assert_allclose(_pool_walk(pt, X, At.num_rows), want,
                                   rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())

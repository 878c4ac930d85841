"""K6's reading of a WELL container for the SpMM, on the CPU.

- A numpy walk of the chunks in K6's order (per output block: each
  chunk's live slots in slot order, the chunks in storage order, then
  each lane's spill entries from the lane-ordered copy, in order) equals
  K6's plain version (``well_spmv_reference`` on 2-D X, which the K6
  wrappers run for CPU tensors) and JAX's ``well_spmm`` in Pallas
  interpret mode (one run at k = 17 a matrix, whose first k columns
  stand for X[:, :k]) and through XLA, at rtol 1e-12 in float64 for
  finite X (the sums differ only in rounding order): whole x and
  segmented, with and without a spill, at k = 1, 3, 4, 8, 9 and 17 (one
  and more column blocks of 8).
- The stated deviation: an inf in X under an all-zero slot gives NaN in
  the JAX kernels (0 * inf) and a finite product in the port, column by
  column.
- K6's path as a pure function: ``well_spmm_plan`` (the column blocks,
  16-byte or scalar X loads).

The inputs are made with numpy from fixed seeds and handed to both
packages.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.io import generate as jgen
from spmv_tpu.io.matrix_market import MatrixMarket as JaxMatrixMarket
from spmv_tpu.models import WellMatrix as JaxWellMatrix
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import spmm as jspmm
from spmv_tpu.ops.pallas_kernels import well_spmm as jwell_spmm
from spmv_tpu_torch.io import generate as pgen
from spmv_tpu_torch.io.matrix_market import MatrixMarket
from spmv_tpu_torch.kernels import make_kernel
from spmv_tpu_torch.models import DeviceWell, WellMatrix
from spmv_tpu_torch.ops import (
    csr_spmm_core,
    well_seg_spmm_core,
    well_spmm_core,
    well_spmv_reference,
    well_whole_spmm_core,
)
from spmv_tpu_torch.ops.well_kernels import well_spmm_plan

LANE = 128
KS = (1, 3, 4, 8, 9, 17)


def _gen(fn, *args, **kw):
    def make(mod):
        return getattr(pgen if mod is MatrixMarket else jgen, fn)(
            *args, **kw)
    return make


def _two_clusters(mod):
    # tests/test_well.py:192-199: a near and a far diagonal in one group;
    # with segment_rows=2 the far slot spills
    r = np.concatenate([np.arange(128)] * 2)
    c = np.concatenate([np.arange(128), np.arange(128) + 3000])
    return mod("matrix", "coordinate", "real", "general", 128, 4000,
               r.size, r + 1, c + 1,
               np.random.default_rng(3).standard_normal(r.size))


# name -> (matrix maker (given the MatrixMarket class), window_rows,
#          device options)
CASES = {
    "whole": (_gen("poisson2d", 30, 40), 2, {}),
    "whole_spill": (_gen("random_sparse", 300, 300, 6, seed=4), 1, {}),
    "segmented": (_gen("poisson2d", 40, 40), 2,
                  {"segment_rows": 8, "blocks_per_out": 4}),
    "segmented_spill": (_two_clusters, 1, {"segment_rows": 2}),
}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    # the port's entry points run on the card unless asked for the CPU
    monkeypatch.setenv("SPMV_TPU_TORCH_DEVICE", "cpu")


@functools.lru_cache(maxsize=None)
def _both(name):
    make, window_rows, dev_kw = CASES[name]
    w = WellMatrix.from_matrix_market(make(MatrixMarket),
                                      window_rows=window_rows)
    wj = JaxWellMatrix.from_matrix_market(make(JaxMatrixMarket),
                                          window_rows=window_rows)
    Aj = jdev.DeviceWell.from_host(wj, dtype=jnp.float64, **dev_kw)
    At = DeviceWell.from_host(w, dtype=torch.float64, device="cpu",
                              **dev_kw)
    return w, Aj, At


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _k6_walk(A, X):
    """Y = A @ X summed in K6's order, from the container's arrays: each
    output block's chunks in storage order, a chunk's live slots (its
    ``slot_mask`` bits) in slot order into a strip added to its rows,
    then lane l's spill entries ``[spill_ptr[b * 128 + l], ...)`` in
    order; a column at or past the end reads 0."""
    n, m = A.num_rows, A.num_columns
    k = A.chunks_per_step
    value = A.value.numpy()
    loc = A.local_index.numpy().astype(np.int64)
    mask = A.slot_mask.numpy()
    ws = A.window_start.numpy().transpose(0, 2, 1).reshape(-1, 8)
    seg = (np.zeros(A.num_chunks, np.int64) if A.segment_of_step is None
           else np.repeat(A.segment_of_step.numpy().astype(np.int64), k))
    group = A.group_of_chunk.numpy().reshape(-1)
    step_ptr = A.step_ptr.numpy()
    Xz = np.concatenate([X, np.zeros((1, X.shape[1]))])
    Y = np.zeros((A.num_out_blocks * A.out_rows * LANE, X.shape[1]))
    for b in range(A.num_out_blocks):
        for c in range(step_ptr[b] * k, step_ptr[b + 1] * k):
            strip = np.zeros((LANE, X.shape[1]))
            for s in range(8):
                if mask[c] >> s & 1:
                    col = (ws[c, s] + seg[c]) * LANE + loc[c, s]
                    col = np.where((col >= 0) & (col < m), col, m)
                    strip += value[c, s][:, None] * Xz[col]
            assert group[c] // A.out_rows == b
            Y[group[c] * LANE: (group[c] + 1) * LANE] += strip
    if A.spill_ptr is not None:
        ptr = A.spill_ptr.numpy()
        row, col = A.spill_row.numpy(), A.spill_col.numpy()
        val = A.spill_value.numpy()
        for i in range(A.num_out_blocks * LANE):
            b, lane = divmod(i, LANE)
            for e in range(ptr[i], ptr[i + 1]):
                r = (b * A.out_rows + row[e]) * LANE + lane
                Y[r] += val[e] * Xz[col[e] if 0 <= col[e] < m else m]
    assert not Y[n:].any()
    return Y[:n]


@functools.lru_cache(maxsize=None)
def _x_and_pallas(name):
    """X of max(KS) columns for the case and JAX's ``well_spmm`` of it in
    Pallas interpret mode (one interpret run a case: column j of an SpMM
    is the product of column j alone, so X[:, :k] takes its first k)."""
    _, Aj, At = _both(name)
    X = np.random.default_rng(17).standard_normal((At.num_columns,
                                                   max(KS)))
    return X, np.asarray(jwell_spmm(Aj, jnp.asarray(X), interpret=True))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", list(CASES))
def test_k6_walk_matches_plain_and_pallas(name, k):
    w, Aj, At = _both(name)
    assert (At.segment_of_step is not None) == name.startswith("segmented")
    assert (At.spill is not None) == (name != "whole")
    X17, pallas = _x_and_pallas(name)
    X = np.ascontiguousarray(X17[:, :k])
    walk = _k6_walk(At, X)
    counters = (well_whole_spmm_core, well_seg_spmm_core, csr_spmm_core)
    before = [c.launches for c in counters]
    got = well_spmm_core(At, torch.from_numpy(X))
    assert [c.launches for c in counters] == before   # CPU: plain only
    assert torch.equal(got, well_spmv_reference(At, torch.from_numpy(X)))
    _close(got, walk, 1e-12)
    _close(walk, pallas[:, :k], 1e-12)
    _close(walk, np.asarray(jspmm(Aj, jnp.asarray(X)))[: At.num_rows],
           1e-12)
    _close(walk, np.stack([w.spmv(X[:, j]) for j in range(k)], 1), 1e-12)


def _inf_case(mod):
    # row i < 382 of 512 holds {i + 128, i + 130}: with window_rows=2
    # each live slot's window starts at the group's next x row, so only
    # the all-zero slots (window 0, local index 0) point at column 0
    # (tests/test_torch_well_paths.py)
    r = np.repeat(np.arange(382), 2)
    c = r + np.tile([128, 130], 382)
    return mod("matrix", "coordinate", "real", "general", 512, 512, r.size,
               r + 1, c + 1,
               np.random.default_rng(13).standard_normal(r.size))


@pytest.mark.parametrize("k", [3, 9])
def test_zero_times_inf_deviation(k):
    """Stated deviation (ROADMAP.md, Queue 3), K5's for each column: an
    all-zero slot reads X at column window_start * 128 + local_index
    (here 0); with inf there (in column 1 of X) the JAX kernels give 0 *
    inf = NaN in that column of the slot's rows, in Pallas interpret mode
    and through XLA.  K6 does not read the slot: its plain version (and
    the kernel class's chained step) gives the host's finite product."""
    w = WellMatrix.from_matrix_market(_inf_case(MatrixMarket),
                                      window_rows=2)
    wj = JaxWellMatrix.from_matrix_market(_inf_case(JaxMatrixMarket),
                                          window_rows=2)
    X = np.random.default_rng(15).standard_normal((512, k))
    X[0, 1] = np.inf
    X0 = np.where(np.isinf(X), 0.0, X)       # column 0 holds no entry
    want = np.stack([w.spmv(X0[:, j]) for j in range(k)], 1)
    Aj = jdev.DeviceWell.from_host(wj, dtype=jnp.float64)
    for jax_y in (jwell_spmm(Aj, jnp.asarray(X), interpret=True),
                  jspmm(Aj, jnp.asarray(X))):
        jax_y = np.asarray(jax_y)
        assert np.isnan(jax_y[:384, 1]).all()             # groups 0-2
        _close(np.delete(jax_y, 1, axis=1), np.delete(want, 1, axis=1),
               1e-12)
    At = DeviceWell.from_host(w, dtype=torch.float64, device="cpu")
    got = well_spmm_core(At, torch.from_numpy(X))
    assert torch.isfinite(got).all()
    _close(got, want, 1e-12)
    kernel = make_kernel("well", mm=_inf_case(MatrixMarket), device="cpu",
                         dtype=torch.float64, window_rows=2)
    kernel.init()
    step, args = kernel.spmm_fn(k)
    assert torch.isfinite(step(torch.from_numpy(X), *args[1:])).all()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_spmm_plan(k, dtype):
    """Blocks of at most 8 columns (k = 9 and 17 take 2 and 3, the last
    narrower); 16-byte X loads exactly where X's rows and the column
    block are whole 16-byte runs and X and Y start on 16-byte
    boundaries."""
    kb = min(k, 8)
    vec = (k * dtype.itemsize) % 16 == 0 and (kb * dtype.itemsize) % 16 == 0
    plan = well_spmm_plan(k, dtype, 256, 4096)
    assert plan == {"kb": kb, "column_blocks": {9: 2, 17: 3}.get(k, 1),
                    "vector_x": vec}
    assert not well_spmm_plan(k, dtype, 256 + dtype.itemsize,
                              4096)["vector_x"]
    assert not well_spmm_plan(k, dtype, 256, 4104)["vector_x"]

"""K5's own arrays and reading of a WELL container, on the CPU.

- ``slot_mask``: bit s of chunk c is set iff slot s holds a nonzero
  value, against a count made slot by slot from the JAX container's
  chunks; a slot the segment spill emptied keeps its ``local_index``
  (so the JAX packer's ``active`` test would still count it) and has its
  bit clear, which can leave a mask that is not a prefix; inert padding
  chunks are 0.
- The spill in lane order (``spill_ptr``, ``spill_row``, ``spill_col``,
  ``spill_value``): the CSR spill's very entries, ordered by (output
  block, lane, row, column).
- K5's plain version (``well_spmv_reference``, which the K5 wrappers run
  for CPU tensors) against JAX's ``well_spmv`` in Pallas interpret mode
  and XLA's ``spmv`` on finite x: rtol 1e-12 in float64 (the sums differ
  only in rounding order), whole x and segmented, with and without a
  spill.
- The stated deviation: an inf in x under an all-zero slot gives NaN in
  the JAX kernels (0 * inf) and a finite product in the port.
- ``WellKernel.bytes_per_run`` prices what K5 moves: value + index of
  the slots that hold a nonzero, the spill and the vectors.

The inputs are made with numpy from fixed seeds and handed to both
packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.io import generate as jgen
from spmv_tpu.io.matrix_market import MatrixMarket as JaxMatrixMarket
from spmv_tpu.kernels import WellKernel as JaxWellKernel
from spmv_tpu.models import WellMatrix as JaxWellMatrix
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import spmv as jspmv
from spmv_tpu.ops import well_spmv as jwell_spmv
from spmv_tpu_torch.io import generate as pgen
from spmv_tpu_torch.io.matrix_market import MatrixMarket
from spmv_tpu_torch.kernels import make_kernel
from spmv_tpu_torch.models import DeviceWell, WellMatrix
from spmv_tpu_torch.ops import (
    well_chunks_reference,
    well_seg_core,
    well_spmv_core,
    well_spmv_reference,
    well_whole_core,
)


def _coo(mod, n, m, rows, cols, vals=None):
    rows, cols = np.asarray(rows), np.asarray(cols)
    vals = np.ones(rows.size) if vals is None else vals
    return mod("matrix", "coordinate", "real", "general", n, m, rows.size,
               rows + 1, cols + 1, vals)


def _two_clusters(mod):
    # tests/test_well.py:192-199: a near and a far diagonal in one group;
    # with segment_rows=2 the far slot (slot 1) spills
    r = np.concatenate([np.arange(128)] * 2)
    c = np.concatenate([np.arange(128), np.arange(128) + 3000])
    return _coo(mod, 128, 4000, r, c)


def _middle_slot_spills(mod):
    # rows 0..99 hold {i, 3000 + i} and rows 100..127 {i, i + 1, i + 2}:
    # slot 1's window lies far off and slot 2's near, so with
    # segment_rows=2 slot 1 spills and slots 0 and 2 stay: mask 0b101
    r, c = [], []
    for i in range(128):
        cols = [i, 3000 + i] if i < 100 else [i, i + 1, i + 2]
        r += [i] * len(cols)
        c += cols
    vals = np.random.default_rng(11).standard_normal(len(r))
    return _coo(mod, 128, 4000, r, c, vals)


def _eight_windows(mod):
    # 8 diagonals 512 columns apart: every slot of the one chunk is live
    r = np.repeat(np.arange(128), 8)
    c = np.tile(np.arange(8) * 512, 128) + r
    vals = np.random.default_rng(12).standard_normal(r.size)
    return _coo(mod, 128, 4096, r, c, vals)


def _empty_blocks(mod):
    # tests/test_well.py:312-318: two whole 8-group output blocks empty
    r = np.concatenate([np.arange(128), np.arange(2176, 2304)])
    return _coo(mod, 2304, 2304, r, r)


def _gen(fn, *args, **kw):
    def make(mod):
        return getattr(pgen if mod is MatrixMarket else jgen, fn)(
            *args, **kw)
    return make


# name -> (matrix maker (given the MatrixMarket class), window_rows,
#          device options)
CASES = {
    "whole": (_gen("poisson2d", 30, 40), 2, {}),
    "whole_spill": (_gen("random_sparse", 300, 300, 6, seed=4), 1, {}),
    "whole_blocks_per_out_2": (_gen("poisson2d", 40, 40), 2,
                               {"blocks_per_out": 2}),
    "segmented": (_gen("poisson2d", 40, 40), 2,
                  {"segment_rows": 8, "blocks_per_out": 4}),
    "segmented_spill": (_gen("banded_random", 2000, 60, 5, seed=30), 2,
                        {"segment_rows": 4}),
    "segment_rows_2": (_two_clusters, 1, {"segment_rows": 2}),
    "middle_slot_spills": (_middle_slot_spills, 1, {"segment_rows": 2}),
    "empty_blocks": (_empty_blocks, 1, {"segment_rows": 4}),
    "eight_windows": (_eight_windows, 1, {}),
}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    # the port's entry points run on the card unless asked for the CPU
    monkeypatch.setenv("SPMV_TPU_TORCH_DEVICE", "cpu")


def _both(name):
    make, window_rows, dev_kw = CASES[name]
    wj = JaxWellMatrix.from_matrix_market(make(JaxMatrixMarket),
                                          window_rows=window_rows)
    w = WellMatrix.from_matrix_market(make(MatrixMarket),
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


def _slot_count(value) -> list:
    """The mask of each chunk, slot by slot."""
    masks = []
    for chunk in value:
        m = 0
        for s in range(8):
            if any(v != 0 for v in chunk[s]):
                m |= 1 << s
        masks.append(m)
    return masks


@pytest.mark.parametrize("name", list(CASES))
def test_slot_mask_matches_a_count_of_the_chunks(name):
    w, Aj, At = _both(name)
    value = np.asarray(Aj.value)
    assert At.slot_mask.dtype == torch.uint8
    assert At.slot_mask.shape == (At.num_chunks,)
    assert At.slot_mask.tolist() == _slot_count(value)
    # the JAX packer's `active` test also counts a nonzero local_index
    active = (value != 0).any(axis=2) | (
        np.asarray(Aj.local_index) != 0).any(axis=2)
    bits = (At.slot_mask.numpy()[:, None] >> np.arange(8)) & 1
    assert (bits <= active).all()
    host_masks = _slot_count(w.value)
    if name in ("segment_rows_2", "middle_slot_spills"):
        # the spilled slot kept its local_index and lost its bit
        assert (bits < active).any()
        assert host_masks[0] != At.slot_mask.tolist()[0]
    if name == "middle_slot_spills":
        assert host_masks == [0b111]
        assert At.slot_mask.tolist()[0] == 0b101
    # the step padding's inert chunks are 0: in whole-x mode the masks
    # are the host chunks' and as many zeros as padding chunks
    if name in ("whole", "whole_spill", "empty_blocks"):
        assert At.num_chunks > w.num_chunks
    if At.segment_of_step is None:
        assert sorted(At.slot_mask.tolist()) == sorted(
            host_masks + [0] * (At.num_chunks - w.num_chunks))
    if name == "eight_windows":
        assert At.slot_mask.tolist()[0] == 0xff


@pytest.mark.parametrize("name", [n for n in CASES if "spill" in n
                                  or n == "segment_rows_2"])
def test_lane_ordered_spill_holds_the_csr_entries(name):
    _, _, At = _both(name)
    S = At.spill
    assert S is not None
    rp = S.row_ptr.numpy()
    rows = np.repeat(np.arange(S.num_rows), np.diff(rp))
    csr = sorted(zip(rows.tolist(), S.column_index.tolist(),
                     S.value.tolist()))
    ptr = At.spill_ptr.numpy()
    assert ptr.shape == (At.num_out_blocks * 128 + 1,)
    assert ptr[0] == 0 and ptr[-1] == S.value.numel()
    assert (np.diff(ptr) >= 0).all()
    assert At.spill_row.dtype == At.spill_col.dtype == torch.int32
    assert At.spill_value.dtype == S.value.dtype
    keys, lane_order = [], []
    for key in range(At.num_out_blocks * 128):
        b, lane = divmod(key, 128)
        for e in range(ptr[key], ptr[key + 1]):
            tr = int(At.spill_row[e])
            assert 0 <= tr < At.out_rows
            row = (b * At.out_rows + tr) * 128 + lane
            col = int(At.spill_col[e])
            keys.append((b, lane, row, col))
            lane_order.append((row, col, float(At.spill_value[e])))
    assert keys == sorted(keys)
    assert sorted(lane_order) == csr


@pytest.mark.parametrize("name", [n for n in CASES if n != "eight_windows"])
def test_k5_plain_matches_jax(name):
    """The K5 wrappers on CPU tensors (the masked chunks and the spill)
    against JAX on finite x: Pallas interpret and XLA."""
    w, Aj, At = _both(name)
    x = np.random.default_rng(5).standard_normal(At.num_columns)
    core = well_whole_core if At.segment_of_step is None else well_seg_core
    got = core(At, torch.from_numpy(x))
    assert torch.equal(got, well_spmv_reference(At, torch.from_numpy(x)))
    _close(got, jwell_spmv(Aj, jnp.asarray(x), interpret=True), 1e-12)
    _close(got, np.asarray(jspmv(Aj, jnp.asarray(x)))[: At.num_rows], 1e-12)
    _close(got, w.spmv(x), 1e-12)


def test_masked_and_unmasked_chunks_agree_on_finite_x():
    """Without an inf or NaN in x, reading the all-zero slots (the JAX
    kernels) or not (K5 and K6) gives the same numbers."""
    _, _, At = _both("segment_rows_2")
    X = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (At.num_columns, 3)))
    assert torch.equal(well_chunks_reference(At, X),
                       well_chunks_reference(At, X, masked=False))


def _inf_case(mod):
    # row i < 382 of 512 holds {i + 128, i + 130}: with window_rows=2
    # each live slot's window starts at the group's next x row, so only
    # the all-zero slots (window 0, local index 0) point at column 0
    r = np.repeat(np.arange(382), 2)
    c = r + np.tile([128, 130], 382)
    return _coo(mod, 512, 512, r, c,
                np.random.default_rng(13).standard_normal(r.size))


def test_zero_times_inf_deviation():
    """Stated deviation (ROADMAP.md, Queue 3): an all-zero slot reads x at
    column window_start * 128 + local_index (here 0); with inf there the
    JAX kernels give 0 * inf = NaN in the slot's rows, in Pallas
    interpret mode and through XLA.  K5 does not read the slot and gives
    the host's finite product; reading every slot, as the JAX kernels
    do, gives NaN in the port's plain chunks too."""
    w = WellMatrix.from_matrix_market(_inf_case(MatrixMarket),
                                      window_rows=2)
    wj = JaxWellMatrix.from_matrix_market(_inf_case(JaxMatrixMarket),
                                          window_rows=2)
    x = np.random.default_rng(14).standard_normal(512)
    x[0] = np.inf
    want = w.spmv(np.where(np.isinf(x), 0.0, x))  # column 0 holds no entry
    assert np.isfinite(want).all()
    Aj = jdev.DeviceWell.from_host(wj, dtype=jnp.float64)
    for jax_y in (jwell_spmv(Aj, jnp.asarray(x), interpret=True),
                  jspmv(Aj, jnp.asarray(x))):
        assert np.isnan(np.asarray(jax_y)[:384]).all()   # groups 0-2
    At = DeviceWell.from_host(w, dtype=torch.float64, device="cpu")
    got = well_spmv_core(At, torch.from_numpy(x))
    assert torch.isfinite(got).all()
    _close(got, want, 1e-12)
    assert torch.isnan(well_chunks_reference(
        At, torch.from_numpy(x), masked=False)[:384]).all()
    # the kernel class's chained step takes the same path
    k = make_kernel("well", mm=_inf_case(MatrixMarket), device="cpu",
                    dtype=torch.float64, window_rows=2)
    k.init()
    step, args = k.run_fn()
    y = step(torch.from_numpy(x), *args[1:])
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("name", ["whole", "whole_spill", "segmented_spill",
                                  "eight_windows"])
def test_bytes_per_run_counts_the_live_slots(name):
    """128 x (value + index) bytes per host slot that holds a nonzero,
    the spill's entries and the vectors once; the JAX class's count
    where no slot is all zero (eight_windows)."""
    make, window_rows, _ = CASES[name]
    jk = JaxWellKernel(mm=make(JaxMatrixMarket), window_rows=window_rows)
    jk.init()
    for dtype, vb in ((torch.float64, 8), (torch.float32, 4)):
        k = make_kernel("well", mm=make(MatrixMarket), device="cpu",
                        dtype=dtype, window_rows=window_rows)
        k.init()
        m = k.matrix
        live = sum(bin(v).count("1") for v in _slot_count(m.value))
        spill = 0 if m.spill is None else m.spill.num_entries
        want = (live * 128 + spill) * (vb + 4) + (
            m.num_rows + m.num_columns) * vb
        assert k.bytes_per_run() == want
        if dtype == torch.float64:
            assert (k.bytes_per_run() == jk.bytes_per_run()) == (
                name == "eight_windows")
            assert k.bytes_per_run() <= jk.bytes_per_run()

"""The port's WELL-CW and CSR SpMM against the JAX package.

Inputs come from numpy with fixed seeds, on the matrices of
tests/test_torch_wellcw.py (merged grid, forced fallback, fallback with
pool and tails, CSR remainder, rectangular), and go through both
packages:

- the port's plain SpMM (what its wrappers run for CPU tensors) against
  JAX's XLA ``spmm`` at k = 1 and k = 3, and against ``wellcw_spmm`` in
  Pallas interpret mode at k = 2 on two fallback matrices (the merged
  grid's interpret run takes minutes, so it is marked ``slow``, as the
  JAX tests mark theirs);
- column j of the plain SpMM against the plain SpMV of X[:, j], and the
  plain CSR SpMM against JAX's ``spmm`` on ``DeviceCsr``.

Tolerances: rtol 1e-12 in float64 (the sums differ only in rounding
order); in float32, 1e-5 relative max-norm against the fp64 host
product (one float32 rounding per term and per partial sum).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.io.generate import banded_random, random_sparse
from spmv_tpu.models import CsrMatrix as JaxCsrMatrix
from spmv_tpu.models import WellCwMatrix as JaxWellCwMatrix
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import spmm as jspmm
from spmv_tpu.ops.pallas_kernels import wellcw_spmm as jwellcw_spmm
from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.kernels import make_kernel
from spmv_tpu_torch.models import (
    CsrMatrix,
    DeviceCsr,
    DeviceWellCw,
    WellCwMatrix,
    csr_from_spmv_tpu,
)
from spmv_tpu_torch.ops import (
    csr_spmm,
    csr_spmm_core,
    csr_spmv_reference,
    spmm,
    wellcw_level_spmm_core,
    wellcw_merged_spmm_core,
    wellcw_pool_spmm_core,
    wellcw_spmm,
    wellcw_spmm_core,
    wellcw_spmv,
    wellcw_spmv_reference,
)
from spmv_tpu_torch.ops.wellcw_kernels import column_block

# name -> (matrix, host packing options, device options), as in
# tests/test_torch_wellcw.py
CASES = {
    "merged": (lambda: banded_random(16384, 512, 6, seed=20), {}, {}),
    "forced_fallback": (lambda: banded_random(16384, 512, 6, seed=20), {},
                        {"chunks_per_step": 32}),
    "banded_random": (lambda: banded_random(1500, 400, 8, seed=2), {}, {}),
    "banded_4096": (lambda: banded_random(4096, 128, 8, seed=1), {}, {}),
    "remainder": (lambda: random_sparse(256, 256, 12, seed=7),
                  {"levels": [(2, 1, 0.0)], "pool_cap": 0}, {}),
    "scattered": (lambda: random_sparse(700, 700, 10, seed=1), {}, {}),
    "rect_wide": (lambda: random_sparse(300, 1100, 6, seed=3), {}, {}),
    "rect_tall": (lambda: random_sparse(1100, 300, 5, seed=4), {}, {}),
}
SPMM_LAUNCHES = (wellcw_merged_spmm_core, wellcw_level_spmm_core,
                 wellcw_pool_spmm_core, csr_spmm_core)


@pytest.fixture(autouse=True)
def _fp64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    # the port's entry points run on the card unless asked for the CPU
    monkeypatch.setenv("SPMV_TPU_TORCH_DEVICE", "cpu")


@functools.lru_cache(maxsize=None)
def _host(name, jax=False):
    """The port's host matrix of a case, or with ``jax`` the JAX
    package's (the same packer's copy: equal arrays)."""
    make, host_kw, _ = CASES[name]
    cls = JaxWellCwMatrix if jax else WellCwMatrix
    return cls.from_matrix_market(make(), **host_kw)


def _both(name, dtype=torch.float64):
    w = _host(name)
    dev_kw = CASES[name][2]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    Aj = jdev.DeviceWellCw.from_host(_host(name, jax=True), dtype=jdt,
                                     **dev_kw)
    At = DeviceWellCw.from_host(w, dtype=dtype, device="cpu", **dev_kw)
    return w, Aj, At


def _X(m, k, seed=4):
    return np.random.default_rng(seed).standard_normal((m, k))


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _launches():
    return tuple(w.launches for w in SPMM_LAUNCHES)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_spmm_matches_jax_xla(name, k):
    w, Aj, At = _both(name)
    X = _X(At.num_columns, k)
    before = _launches()
    got = wellcw_spmm(At, torch.from_numpy(X))
    assert got.shape == (At.num_rows, k)
    _close(got, jspmm(Aj, jnp.asarray(X)), 1e-12)
    _close(got, w.spmm(X), 1e-12)
    # the wrappers' composition is the plain specification, bit for bit
    assert torch.equal(got, wellcw_spmv_reference(At, torch.from_numpy(X)))
    # CPU tensors take the plain versions: no kernel launched
    assert _launches() == before


# the remainder case (a fallback level and a CSR remainder) and a
# fallback level with pool and a 128-group tail; 3-35 s each in the
# Pallas interpreter
@pytest.mark.parametrize("name", ["remainder", "banded_random"])
def test_plain_spmm_matches_pallas_interpret(name):
    _, Aj, At = _both(name)
    X = _X(At.num_columns, 2, seed=5)
    got = wellcw_spmm(At, torch.from_numpy(X))
    _close(got, jwellcw_spmm(Aj, jnp.asarray(X), interpret=True), 1e-12)


@pytest.mark.slow
def test_plain_spmm_matches_pallas_interpret_merged():
    _, Aj, At = _both("merged")
    assert At.merged is not None
    X = _X(At.num_columns, 2, seed=5)
    got = wellcw_spmm(At, torch.from_numpy(X))
    _close(got, jwellcw_spmm(Aj, jnp.asarray(X), interpret=True), 1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_spmm_columns_are_spmv(name):
    _, _, At = _both(name)
    X = torch.from_numpy(_X(At.num_columns, 3, seed=7))
    Y = wellcw_spmm(At, X)
    for j in range(3):
        _close(Y[:, j], wellcw_spmv(At, X[:, j].contiguous()), 1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_spmm_float32_matches_fp64_host(name):
    w, _, At = _both(name, dtype=torch.float32)
    X = _X(At.num_columns, 3, seed=6).astype(np.float32)
    got = wellcw_spmm(At, torch.from_numpy(X))
    assert got.dtype == torch.float32
    want = w.spmm(X.astype(np.float64))
    err = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("rows,cols,seed", [(300, 300, 11), (120, 400, 12),
                                            (400, 90, 13)])
def test_csr_plain_spmm_matches_jax(rows, cols, seed):
    mm = random_sparse(rows, cols, 7, seed=seed)
    m = CsrMatrix.from_matrix_market(mm)
    Aj = jdev.DeviceCsr.from_host(JaxCsrMatrix.from_matrix_market(mm),
                                  dtype=jnp.float64)
    A = DeviceCsr.from_host(m)
    X = _X(cols, 3, seed=seed)
    want = np.asarray(jspmm(Aj, jnp.asarray(X)))
    Xt = torch.from_numpy(X)
    _close(csr_spmv_reference(A, Xt), want, 1e-12)
    _close(csr_spmm(A, Xt), want, 1e-12)
    _close(spmm(csr_from_spmv_tpu(Aj), Xt), want, 1e-12)
    out = torch.ones(rows, 3)
    csr_spmm_core(A, Xt, out=out, accumulate=True)
    _close(out, want + 1.0, 1e-12)
    for j in range(3):
        _close(csr_spmv_reference(A, Xt[:, j]), want[:, j], 1e-12)


def test_spmm_out_buffer_and_parts_accumulate():
    w, _, At = _both("forced_fallback")
    X = torch.from_numpy(_X(At.num_columns, 3))
    n = At.num_rows
    out = torch.empty(n, 3)
    Y = wellcw_spmm_core(At, X, out=out)
    assert Y is out
    # the parts by hand, in stream order
    Y2 = wellcw_level_spmm_core(At.levels[0], X, n)
    wellcw_pool_spmm_core(At.pool, X, n, out=Y2, accumulate=True)
    for tp in At.tail_pools:
        wellcw_pool_spmm_core(tp, X, n, out=Y2, accumulate=True)
    assert torch.equal(Y, Y2)
    _, _, Am = _both("merged")
    Ym = wellcw_merged_spmm_core(Am.merged, X, n)
    for tp in Am.tail_pools:
        wellcw_pool_spmm_core(tp, X, n, out=Ym, accumulate=True)
    _close(Ym, w.spmm(X.numpy()), 1e-12)
    with pytest.raises(KernelError, match="accumulate"):
        wellcw_level_spmm_core(At.levels[0], X, n, accumulate=True)
    with pytest.raises(KernelError, match="accumulate"):
        csr_spmm_core(_both("remainder")[2].remainder,
                      torch.ones(256, 2), accumulate=True)


def _bad(At):
    n, m = At.num_rows, At.num_columns
    X = torch.ones(m, 3)
    return {
        "one_d": dict(X=torch.ones(m)),
        "dtype": dict(X=torch.ones(m, 3, dtype=torch.float32)),
        "shape": dict(X=torch.ones(m + 1, 3)),
        "strided": dict(X=torch.ones(m, 6)[:, ::2]),
        "out_aliases_x": dict(X=X, out=X[:n]),
        "out_shape": dict(X=X, out=torch.empty(n, 4)),
        "meta_device": dict(X=torch.ones(m, 3, device="meta")),
    }


@pytest.mark.parametrize("what", ["one_d", "dtype", "shape", "strided",
                                  "out_aliases_x", "out_shape",
                                  "meta_device"])
def test_spmm_wrapper_rejects_bad_inputs(what):
    """Checks run before anything else; a device that is neither the
    CPU nor CUDA raises instead of falling back."""
    _, _, At = _both("rect_wide")
    args = _bad(At)[what]
    if what == "meta_device":
        At = At.to("meta")
    with pytest.raises(KernelError):
        wellcw_spmm_core(At, args["X"], out=args.get("out"))


@pytest.mark.parametrize("name", ["merged", "rect_wide", "rect_tall"])
def test_make_kernel_spmm_fn_chains(name):
    """``make_kernel("wellcw").spmm_fn(k)`` chains Y back into X (two
    buffers in turn on a square matrix) like the JAX kernel's step."""
    w = _host(name)
    kern = make_kernel("wellcw", matrix=w, device="cpu", dtype=torch.float64)
    kern.init()
    step, args = kern.spmm_fn(2)
    V, want = args[0], np.ones((w.num_columns, 2))
    assert V.shape == (w.num_columns, 2)
    for _ in range(3):
        nxt = step(V, *args[1:])
        assert nxt.data_ptr() != V.data_ptr()
        V = nxt
        Y = w.spmm(want)
        want = Y[: w.num_columns] if Y.shape[0] >= w.num_columns else \
            np.concatenate([Y, want[Y.shape[0]:]])
    _close(V, want, 1e-12)
    with pytest.raises(KernelError, match="positive"):
        kern.spmm_fn(0)


def test_column_block_widths():
    """The SpMM kernels' column blocks: a level thread holds 8 columns;
    a pool tile as many as its shared-memory budget allows, at least 1;
    only a tile that cannot hold one column raises."""
    f32, f64 = torch.float32, torch.float64
    assert column_block("level", f64, 3) == 3
    assert column_block("level", f32, 20) == 8
    assert column_block("merged", f32, 8) == 8      # 64 KB tile
    assert column_block("merged", f64, 8) == 4
    assert column_block("merged", f32, 2) == 2
    assert column_block("pool", f32, 8, rows=128) == 2
    assert column_block("pool", f64, 8, rows=128) == 1   # 32 KB a column
    assert column_block("pool", f32, 8, rows=64) == 4
    assert column_block("pool", f32, 16, rows=8) == 8     # register block
    assert column_block("pool", f64, 1, rows=512) == 1   # 128 KB, opt-in
    with pytest.raises(KernelError, match="232448"):
        column_block("pool", f64, 1, rows=1024)

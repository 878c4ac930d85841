"""The port's WELL-CW and CSR containers and SpMV against the JAX package.

Inputs come from numpy with fixed seeds, on the JAX WELL-CW tests' own
matrices (tests/test_wellcw.py), and go through both packages:

- every array of the port's ``DeviceWellCw`` (merged grid, fallback
  levels and pool, tail pools, CSR remainder) equals the JAX
  container's for the same host matrix and ``chunks_per_step``;
- the port's plain versions (what its wrappers run for CPU tensors) are
  held against JAX's XLA ``spmv`` and against the Pallas kernels in
  interpret mode, as the JAX tests run them: rtol 1e-12 in float64 (the
  sums differ only in rounding order); in float32, 1e-5 relative
  max-norm against the fp64 host product (one float32 rounding per
  term and per partial sum).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.errors import KernelError, MatrixError
from spmv_tpu.io.generate import banded_random, poisson2d, random_sparse
from spmv_tpu.kernels import WellCwKernel as JaxWellCwKernel
from spmv_tpu.models import CsrMatrix, WellCwMatrix
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import spmv as jspmv
from spmv_tpu.ops.pallas_kernels import wellcw_spmv as jwellcw_spmv
from spmv_tpu_torch.kernels import make_kernel
from spmv_tpu_torch.models import (
    DeviceCsr,
    DeviceWellCw,
    csr_from_spmv_tpu,
    wellcw_from_spmv_tpu,
)
from spmv_tpu_torch.ops import (
    csr_spmv,
    csr_spmv_core,
    csr_spmv_reference,
    spmm,
    spmv,
    wellcw_level_core,
    wellcw_merged_core,
    wellcw_pool_core,
    wellcw_spmv,
    wellcw_spmv_core,
    wellcw_spmv_reference,
)

# name -> (matrix, host packing options, device options)
CASES = {
    # merged grid with 128- and 64-group tail pools (test_wellcw.py:235)
    "merged": (lambda: banded_random(16384, 512, 6, seed=20), {}, {}),
    # the same matrix with the merged grid turned off (:286-292)
    "forced_fallback": (lambda: banded_random(16384, 512, 6, seed=20), {},
                        {"chunks_per_step": 32}),
    # fallback level + pool + a 128-group tail (:33)
    "banded_random": (lambda: banded_random(1500, 400, 8, seed=2), {}, {}),
    "banded_4096": (lambda: banded_random(4096, 128, 8, seed=1), {}, {}),
    # a real CSR remainder (:117-123)
    "remainder": (lambda: random_sparse(256, 256, 12, seed=7),
                  {"levels": [(2, 1, 0.0)], "pool_cap": 0}, {}),
    "scattered": (lambda: random_sparse(700, 700, 10, seed=1), {}, {}),
    "rect_wide": (lambda: random_sparse(300, 1100, 6, seed=3), {}, {}),
    "rect_tall": (lambda: random_sparse(1100, 300, 5, seed=4), {}, {}),
}
# the Pallas interpreter takes 1-45 s a matrix; these cover the merged
# grid, the fallback level, pool and both tail widths, and the remainder
INTERPRET_CASES = ("merged", "forced_fallback", "remainder", "rect_wide")


@pytest.fixture(autouse=True)
def _fp64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@functools.lru_cache(maxsize=None)
def _host(name):
    make, host_kw, _ = CASES[name]
    return WellCwMatrix.from_matrix_market(make(), **host_kw)


def _both(name, dtype=torch.float64):
    w = _host(name)
    dev_kw = CASES[name][2]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    Aj = jdev.DeviceWellCw.from_host(w, dtype=jdt, **dev_kw)
    At = DeviceWellCw.from_host(w, dtype=dtype, device="cpu", **dev_kw)
    return w, Aj, At


def _x(n, seed=4):
    return np.random.default_rng(seed).standard_normal(n)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _same(t, a):
    a = np.asarray(a)
    assert tuple(t.shape) == a.shape
    assert str(t.dtype).replace("torch.", "") == a.dtype.name
    np.testing.assert_array_equal(t.numpy(), a)


_FIELDS = {
    "level": ("value", "local_index", "anchor4", "group_of_chunk",
              "block_of_step"),
    "pool": ("value", "local_index", "anchor4", "rowmap", "block_of_step"),
    "merged": ("value", "local_index", "anchor4"),
}
_META = {
    "level": ("d", "num_chunks", "chunks_per_step", "xr4"),
    "pool": ("d", "num_chunks", "chunks_per_step", "xr4", "out_rows"),
    "merged": ("d", "kl", "cap", "lvl_per_block", "pool_per_block",
               "num_blocks", "xr4"),
}


def _same_part(kind, pt, pj):
    for f in _FIELDS[kind]:
        _same(getattr(pt, f), getattr(pj, f))
    for f in _META[kind]:
        assert getattr(pt, f) == getattr(pj, f), f


def _same_container(At, Aj):
    for f in ("num_rows", "num_columns", "num_entries", "num_groups",
              "blocks_per_out"):
        assert getattr(At, f) == getattr(Aj, f), f
    assert (At.merged is None) == (Aj.merged is None)
    if Aj.merged is not None:
        _same_part("merged", At.merged, Aj.merged)
    assert len(At.levels) == len(Aj.levels)
    for lt, lj in zip(At.levels, Aj.levels):
        _same_part("level", lt, lj)
    assert (At.pool is None) == (Aj.pool is None)
    if Aj.pool is not None:
        _same_part("pool", At.pool, Aj.pool)
    assert len(At.tail_pools) == len(Aj.tail_pools)
    for pt, pj in zip(At.tail_pools, Aj.tail_pools):
        _same_part("pool", pt, pj)
    assert (At.remainder is None) == (Aj.remainder is None)
    if Aj.remainder is not None:
        r, rj = At.remainder, Aj.remainder
        n, stored = rj.num_rows, int(np.asarray(rj.row_ptr)[rj.num_rows])
        _same(r.row_ptr, np.asarray(rj.row_ptr)[: n + 1])
        _same(r.column_index, np.asarray(rj.column_index)[:stored])
        _same(r.value, np.asarray(rj.value)[:stored])


@pytest.mark.parametrize("name", list(CASES))
def test_arrays_match_jax_container(name):
    _, Aj, At = _both(name)
    assert (At.merged is not None) == (name == "merged")
    _same_container(At, Aj)
    # the converter from the JAX container gives the very same arrays
    _same_container(wellcw_from_spmv_tpu(Aj), Aj)


@pytest.mark.parametrize("name", list(CASES))
def test_chunk_pointers_cover_every_chunk(name):
    _, _, At = _both(name)
    for lvl in At.levels:
        grp = lvl.group_of_chunk.reshape(-1)
        ptr = lvl.group_ptr
        assert ptr[0] == 0 and ptr[-1] == lvl.num_chunks
        for g in (0, At.num_groups // 2, At.num_groups - 1):
            assert bool((grp[ptr[g]:ptr[g + 1]] == g).all())
    for pool in ([At.pool] if At.pool is not None else []) + list(
            At.tail_pools):
        ptr = pool.block_ptr
        assert ptr[0] == 0 and ptr[-1] == pool.num_chunks
        blk = torch.repeat_interleave(pool.block_of_step,
                                      pool.chunks_per_step)
        for b in range(pool.num_blocks):
            assert bool((blk[ptr[b]:ptr[b + 1]] == b).all())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_jax_xla(name):
    w, Aj, At = _both(name)
    x = _x(At.num_columns)
    launches = (wellcw_merged_core.launches, wellcw_level_core.launches,
                wellcw_pool_core.launches, csr_spmv_core.launches)
    got = wellcw_spmv(At, torch.from_numpy(x))
    _close(got, jspmv(Aj, jnp.asarray(x)), 1e-12)
    _close(got, w.spmv(x), 1e-12)
    # the wrappers' composition is the plain specification, bit for bit
    assert torch.equal(got, wellcw_spmv_reference(At, torch.from_numpy(x)))
    # CPU tensors take the plain versions: no kernel launched
    assert (wellcw_merged_core.launches, wellcw_level_core.launches,
            wellcw_pool_core.launches, csr_spmv_core.launches) == launches


@pytest.mark.parametrize("name", INTERPRET_CASES)
def test_plain_matches_pallas_interpret(name):
    _, Aj, At = _both(name)
    x = _x(At.num_columns, seed=5)
    got = wellcw_spmv(At, torch.from_numpy(x))
    _close(got, jwellcw_spmv(Aj, jnp.asarray(x), interpret=True), 1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_float32_matches_fp64_host(name):
    w, _, At = _both(name, dtype=torch.float32)
    assert At.value_dtype == torch.float32
    x = _x(At.num_columns, seed=6).astype(np.float32)
    got = wellcw_spmv(At, torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = w.spmv(x.astype(np.float64))
    err = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("rows,cols,seed", [(300, 300, 11), (120, 400, 12),
                                            (400, 90, 13)])
def test_csr_plain_matches_jax(rows, cols, seed):
    mm = random_sparse(rows, cols, 7, seed=seed)
    m = CsrMatrix.from_matrix_market(mm)
    Aj = jdev.DeviceCsr.from_host(m, dtype=jnp.float64)
    A = DeviceCsr.from_host(m)
    assert A.value.dtype == torch.float64
    Ac = csr_from_spmv_tpu(Aj)
    for f in ("row_ptr", "column_index", "value"):
        assert torch.equal(getattr(A, f), getattr(Ac, f)), f
    x = _x(cols, seed=seed)
    want = jspmv(Aj, jnp.asarray(x))
    _close(csr_spmv_reference(A, torch.from_numpy(x)), want, 1e-12)
    _close(csr_spmv(A, torch.from_numpy(x)), want, 1e-12)
    _close(spmv(Ac, torch.from_numpy(x)), want, 1e-12)
    out = torch.ones(rows)
    csr_spmv_core(A, torch.from_numpy(x), out=out, accumulate=True)
    _close(out, np.asarray(want) + 1.0, 1e-12)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_narrow_dtypes_refused(dtype):
    w = _host("rect_wide")
    with pytest.raises(MatrixError, match=">=32-bit"):
        DeviceWellCw.from_host(w, dtype=dtype)
    with pytest.raises(MatrixError):
        jdev.DeviceWellCw.from_host(w, dtype=jnp.bfloat16)


def test_dispatch_forward_and_spmm_refusal():
    w, _, At = _both("remainder")
    x = torch.from_numpy(_x(At.num_columns))
    _close(At(x), w.spmv(x.numpy()), 1e-12)
    x32 = x.float()                            # spmv casts it to float64
    _close(spmv(At, x32), w.spmv(x32.double().numpy()), 1e-12)
    _close(At.remainder(x), w.remainder.spmv(x.numpy()), 1e-12)
    with pytest.raises(KernelError, match="not yet ported"):
        spmm(At, x[:, None])


def test_out_buffer_and_parts_accumulate():
    w, _, At = _both("forced_fallback")
    x = torch.from_numpy(_x(At.num_columns))
    n = At.num_rows
    out = torch.empty(n)
    y = wellcw_spmv_core(At, x, out=out)
    assert y is out
    # the parts by hand, in stream order
    y2 = wellcw_level_core(At.levels[0], x, n)
    wellcw_pool_core(At.pool, x, n, out=y2, accumulate=True)
    for tp in At.tail_pools:
        wellcw_pool_core(tp, x, n, out=y2, accumulate=True)
    assert torch.equal(y, y2)
    _, _, Am = _both("merged")
    ym = wellcw_merged_core(Am.merged, x, n)
    for tp in Am.tail_pools:
        wellcw_pool_core(tp, x, n, out=ym, accumulate=True)
    _close(ym, w.spmv(x.numpy()), 1e-12)


def _bad(At):
    n, m = At.num_rows, At.num_columns
    x = torch.ones(m)
    return {
        "dtype": dict(x=torch.ones(m, dtype=torch.float32)),
        "shape": dict(x=torch.ones(m + 1)),
        "strided": dict(x=torch.ones(2 * m)[::2]),
        "out_aliases_x": dict(x=x, out=x[:n]),
        "out_shape": dict(x=x, out=torch.empty(n + 1)),
        "meta_device": dict(x=torch.ones(m, device="meta")),
    }


@pytest.mark.parametrize("what", ["dtype", "shape", "strided",
                                  "out_aliases_x", "out_shape",
                                  "meta_device"])
def test_wrapper_rejects_bad_inputs(what):
    """Checks run before anything else; a device that is neither the
    CPU nor CUDA raises instead of falling back."""
    _, _, At = _both("rect_tall")
    args = _bad(At)[what]
    if what == "meta_device":
        At = At.to("meta")
    with pytest.raises(KernelError):
        wellcw_spmv_core(At, args["x"], out=args.get("out"))


def test_parts_refuse_accumulate_without_out():
    _, _, At = _both("remainder")
    x = torch.from_numpy(_x(At.num_columns))
    with pytest.raises(KernelError, match="accumulate"):
        wellcw_level_core(At.levels[0], x, At.num_rows, accumulate=True)
    with pytest.raises(KernelError, match="accumulate"):
        csr_spmv_core(At.remainder, x, accumulate=True)


@pytest.mark.parametrize("name", ["merged", "rect_wide", "rect_tall"])
def test_make_kernel_run_fn_chains(name):
    """``make_kernel("wellcw").run_fn()`` chains y back into x (two
    buffers in turn on a square matrix) like the JAX kernel's step."""
    w = _host(name)
    k = make_kernel("wellcw", matrix=w, device="cpu", dtype=torch.float64)
    k.init()
    step, args = k.run_fn()
    v, want = args[0], np.ones(w.num_columns)
    for _ in range(3):
        nxt = step(v, *args[1:])
        assert nxt.data_ptr() != v.data_ptr()
        v = nxt
        y = w.spmv(want)
        want = y[: w.num_columns] if y.size >= w.num_columns else \
            np.concatenate([y, want[y.size:]])
    _close(v, want, 1e-12)
    with pytest.raises(KernelError, match="not yet ported"):
        k.spmm_fn(2)


def test_bytes_per_run_matches_jax_kernel_at_x64():
    """The byte count is the shared class's, at the tensor's width (the
    tests run JAX with x64 on, so the JAX class prices 8-byte
    values)."""
    mm = banded_random(4096, 128, 8, seed=1)
    jk = JaxWellCwKernel(mm=mm)
    jk.init()
    for dtype, vb in ((torch.float64, 8), (torch.float32, 4)):
        k = make_kernel("wellcw", mm=mm, device="cpu", dtype=dtype)
        k.init()
        assert k.value_bytes == vb
        if dtype == torch.float64:
            assert k.bytes_per_run() == jk.bytes_per_run()
            assert k.traffic_split() == jk.traffic_split()
        stream, vec = k.traffic_split()
        assert vec == (k.matrix.num_rows + k.matrix.num_columns) * vb
        assert stream + vec == k.bytes_per_run()
        assert k.describe() == jk.describe()


def test_poisson_through_cg_matvec():
    """An SPD WELL-CW operator in the generic CG (the CLI's --cg path)."""
    from spmv_tpu_torch.ops import conjugate_gradient

    w = WellCwMatrix.from_matrix_market(poisson2d(12, 12))
    A = DeviceWellCw.from_host(w)
    b = spmv(A, torch.ones(w.num_columns))
    res = conjugate_gradient(lambda v: spmv(A, v), b, tol=1e-12,
                             max_iterations=500)
    assert res.iterations > 0
    _close(res.x, np.ones(w.num_rows), 1e-9)

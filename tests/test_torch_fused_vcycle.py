"""The port's fused V-cycle (``spmv_tpu_torch/ops/fused_vcycle.py``: the
setup, ``FusedVcycle``, the plain version of kernel K8 and its wrapper)
against the JAX package.

Inputs come from numpy with fixed seeds and go through both packages:

- ``fused_block_setup`` is the JAX package's numpy code, copied: its
  hierarchy's arrays must be EQUAL;
- ``fused_vcycle_reference`` (what the wrapper runs for CPU tensors) is
  held against JAX's ``fused_vcycle`` in Pallas interpret mode, as the
  JAX tests run it: relative 2-norm 1e-12 in float64 (rounding order
  only) and 5e-6 in float32 (the JAX test's bound,
  tests/test_fused_vcycle.py:65);
- where the JAX kernel refuses a hierarchy for its TPU lane layout (a
  diagonal offset past the 128-lane chunk, poisson2d(64, 16)) the port
  runs it: a stated deviation, held instead against the port's own
  ``block_vcycle`` on the same hierarchy, as the JAX test holds the
  fused cycle to the block one;
- PCG with the fused preconditioner takes the iteration count of JAX's
  PCG with the block V-cycle on the same hierarchy.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.errors import MatrixError as JaxMatrixError
from spmv_tpu.io.generate import poisson2d as jpoisson2d
from spmv_tpu.models import CsrMatrix as JaxCsrMatrix
from spmv_tpu.models.device import DeviceCsr as JaxDeviceCsr
from spmv_tpu.ops import preconditioned_conjugate_gradient as jax_pcg
from spmv_tpu.ops import spmv as jspmv
from spmv_tpu_torch.errors import KernelError, MatrixError
from spmv_tpu_torch.io.generate import poisson2d
from spmv_tpu_torch.models import CsrMatrix, DeviceCsr
from spmv_tpu_torch.ops import (
    FusedVcycle,
    block_aggregation_setup,
    fused_block_setup,
    fused_vcycle,
    fused_vcycle_core,
    fused_vcycle_device,
    fused_vcycle_preconditioner,
    fused_vcycle_reference,
    preconditioned_conjugate_gradient,
    spmv,
)
from spmv_tpu_torch.ops.amg import _cheb_smooth, block_amg_device, block_vcycle

jf = importlib.import_module("spmv_tpu.ops.fused_vcycle")
ja = importlib.import_module("spmv_tpu.ops.amg")
pf = importlib.import_module("spmv_tpu_torch.ops.fused_vcycle")

TOL = {torch.float64: 1e-12, torch.float32: 5e-6}
JAX_DTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    # the port's entry points run on the card unless asked for the CPU
    monkeypatch.setenv("SPMV_TPU_TORCH_DEVICE", "cpu")


def _setups(shape, **kw):
    return (jf.fused_block_setup(
                JaxCsrMatrix.from_matrix_market(jpoisson2d(*shape)), **kw),
            fused_block_setup(
                CsrMatrix.from_matrix_market(poisson2d(*shape)), **kw))


def _norm_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("shape,smooth", [
    ((16, 128), 1), ((16, 128), 0), ((16, 120), 1), ((64, 16), 1),
    ((32, 512), 1)])
def test_fused_setup_equals_jax(shape, smooth):
    hj, hp = _setups(shape, smooth_levels=smooth)
    assert hp.original_rows == hj.original_rows == shape[0] * shape[1]
    assert len(hp.levels) == len(hj.levels)
    for lp, lj in zip(hp.levels, hj.levels):
        assert lp.n == lp.n_pad        # fused-aligned: no inner padding
        for a, b in zip(lp, lj):
            if isinstance(a, tuple):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(hp.coarse_inv, hj.coarse_inv)


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("shape,smooth", [
    ((16, 128), 1), ((16, 128), 0), ((16, 120), 1)])
def test_reference_matches_jax_fused_interpret(shape, smooth, dtype):
    hj, hp = _setups(shape, smooth_levels=smooth)
    fj = jf.fused_vcycle_device(hj, dtype=JAX_DTYPE[dtype])
    fp = fused_vcycle_device(hp, dtype=dtype, device="cpu")
    n = shape[0] * shape[1]
    assert (fp.num_rows, fp.padded_rows) == (fj.num_rows, fj.padded_rows)
    assert fp.offsets == fj.offsets
    r = np.random.default_rng(3).standard_normal(n)
    want = np.asarray(jf.fused_vcycle(fj, jnp.asarray(r, JAX_DTYPE[dtype]),
                                      interpret=True))
    got = fused_vcycle(fp, torch.as_tensor(r, dtype=dtype))
    assert got.shape == (n,) and got.dtype == dtype
    assert _norm_rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("shape", [(32, 512), (64, 16)])
def test_reference_matches_block_vcycle(shape):
    """Three levels (32 x 512), and an offset of 64 rows past the JAX lane
    chunk (64 x 16), which the JAX kernel refuses and the port runs."""
    hj, hp = _setups(shape)
    if shape == (64, 16):
        with pytest.raises(JaxMatrixError, match="lane chunk"):
            jf.fused_vcycle_device(hj)
    fp = fused_vcycle_device(hp, dtype=torch.float64, device="cpu")
    bd = block_amg_device(hp, dtype=torch.float64, device="cpu")
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(
        fp.padded_rows))
    assert _norm_rel(fused_vcycle_reference(fp, b),
                     block_vcycle(bd, b)) <= 1e-12


def test_unaligned_hierarchy_rejected():
    # 4095 rows: block_aggregation_setup pads inside the hierarchy
    hier = block_aggregation_setup(
        CsrMatrix.from_matrix_market(poisson2d(65, 63)))
    with pytest.raises(MatrixError, match="fused-aligned"):
        fused_vcycle_device(hier, device="cpu")


def test_refuses_other_dtypes():
    hp = _setups((16, 128))[1]
    for dt in (torch.bfloat16, torch.float16):
        with pytest.raises(MatrixError, match="float32 or float64"):
            fused_vcycle_device(hp, dtype=dt, device="cpu")


def test_module_holds_natural_order_levels():
    hp = _setups((32, 512))[1]
    fv = fused_vcycle_device(hp, dtype=torch.float64, device="cpu")
    assert isinstance(fv, FusedVcycle)
    assert fv.rows == (16384, 4096, 1024) and fv.coarse.shape == (256, 256)
    for lv, a, d, data, offs in zip(hp.levels, fv.levels, fv.dinv, fv.data,
                                    fv.offsets):
        dense = CsrMatrix(lv.n, lv.n, len(lv.a[2]), 1, *lv.a).to_dense()
        i = np.arange(lv.n)
        for k, off in enumerate(offs):
            ok = (i + off >= 0) & (i + off < lv.n)
            np.testing.assert_array_equal(data[k].numpy()[ok],
                                          dense[i[ok], i[ok] + off])
        np.testing.assert_array_equal(d.numpy(), lv.dinv)
    np.testing.assert_array_equal(fv.coarse.numpy(), hp.coarse_inv)
    assert fv.barrier.tolist() == [0, 0]
    b = torch.ones(fv.padded_rows, dtype=torch.float64)
    torch.testing.assert_close(fv(b), fused_vcycle(fv, b), rtol=0, atol=0)


def test_core_wrapper_on_cpu():
    fv = fused_vcycle_device(_setups((16, 128))[1], dtype=torch.float64,
                             device="cpu")
    b = torch.from_numpy(np.random.default_rng(5).standard_normal(2048))
    before = fused_vcycle_core.launches
    out = torch.empty_like(b)
    y = fused_vcycle_core(fv, b, out=out)
    assert y is out and fused_vcycle_core.launches == before
    torch.testing.assert_close(y, fused_vcycle_reference(fv, b), rtol=0,
                               atol=0)
    with pytest.raises(KernelError, match="shape"):
        fused_vcycle_core(fv, b[:100])
    with pytest.raises(KernelError, match="dtype"):
        fused_vcycle_core(fv, b.float())
    with pytest.raises(KernelError, match="overlap"):
        fused_vcycle_core(fv, b, out=b)


def test_cheb_scalars_follow_the_smoother():
    """K8's host scalars, applied in the smoother's order, give
    ``_cheb_smooth`` bit for bit (on a diagonal operator)."""
    lo, hi, degree = 0.05, 1.6, 4
    rng = np.random.default_rng(6)
    d = torch.from_numpy(rng.uniform(0.5, 2.0, 64))
    dinv = 1.0 / d
    b = torch.from_numpy(rng.standard_normal(64))
    want = _cheb_smooth(lambda v: d * v, dinv, b, torch.zeros(64), lo, hi,
                        degree)
    theta, c1, c2 = pf._cheb_scalars(lo, hi, degree)
    r = dinv * b
    p = r / theta
    x = torch.zeros(64, dtype=torch.float64)
    for s in range(degree):
        x = x + p
        r = r - dinv * (d * p)
        p = c1[s] * p + c2[s] * r
    torch.testing.assert_close(x, want, rtol=0, atol=0)


def test_launch_table_addresses_disjoint_slots():
    """The level table K8 reads: level 0 reads b and writes y, every other
    vector lies inside the scratch buffer, none overlaps another."""
    fv = fused_vcycle_device(_setups((32, 512))[1], dtype=torch.float32,
                             device="cpu")
    at, bc, xc, total = pf._scratch_layout(fv.rows, fv.coarse.shape[0])
    b, y = torch.zeros(fv.padded_rows), torch.zeros(fv.padded_rows)
    scratch = torch.empty(total)
    ptrs, ints, scal = pf._launch_table(fv, b, y, scratch)
    nl = len(fv.levels)
    assert ptrs.size == 8 * nl + 3 and ints.size == 4 * nl
    assert scal.size == nl * (3 + 2 * pf.MAX_DEGREE)
    spans = [(b.data_ptr(), fv.padded_rows), (y.data_ptr(), fv.padded_rows)]
    for lvl, n in enumerate(fv.rows):
        p = ptrs[8 * lvl:8 * lvl + 8]
        assert list(ints[4 * lvl:4 * lvl + 4]) == [
            n, fv.levels[lvl].num_diagonals, int(fv.smoothed[lvl]), 4]
        assert p[0] == fv.levels[lvl].data.data_ptr()
        assert p[2] == fv.dinv[lvl].data_ptr()
        slots = p[5:] if lvl == 0 else p[3:]
        spans += [(int(s), n) for s in slots]
    nc = fv.coarse.shape[0]
    spans += [(int(ptrs[-2]), nc), (int(ptrs[-1]), nc)]
    base, end = scratch.data_ptr(), scratch.data_ptr() + 4 * total
    spans.sort()
    for (s0, n0), (s1, _) in zip(spans, spans[1:]):
        assert s0 + 4 * n0 <= s1
    assert all(base <= s and s + 4 * n <= end for s, n in spans
               if s not in (b.data_ptr(), y.data_ptr()))


def test_preconditioner_info_and_pcg_iterations():
    """info has the JAX keys but the TPU's vmem budget; PCG with the fused
    cycle takes as many iterations as JAX's PCG with its block V-cycle on
    the same hierarchy (the operator K8 computes)."""
    mm = poisson2d(16, 128)
    host = CsrMatrix.from_matrix_market(mm)
    hp = fused_block_setup(host)
    apply, info = fused_vcycle_preconditioner(
        hierarchy=hp, dtype=torch.float64, device="cpu")
    jhost = JaxCsrMatrix.from_matrix_market(jpoisson2d(16, 128))
    _, jinfo = jf.fused_vcycle_preconditioner(jhost, interpret=True)
    assert set(info) == set(jinfo) - {"vmem_limit_bytes"}
    assert info == {k: v for k, v in jinfo.items()
                    if k != "vmem_limit_bytes"}

    b = np.random.default_rng(7).standard_normal(mm.num_rows)
    A = DeviceCsr.from_host(host, dtype=torch.float64)
    res = preconditioned_conjugate_gradient(
        lambda v: spmv(A, v), torch.from_numpy(b), apply, tol=1e-10,
        max_iterations=60)
    hj = jf.fused_block_setup(jhost)
    dj = ja.block_amg_device(hj, dtype=jnp.float64)
    Aj = JaxDeviceCsr.from_host(jhost, dtype=jnp.float64)
    rj = jax_pcg(lambda v: jspmv(Aj, v), jnp.asarray(b),
                 lambda r: ja.block_vcycle(dj, r), tol=1e-10,
                 max_iterations=60)
    assert res.iterations == int(rj.iterations) < 40
    np.testing.assert_allclose(res.x.numpy(), np.asarray(rj.x), rtol=1e-8,
                               atol=1e-10)


def test_preconditioner_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.delenv("SPMV_TPU_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host = CsrMatrix.from_matrix_market(poisson2d(16, 128))
    with pytest.raises(KernelError, match="no CUDA device"):
        fused_vcycle_preconditioner(host)
    monkeypatch.setenv("SPMV_TPU_TORCH_DEVICE", "cpu")
    apply, _ = fused_vcycle_preconditioner(host)
    out = apply(torch.ones(2048))
    assert out.shape == (2048,) and bool(torch.isfinite(out).all())

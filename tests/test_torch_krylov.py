"""The port's GMRES, BiCGSTAB, Chebyshev iteration and Lanczos bounds
against the JAX package's, in fp64 on the CPU.

Both sides get the same host matrix (``tests/_solver_mats.py``: a
non-symmetric banded_random with a dominant diagonal, a 5-point
convection-diffusion stencil, the 2-D Laplacian) and the same right-hand
side from numpy; JAX multiplies through its CSR product, the port through
the CSR kernel's plain version.  Both solvers stop by the same rule, so
iteration counts must be equal; the solutions must agree to rtol 1e-10
(the sums of the two packages run in another order: GMRES's
Gram-Schmidt products over rows 0..j against JAX's masked ones over all
rows, torch's dots against XLA's; the iterates are converged far below
that).  Lanczos bounds are compared at rtol 1e-10: both start from
``np.random.default_rng(seed)``'s vector.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _solver_mats import (
    banded_nonsym,
    convection_diffusion,
    csr_of,
    dense_of,
    poisson,
)

from spmv_tpu.models import CsrMatrix as JaxCsr
from spmv_tpu.models.device import DeviceCsr as JaxDeviceCsr
from spmv_tpu import ops as jops
from spmv_tpu_torch import ops
from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.models import CsrMatrix, DeviceCsr
from spmv_tpu_torch.models.device import DEVICE_ENV

MATRICES = {"banded_random": banded_nonsym, "convdiff": convection_diffusion}


@pytest.fixture(autouse=True)
def _fp64(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")   # the entry points' device
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _system(coo, seed=5):
    """(JAX matvec, port matvec, b as numpy, JAX host CSR, port host CSR)."""
    jh, th = csr_of(coo, JaxCsr), csr_of(coo, CsrMatrix)
    Aj, At = JaxDeviceCsr.from_host(jh), DeviceCsr.from_host(th)
    b = np.random.default_rng(seed).standard_normal(coo[0])
    return (lambda v: jops.spmv(Aj, v), lambda v: ops.spmv(At, v), b,
            jh, th)


def _same(jres, tres, rtol=1e-10):
    assert int(jres.iterations) == tres.iterations
    want = np.asarray(jres.x)
    got = tres.x.numpy()
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()
    np.testing.assert_allclose(float(tres.residual_norm),
                               float(jres.residual_norm), rtol=1e-6)


def _ilu0(jh, th):
    Lj, Uj = jops.ilu0_factor(jh)
    Lt, Ut = ops.ilu0_factor(th)
    return (jops.ilu0_preconditioner(Lj, Uj, method="levels")[0],
            ops.ilu0_preconditioner(Lt, Ut, method="levels")[0])


@pytest.mark.parametrize("precond", ["none", "ilu0"])
@pytest.mark.parametrize("restart", [1, 5, 32])
@pytest.mark.parametrize("matrix", list(MATRICES))
def test_gmres_matches_jax(matrix, restart, precond):
    mj, mt, b, jh, th = _system(MATRICES[matrix]())
    pj, pt = _ilu0(jh, th) if precond == "ilu0" else (None, None)
    kw = dict(tol=1e-10, restart=restart, max_iterations=400)
    jres = jops.gmres(mj, jnp.asarray(b), preconditioner=pj, **kw)
    tres = ops.gmres(mt, torch.from_numpy(b), preconditioner=pt, **kw)
    _same(jres, tres)
    assert tres.iterations > 0


@pytest.mark.parametrize("precond", ["none", "jacobi", "ilu0"])
@pytest.mark.parametrize("matrix", list(MATRICES))
def test_bicgstab_matches_jax(matrix, precond):
    coo = MATRICES[matrix]()
    mj, mt, b, jh, th = _system(coo)
    if precond == "jacobi":
        diag = jops.extract_diagonal(jh)
        np.testing.assert_array_equal(ops.extract_diagonal(th), diag)
        pj = jops.jacobi_preconditioner(jnp.asarray(diag))
        pt = ops.jacobi_preconditioner(torch.from_numpy(diag))
    elif precond == "ilu0":
        pj, pt = _ilu0(jh, th)
    else:
        pj = pt = None
    kw = dict(tol=1e-10, max_iterations=400)
    jres = jops.bicgstab(mj, jnp.asarray(b), preconditioner=pj, **kw)
    tres = ops.bicgstab(mt, torch.from_numpy(b), preconditioner=pt, **kw)
    _same(jres, tres)


def test_bicgstab_breakdown_keeps_the_iterate():
    """r = 0 after one step on a diagonal system (omega = 0): both stop
    at the breakdown test, with the same iterate."""
    coo = (3, np.arange(3), np.arange(3), np.array([2.0, 2.0, 2.0]))
    mj, mt, b, _, _ = _system(coo)
    jres = jops.bicgstab(mj, jnp.asarray(b), tol=0.0, max_iterations=50)
    tres = ops.bicgstab(mt, torch.from_numpy(b), tol=0.0,
                        max_iterations=50)
    assert int(jres.iterations) == tres.iterations < 50
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               rtol=1e-15)


@pytest.mark.parametrize("seed,steps", [(0, 30), (3, 12)])
def test_lanczos_bounds_match_jax(seed, steps):
    mj, mt, _, jh, _ = _system(poisson())
    kw = dict(num_steps=steps, seed=seed)
    want = jops.lanczos_bounds(mj, jh.num_rows, dtype=jnp.float64, **kw)
    got = ops.lanczos_bounds(mt, jh.num_rows, dtype=torch.float64, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-10)
    if steps >= 30:
        # enough steps for the widened Ritz extremes to enclose it
        lam = np.linalg.eigvalsh(dense_of(poisson()))
        assert got[0] <= lam[0] and got[1] >= lam[-1]


@pytest.mark.parametrize("check_every", [20, 7])
@pytest.mark.parametrize("matrix", ["poisson", "convdiff_symmetric"])
def test_chebyshev_matches_jax(matrix, check_every):
    coo = poisson() if matrix == "poisson" else convection_diffusion(
        12, 18, wind=0.0)
    mj, mt, b, jh, _ = _system(coo)
    lo, hi = jops.lanczos_bounds(mj, jh.num_rows, dtype=jnp.float64)
    kw = dict(tol=1e-10, max_iterations=2000, check_every=check_every)
    jres = jops.chebyshev(mj, jnp.asarray(b), lo, hi, **kw)
    tres = ops.chebyshev(mt, torch.from_numpy(b), lo, hi, **kw)
    _same(jres, tres)
    assert tres.iterations % check_every == 0


def test_chebyshev_single_eigenvalue_is_richardson():
    """lambda_min == lambda_max on 3 I: the exact step, converged at the
    first check."""
    coo = (8, np.arange(8), np.arange(8), np.full(8, 3.0))
    mj, mt, b, _, _ = _system(coo)
    jres = jops.chebyshev(mj, jnp.asarray(b), 3.0, 3.0, tol=1e-12)
    tres = ops.chebyshev(mt, torch.from_numpy(b), 3.0, 3.0, tol=1e-12)
    _same(jres, tres, rtol=1e-15)
    assert tres.iterations == 20
    np.testing.assert_allclose(tres.x.numpy(), b / 3.0, rtol=1e-15)


def test_gmres_one_step_on_a_scaled_identity():
    coo = (10, np.arange(10), np.arange(10), np.full(10, 2.0))
    mj, mt, b, _, _ = _system(coo)
    jres = jops.gmres(mj, jnp.asarray(b), tol=1e-12)
    tres = ops.gmres(mt, torch.from_numpy(b), tol=1e-12)
    _same(jres, tres)
    assert tres.iterations == 1


@pytest.mark.parametrize("call", [
    lambda mv, b: ops.gmres(mv, b, restart=0),
    lambda mv, b: ops.chebyshev(mv, b, 0.0, 1.0),
    lambda mv, b: ops.chebyshev(mv, b, 2.0, 1.0),
], ids=["gmres_restart_0", "chebyshev_zero_floor", "chebyshev_reversed"])
def test_refusals_match_jax(call):
    """The port raises ValueError where the JAX functions do."""
    _, mt, b, _, _ = _system(poisson(4, 4))
    with pytest.raises(ValueError):
        call(mt, torch.from_numpy(b))


@pytest.mark.parametrize("entry", ["ic0_preconditioner",
                                   "ilu0_preconditioner", "lanczos_bounds",
                                   "iterative_refinement"])
def test_entry_points_need_a_card_or_the_cpu(entry, monkeypatch):
    """Without ``device=`` the entry points put their factors and vectors
    on ``default_device()``: the card, which raises where there is none,
    unless the CPU is asked for."""
    _, mt, b, _, th = _system(poisson())
    n = th.num_rows

    def call():
        if entry == "ic0_preconditioner":
            apply, _ = ops.ic0_preconditioner(ops.ic0_factor(th),
                                              method="levels")
            return apply(torch.ones(n))
        if entry == "ilu0_preconditioner":
            apply, _ = ops.ilu0_preconditioner(*ops.ilu0_factor(th),
                                               method="levels")
            return apply(torch.ones(n))
        if entry == "lanczos_bounds":
            seen = []
            ops.lanczos_bounds(lambda v: seen.append(v.device) or mt(v), n,
                               num_steps=5, dtype=torch.float64)
            return torch.empty(0, device=seen[0])
        seen = []
        ops.iterative_refinement(
            th, b, lambda r: seen.append(r.device) or r, tol=1e-12,
            max_refinements=1)
        return torch.empty(0, device=seen[0])

    monkeypatch.delenv(DEVICE_ENV)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KernelError, match="no CUDA device"):
        call()
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert call().device == torch.device("cpu")

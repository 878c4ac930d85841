"""The port's mixed-precision iterative refinement against the JAX
package's, on the CPU.

Both run the same fp64 host loop around an inner solve in float32.
With an inner solve that rounds the same way in both packages (one
Jacobi step, d = r / diag(A) elementwise in float32) the two runs are the
same arithmetic: equal refinements and inner iterations, x at rtol 1e-12
(bitwise in practice).  With float32 CG as the inner solve (the JAX
package's CSR product and dots against the port's plain CSR kernel and
torch's dots, summed in another order) the refinements must be equal and
both results must reach the fp64 tolerance; x then agrees to the
tolerance's reach, rtol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _solver_mats import banded_nonsym, csr_of, poisson

from spmv_tpu import ops as jops
from spmv_tpu.models import CsrMatrix as JaxCsr
from spmv_tpu.models.device import DeviceCsr as JaxDeviceCsr
from spmv_tpu_torch import ops
from spmv_tpu_torch.models import CsrMatrix, DeviceCsr
from spmv_tpu_torch.models.device import DEVICE_ENV


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")   # iterative_refinement's device


def _jacobi_inner(diag, jax_side):
    """One Jacobi step in float32, as a CgResult-like result (1 inner
    iteration)."""
    class Res:
        def __init__(self, x):
            self.x, self.iterations = x, 1

    if jax_side:
        d32 = jnp.asarray(diag, jnp.float32)
        return lambda r: Res(r / d32)
    t32 = torch.from_numpy(diag).to(torch.float32)
    return lambda r: Res(r / t32)


@pytest.mark.parametrize("matrix", ["banded_random", "poisson"])
def test_refinement_matches_jax_same_arithmetic(matrix):
    if matrix == "banded_random":
        # the diagonal 4x dominant: each Jacobi pass cuts the error 4x
        n, rows, cols, vals = banded_nonsym(500, 12, 5, seed=21)
        coo = (n, rows, cols, np.where(rows == cols, 4 * vals, vals))
    else:
        coo = poisson(10, 9)
    jh, th = csr_of(coo, JaxCsr), csr_of(coo, CsrMatrix)
    diag = ops.extract_diagonal(th)
    b = np.random.default_rng(22).standard_normal(coo[0])
    kw = dict(tol=1e-12, max_refinements=200)
    want = jops.iterative_refinement(jh, b, _jacobi_inner(diag, True), **kw)
    got = ops.iterative_refinement(th, b, _jacobi_inner(diag, False), **kw)
    assert got.refinements == want.refinements > 1
    assert got.inner_iterations == want.inner_iterations
    np.testing.assert_allclose(got.x, want.x, rtol=1e-12)
    assert got.residual_norm == pytest.approx(want.residual_norm,
                                              rel=1e-6, abs=1e-300)
    if matrix == "banded_random":
        assert got.residual_norm <= 1e-12 * np.linalg.norm(b)


def test_refinement_with_float32_cg_matches_jax():
    coo = poisson(14, 12)
    jh, th = csr_of(coo, JaxCsr), csr_of(coo, CsrMatrix)
    Aj = JaxDeviceCsr.from_host(jh, dtype=jnp.float32)
    At = DeviceCsr.from_host(th, dtype=torch.float32)
    b = np.random.default_rng(23).standard_normal(coo[0])

    def inner_j(r):
        return jops.conjugate_gradient(lambda v: jops.spmv(Aj, v), r,
                                       tol=1e-4, max_iterations=500)

    def inner_t(r):
        return ops.conjugate_gradient(lambda v: ops.spmv(At, v), r,
                                      tol=1e-4, max_iterations=500)

    want = jops.iterative_refinement(jh, b, inner_j, tol=1e-12)
    got = ops.iterative_refinement(th, b, inner_t, tol=1e-12)
    assert got.refinements == want.refinements > 1
    assert abs(got.inner_iterations - want.inner_iterations) <= \
        got.refinements
    bn = np.linalg.norm(b)
    assert got.residual_norm <= 1e-12 * bn >= want.residual_norm
    np.testing.assert_allclose(got.x, want.x, rtol=1e-9)


def test_refinement_stagnation_and_callable_operator():
    """A callable operator; an inner solve that never helps stops at the
    stagnation test after one pass and returns the best iterate (x = 0),
    as in JAX."""
    coo = poisson(6, 5)
    th = csr_of(coo, CsrMatrix)
    b = np.ones(coo[0])

    def useless(r):
        return torch.zeros_like(r)

    got = ops.iterative_refinement(th.spmv, b, useless, tol=1e-12)
    want = jops.iterative_refinement(csr_of(coo, JaxCsr).spmv, b,
                                     lambda r: jnp.zeros_like(r), tol=1e-12)
    assert (got.refinements, got.inner_iterations) == (
        want.refinements, want.inner_iterations) == (1, 0)
    np.testing.assert_array_equal(got.x, np.zeros_like(b))
    assert got.residual_norm == want.residual_norm == np.linalg.norm(b)
    with pytest.raises(TypeError, match="spmv"):
        ops.iterative_refinement(object(), b, useless)

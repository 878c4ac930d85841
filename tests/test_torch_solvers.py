"""The port's DIA conjugate gradient against the JAX package's.

Same system as tests/test_ops.py::test_dia_conjugate_gradient_padded_
fast_path: poisson2d(16, 16), b = A x_true for a seeded x_true, fp64.
JAX runs ``dia_conjugate_gradient(path="pallas", interpret=True)`` (the
Pallas kernel loop) or ``path="xla"``; the port runs the same variant on
CPU tensors (its plain versions).  Both use the same stopping rule, so
the iteration counts are required to agree to within one: the dots are
summed in another order (XLA's and torch's reductions), which can move
r.r across tol^2 one iteration earlier or later, but no further.  The
solutions must agree to rtol 1e-9 (the tolerance is 1e-12 relative, so
both are converged far below that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.io.generate import poisson2d
from spmv_tpu.models import DiaMatrix as JaxDiaMatrix
from spmv_tpu.models.device import DeviceDia as JaxDeviceDia
from spmv_tpu.ops import dia_conjugate_gradient as jax_dia_cg
from spmv_tpu.ops import extract_diagonal as jax_extract_diagonal
from spmv_tpu_torch.models import DeviceDia, DiaMatrix
from spmv_tpu_torch.ops import dia_conjugate_gradient, extract_diagonal

VARIANTS = {
    "fused": dict(path="pallas", fused=True),
    "unfused": dict(path="pallas", fused=False),
    "jacobi": dict(path="pallas", jacobi=True),
    "recompute_10": dict(path="pallas", recompute_every=10),
    "xla_jacobi": dict(path="xla", jacobi=True),
}


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


@pytest.fixture(scope="module")
def system():
    # the port's host matrix, and the JAX package's for the JAX side
    mm = poisson2d(16, 16)
    host = DiaMatrix.from_matrix_market(mm)
    x_true = np.random.default_rng(8).standard_normal(host.num_rows)
    return (host, x_true, host.spmv(x_true),
            JaxDiaMatrix.from_matrix_market(mm))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_dia_cg_matches_jax(variant, system):
    host, x_true, b, jhost = system
    kw = dict(VARIANTS[variant])
    jacobi = kw.pop("jacobi", False)
    diag = extract_diagonal(host) if jacobi else None
    if jacobi:
        np.testing.assert_array_equal(diag, jax_extract_diagonal(jhost))

    Aj = JaxDeviceDia.from_host(jhost)
    want = jax.jit(lambda b: jax_dia_cg(
        Aj, b, tol=1e-12, max_iterations=2000, interpret=True,
        jacobi_diag=diag, **kw))(jnp.asarray(b))

    A = DeviceDia.from_host(host)
    got = dia_conjugate_gradient(
        A, torch.from_numpy(b), tol=1e-12, max_iterations=2000,
        jacobi_diag=diag, **kw)

    assert abs(got.iterations - int(want.iterations)) <= 1
    assert got.iterations < 2000
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.x.numpy(), x_true, rtol=1e-6,
                               atol=1e-8)


def test_dia_cg_guards(system):
    host, _, b, _ = system
    A = DeviceDia.from_host(host)
    with pytest.raises(ValueError):
        dia_conjugate_gradient(A, torch.from_numpy(b), recompute_every=-1)
    with pytest.raises(ValueError):
        dia_conjugate_gradient(A, torch.from_numpy(b), path="bogus")


def test_cg_breakdown_runs_fixed_iterations():
    """The CG breakdown tool times both dot variants and traces a solve
    and a K1 chain; on the CPU there is no device time to find."""
    from spmv_tpu_torch.profile.cg_breakdown import breakdown

    lines = []
    got = breakdown(8, 3, torch.device("cpu"), say=lines.append)
    assert got["cg_fused=True"] > 0 and got["cg_fused=False"] > 0
    for name in ("cg_8", "k1_chain_8"):
        assert got[name]["wall_s"] > 0
        assert got[name]["device_s"] == 0
    assert any(s.startswith("CG poisson2d(8) fused=False") for s in lines)

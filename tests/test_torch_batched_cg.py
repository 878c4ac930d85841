"""The port's batched multi-RHS CG against the JAX package's.

The system is poisson2d(16, 16) with B = A X_true for a seeded X_true of
three columns at different scales, fp64, through ``DeviceWellCw``,
``DeviceWell``, ``DeviceBsr`` and ``DeviceDia`` (the JAX tests' own
system, tests/test_ops.py:221-339).
JAX runs ``batched_conjugate_gradient`` over its XLA ``spmm`` (or
``dia_batched_conjugate_gradient(path="xla")``); the port runs the same
recurrence on CPU tensors (its plain versions).  Both stop each column
by the same rule, so per-column iteration counts must agree to within
one: the dots are summed in another order, which can move a column's
r.r across tol^2 one iteration earlier or later, but no further
(tests/test_ops.py:244-248 allows the same).  Solutions agree to rtol
1e-9 (the tolerance is 1e-12 relative, so both are converged far below
that).  The CLI's ``--cg N --nrhs K`` is held against the JAX CLI on the
same Matrix Market file.
"""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.cli import main as jax_main
from spmv_tpu.io import write_matrix_market
from spmv_tpu.io.generate import poisson2d
from spmv_tpu.models import BsrMatrix, DiaMatrix, WellCwMatrix, WellMatrix
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import batched_conjugate_gradient as jax_batched_cg
from spmv_tpu.ops import dia_batched_conjugate_gradient as jax_dia_batched
from spmv_tpu.ops import extract_diagonal, jacobi_preconditioner
from spmv_tpu.ops import spmm as jspmm
from spmv_tpu_torch.cli import main
from spmv_tpu_torch.models import BsrMatrix as PortBsrMatrix
from spmv_tpu_torch.models import DeviceBsr, DeviceDia, DeviceWell, DeviceWellCw
from spmv_tpu_torch.models import DiaMatrix as PortDiaMatrix
from spmv_tpu_torch.models import WellCwMatrix as PortWellCwMatrix
from spmv_tpu_torch.models import WellMatrix as PortWellMatrix
from spmv_tpu_torch.ops import (
    batched_conjugate_gradient,
    dia_batched_conjugate_gradient,
    dia_spmm_core,
    spmm,
    wellcw_merged_spmm_core,
)

TOL = 1e-12
MAX_IT = 2000


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
    mm = poisson2d(16, 16)
    dia = DiaMatrix.from_matrix_market(mm)
    X_true = np.random.default_rng(11).standard_normal((mm.num_rows, 3))
    X_true[:, 1] *= 100.0           # different scales per column
    B = np.stack([dia.spmv(X_true[:, j]) for j in range(3)], axis=1)
    return {"mm": mm, "dia": dia,
            "wellcw": WellCwMatrix.from_matrix_market(mm),
            "well": WellMatrix.from_matrix_market(mm),
            "bsr": BsrMatrix.from_matrix_market(mm),
            # the port's own host matrices, for the port's containers
            "port": {"dia": PortDiaMatrix.from_matrix_market(mm),
                     "wellcw": PortWellCwMatrix.from_matrix_market(mm),
                     "well": PortWellMatrix.from_matrix_market(mm),
                     "bsr": PortBsrMatrix.from_matrix_market(mm)},
            "X_true": X_true, "B": B, "diag": extract_diagonal(dia)}


CONTAINERS = {"dia": (jdev.DeviceDia, DeviceDia),
              "wellcw": (jdev.DeviceWellCw, DeviceWellCw),
              "well": (jdev.DeviceWell, DeviceWell),
              "bsr": (jdev.DeviceBsr, DeviceBsr)}


def _operators(system, fmt):
    jcls, cls = CONTAINERS[fmt]
    return (jcls.from_host(system[fmt]),
            cls.from_host(system["port"][fmt], device="cpu"))


def _same_solve(got, want, X_true):
    assert got.x.shape == X_true.shape
    assert got.residual_norm.shape == (X_true.shape[1],)
    assert got.iterations.shape == (X_true.shape[1],)
    its, jits = got.iterations.numpy(), np.asarray(want.iterations)
    assert np.abs(its - jits).max() <= 1, (its, jits)
    assert (its > 0).all() and (its < MAX_IT).all()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-9, atol=1e-9 * np.abs(X_true).max())
    np.testing.assert_allclose(got.x.numpy(), X_true, rtol=1e-6,
                               atol=1e-6 * np.abs(X_true).max())


@pytest.mark.parametrize("variant", ["plain", "jacobi_recompute_10"])
@pytest.mark.parametrize("fmt", ["wellcw", "dia", "well", "bsr"])
def test_batched_cg_matches_jax(fmt, variant, system):
    Aj, At = _operators(system, fmt)
    B, diag = system["B"], system["diag"]
    kw = {}
    jprecond = precond = None
    if variant == "jacobi_recompute_10":
        kw = {"recompute_every": 10}
        jprecond = jacobi_preconditioner(jnp.asarray(diag)[:, None])
        inv = torch.from_numpy(1.0 / diag)[:, None]

        def precond(R):
            return R * inv
    want = jax_batched_cg(lambda V: jspmm(Aj, V), jnp.asarray(B),
                          preconditioner=jprecond, tol=TOL,
                          max_iterations=MAX_IT, **kw)
    got = batched_conjugate_gradient(lambda V: spmm(At, V),
                                     torch.from_numpy(B),
                                     preconditioner=precond, tol=TOL,
                                     max_iterations=MAX_IT, **kw)
    _same_solve(got, want, system["X_true"])


@pytest.mark.parametrize("fmt", ["wellcw", "dia", "well", "bsr"])
def test_batched_cg_zero_column_takes_no_iteration(fmt, system):
    """A zero right-hand side is never active: 0 iterations, x = 0,
    while the other column converges (tests/test_ops.py:251-270)."""
    Aj, At = _operators(system, fmt)
    B = np.stack([system["B"][:, 0], np.zeros(system["B"].shape[0])], 1)
    want = jax_batched_cg(lambda V: jspmm(Aj, V), jnp.asarray(B), tol=1e-10,
                          max_iterations=MAX_IT)
    got = batched_conjugate_gradient(lambda V: spmm(At, V),
                                     torch.from_numpy(B), tol=1e-10,
                                     max_iterations=MAX_IT)
    assert int(got.iterations[1]) == int(want.iterations[1]) == 0
    assert abs(int(got.iterations[0]) - int(want.iterations[0])) <= 1
    assert int(got.iterations[0]) > 0
    assert bool((got.x[:, 1] == 0).all())
    np.testing.assert_allclose(got.x[:, 0].numpy(), system["X_true"][:, 0],
                               rtol=1e-6, atol=1e-8)


def test_batched_cg_guards(system):
    _, At = _operators(system, "wellcw")
    B = torch.from_numpy(system["B"])
    with pytest.raises(ValueError, match="recompute_every"):
        batched_conjugate_gradient(lambda V: spmm(At, V), B,
                                   recompute_every=-1)
    _, Ad = _operators(system, "dia")
    with pytest.raises(ValueError, match="recompute_every"):
        dia_batched_conjugate_gradient(Ad, B, recompute_every=-1)
    with pytest.raises(ValueError, match="num_rows, k"):
        dia_batched_conjugate_gradient(Ad, B[:, 0])


@pytest.mark.parametrize("variant", ["plain", "jacobi", "recompute_25",
                                     "jacobi_recompute_25"])
def test_dia_batched_cg_matches_jax_xla(variant, system):
    """The DIA batched solver against JAX's ``path="xla"``: on a CPU
    tensor its loop runs ``dia_spmm_core``'s plain version, and launches
    no kernel."""
    Aj, At = _operators(system, "dia")
    B = system["B"]
    diag = system["diag"] if "jacobi" in variant else None
    rec = 25 if "recompute" in variant else 0
    want = jax_dia_batched(Aj, jnp.asarray(B), tol=TOL,
                           max_iterations=MAX_IT, jacobi_diag=diag,
                           path="xla", recompute_every=rec)
    before = dia_spmm_core.launches
    got = dia_batched_conjugate_gradient(
        At, torch.from_numpy(B), tol=TOL, max_iterations=MAX_IT,
        jacobi_diag=diag, recompute_every=rec)
    assert dia_spmm_core.launches == before     # CPU: no kernel launched
    _same_solve(got, want, system["X_true"])


@pytest.fixture(scope="module")
def poisson_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("nrhs") / "poisson16.mtx"
    write_matrix_market(poisson2d(16, 16), str(p))
    return str(p)


def _run(fn, argv):
    out = io.StringIO()
    rc = fn(argv, out=out)
    return rc, out.getvalue()


@pytest.mark.parametrize("precond", ["none", "jacobi"])
@pytest.mark.parametrize("fmt", ["dia", "wellcw", "well", "bsr"])
def test_cli_nrhs_matches_jax_cli(fmt, precond, poisson_file):
    argv = ["--matrix", poisson_file, "--cg", "200", "--cg-tol", "1e-10",
            "--nrhs", "3", "--precondition", precond]
    rc, text = _run(main, argv + ["--spmv-format", fmt])
    assert rc == 0
    doc = json.loads(text)
    # the JAX CLI cannot run Jacobi on WELL-CW, WELL or BSR (no diagonal
    # there): hold those cases against its DIA run on the same file, the
    # same recurrence
    jfmt = "dia" if precond == "jacobi" else fmt
    jrc, jtext = _run(jax_main, argv + ["--spmv-format", jfmt])
    assert jrc == 0
    want = json.loads(jtext)
    assert set(doc) == set(want)
    assert set(doc["cg"]) == set(want["cg"])
    cg, jcg = doc["cg"], want["cg"]
    assert cg["nrhs"] == 3 and cg["preconditioner"] == precond
    assert len(cg["iterations"]) == len(cg["residual_norms"]) == 3
    assert max(abs(a - b) for a, b in
               zip(cg["iterations"], jcg["iterations"])) <= 1
    assert max(cg["solution_rms_error_vs_ones"]) < 1e-8
    assert cg["device"] == "cpu"
    if jfmt == fmt:
        assert doc["kernel"] == want["kernel"]


def test_cli_wellcw_spmm_matches_jax_cli(poisson_file):
    argv = ["--matrix", poisson_file, "--spmv-format", "wellcw",
            "--profile", "2", "--spmm", "3"]
    before = wellcw_merged_spmm_core.launches
    rc, text = _run(main, argv)
    assert rc == 0
    assert wellcw_merged_spmm_core.launches == before   # CPU: plain only
    doc = json.loads(text)
    jrc, jtext = _run(jax_main, argv)
    assert jrc == 0
    want = json.loads(jtext)
    assert set(doc) == set(want)
    for sub in ("achieved", "roofline", "device"):
        assert set(doc[sub]) == set(want[sub]), sub
    assert doc["op"] == want["op"] == {"kind": "spmm", "k": 3}
    assert doc["kernel"] == want["kernel"]
    assert doc["device"]["platform"] == "cpu"
    assert doc["achieved"]["gflop_per_s"] > 0

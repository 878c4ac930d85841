"""The port's CLI solvers against the JAX CLI's, in fp64 on the CPU.

Every ``--solver`` x ``--precondition`` pair the JAX CLI takes runs in
both CLIs (in process) on poisson2d(32, 32) and, for the solvers and
preconditioners of non-symmetric systems, on a banded_random(1024) with
a dominant diagonal (``tests/_solver_mats.py``), on ``-s csr``
(``--reorder color``, ``--restart`` and ``-s dia`` in a few cases).
The reports must have the same keys, the same iteration counts,
factorization and spectral-bound entries (bounds at rtol 1e-10), and
residual norms within 1e-4 relative (BiCGSTAB's last residual moves by
~1e-5 of itself with the order of the sums at this size).  The refusals (Chebyshev with a preconditioner,
``--recompute-residual`` on a solver other than CG, an incomplete
factorization of a matrix ``-s auto`` converted) exit 1 with the JAX
CLI's message.
"""

import io
import json

import numpy as np
import pytest
import torch
from _solver_mats import banded_nonsym

from spmv_tpu.cli import main as jax_main
from spmv_tpu_torch.cli import main
from spmv_tpu_torch.io import write_matrix_market
from spmv_tpu_torch.io.generate import from_coo_arrays, poisson2d
from spmv_tpu_torch.models.device import DEVICE_ENV

PRECONDITIONERS = ("none", "jacobi", "ic0", "ic0-sweeps", "ilu0",
                   "ilu0-sweeps", "amg")
# the preconditioners of a non-symmetric system: IC(0) and SA-AMG
# assume an SPD matrix, and on banded_random BiCGSTAB's iteration counts
# with them follow the rounding (the residual wanders at ~1e3 for
# hundreds of iterations)
NONSYMMETRIC = ("none", "jacobi", "ilu0", "ilu0-sweeps")
PAIRS = ([("cg", p) for p in PRECONDITIONERS]
         + [("bicgstab", p) for p in PRECONDITIONERS]
         + [("gmres", p) for p in PRECONDITIONERS]
         + [("chebyshev", "none")])
CASES = ([("poisson", s, p, []) for s, p in PAIRS]
         + [("banded_random", s, p, []) for s, p in PAIRS
            if s in ("bicgstab", "gmres") and p in NONSYMMETRIC]
         + [("poisson", "gmres", "ilu0", ["--restart", "5"]),
            ("poisson", "bicgstab", "ilu0", ["--reorder", "color"]),
            ("poisson", "cg", "ic0", ["-s", "dia", "--reorder", "color"]),
            ("banded_random", "gmres", "ilu0-sweeps", ["-s", "dia"])])


@pytest.fixture(autouse=True)
def _fp64(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("solver_cli")
    paths = {"poisson": str(d / "poisson32.mtx"),
             "banded_random": str(d / "banded1024.mtx")}
    write_matrix_market(poisson2d(32, 32), paths["poisson"])
    n, rows, cols, vals = banded_nonsym(1024, 24, 6, seed=31)
    write_matrix_market(from_coo_arrays(n, n, rows, cols, vals),
                        paths["banded_random"])
    return paths


def _run(fn, argv):
    out = io.StringIO()
    rc = fn(argv, out=out)
    return rc, (json.loads(out.getvalue()) if rc == 0 else None)


@pytest.mark.parametrize(
    "matrix,solver,precond,extra", CASES,
    ids=[f"{m}-{s}-{p}" + "".join(e).replace("-", "_")
         for m, s, p, e in CASES])
def test_solver_matches_jax_cli(matrix, solver, precond, extra, files):
    argv = (["--matrix", files[matrix], "-s", "csr", "--cg", "400",
             "--cg-tol", "1e-8", "--solver", solver, "--precondition",
             precond] + extra)
    jrc, want = _run(jax_main, argv)
    rc, got = _run(main, argv)
    assert rc == jrc == 0
    assert set(got) == set(want) and set(got["cg"]) == set(want["cg"])
    g, w = got["cg"], want["cg"]
    assert g["iterations"] == w["iterations"] > 0
    assert g["residual_norm"] == pytest.approx(w["residual_norm"], rel=1e-4)
    assert g.get("factorization") == w.get("factorization")
    assert g.get("restart") == w.get("restart")
    if solver == "chebyshev":
        np.testing.assert_allclose(
            [g["spectral_bounds"]["lambda_min"],
             g["spectral_bounds"]["lambda_max"]],
            [w["spectral_bounds"]["lambda_min"],
             w["spectral_bounds"]["lambda_max"]], rtol=1e-10)
    if w["solution_rms_error_vs_ones"] < 1e-4:
        assert g["solution_rms_error_vs_ones"] < 1e-4
    assert got["kernel"] == want["kernel"]


@pytest.mark.parametrize("extra,message", [
    (["--solver", "chebyshev", "--precondition", "jacobi"],
     "does not take a preconditioner"),
    (["--solver", "gmres", "--recompute-residual", "5"],
     "--recompute-residual applies to --solver cg only"),
    (["-s", "auto", "--precondition", "ic0"], "needs a CSR view"),
    (["--solver", "bicgstab", "--nrhs", "2"], "--nrhs applies"),
], ids=["chebyshev_precond", "recompute_gmres", "auto_ic0", "nrhs_bicgstab"])
def test_solver_refusals_match_jax_cli(extra, message, files, capsys):
    argv = ["--matrix", files["poisson"], "--cg", "50"] + extra
    jrc, _ = _run(jax_main, argv)
    jerr = capsys.readouterr().err
    rc, _ = _run(main, argv)
    err = capsys.readouterr().err
    assert rc == jrc == 1
    assert message in err and message in jerr
    assert err.replace("spmv-tpu-torch:", "spmv-tpu:") == jerr

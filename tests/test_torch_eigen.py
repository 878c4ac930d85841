"""The port's block LOBPCG (``spmv_tpu_torch/ops/eigen.py``), the block
apply of its AMG V-cycle and the CLI's ``--eigs``, against the JAX
package.

The same numpy-seeded inputs go through both packages in float64 (the
JAX tests run with x64 on, tests/conftest.py):

- ``lobpcg`` step for step: the same X0, and JAX's own draw of the
  random P block (``jax.random.PRNGKey(0)``) passed as ``P0``, all at
  ``tol = 1e-5`` (``STEP_TOL``).  The two run the same arithmetic in
  another framework, and neither locks converged columns: a column at
  float64's floor feeds its rounding noise, normalised to unit length,
  into the basis, so once columns reach the floor the two trajectories,
  which round differently, separate by about 1e-8 (measured).  At 1e-5
  every case's stopping test is crossed before that matters: the
  iteration counts are equal, the eigenvalues agree at rtol 1e-10, the
  residual norms lie under the stopping threshold ``tol * max(max
  |theta|, 1)`` in both and agree within it (a column that reached the
  floor early carries that noise to the end: 3.7e-3 against 3.1e-3
  under a 4.1e-3 threshold in the Jacobi case, whose ||A|| is 1e4), and
  the eigenvectors up to each column's sign
  at atol 1e-6 (a 1e-8 separation over these spectra's gaps), or, where
  the spectrum repeats, as subspaces (their projectors).  At 1e-6 and
  below the counts of some cases differ by one or two (measured: 71
  against 70 at poisson2d(12, 12), smallest, 1e-6).
- the block AMG apply against the vector apply column by column and
  against JAX's ``vmap`` of it (rtol 1e-12: rounding order only);
- the CLI against the JAX CLI on the same file on every format, the
  eigenvalues at rtol 1e-8 with ``--eigs-tol 1e-9``.  The start blocks
  differ (a ``torch.Generator`` against ``jax.random``), so iteration
  counts are not compared.
"""

import importlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.cli import main as jax_main
from spmv_tpu.io.generate import poisson2d as jpoisson2d
from spmv_tpu.io.matrix_market import write_matrix_market
from spmv_tpu.models import CsrMatrix as JaxCsrMatrix
from spmv_tpu.models import DiaMatrix as JaxDiaMatrix
from spmv_tpu.models.device import DeviceDia as JaxDeviceDia
from spmv_tpu.ops import amg_preconditioner as jax_amg_preconditioner
from spmv_tpu.ops import lobpcg as jax_lobpcg
from spmv_tpu.ops.spmv import spmm as jspmm
from spmv_tpu_torch.cli import main
from spmv_tpu_torch.io.generate import poisson2d
from spmv_tpu_torch.models import CsrMatrix, DeviceDia, DiaMatrix
from spmv_tpu_torch.ops import (
    EigResult,
    amg_preconditioner,
    dia_eigsh,
    lobpcg,
    spmm,
)

STEP_TOL = 1e-5         # lobpcg's tol in the step-for-step comparisons
RTOL = 1e-10            # eigenvalues, float64
VEC_ATOL = 1e-6         # eigenvectors up to sign, and projectors
CLI_RTOL = 1e-8


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


@pytest.fixture(autouse=True)
def _jax_python_aggregation(monkeypatch):
    # the JAX package's native loader rebuilds csrc/build/libamg.so, a
    # committed file, when the source looks newer; its Python loop gives
    # the same aggregates (tests/test_torch_amg.py holds them in lockstep)
    monkeypatch.setattr(importlib.import_module("spmv_tpu.ops._amg_native"),
                        "available", lambda: False)


def _poisson_eigs(nx, ny):
    i = np.arange(1, nx + 1)
    j = np.arange(1, ny + 1)
    lam = (4.0 - 2.0 * np.cos(i * np.pi / (nx + 1))[:, None]
           - 2.0 * np.cos(j * np.pi / (ny + 1))[None, :])
    return np.sort(lam.reshape(-1))


def _jax_p(n, k):
    """The JAX function's random P block (``_lobpcg_impl``)."""
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (n, k),
                                      jnp.float64))


def _dense_spd(n, seed):
    M = np.random.default_rng(seed).standard_normal((n, n))
    return M @ M.T + n * np.eye(n)


def _operators(case):
    """(n, JAX matmat, port matmat) of a case: a dense SPD matrix, or a
    DIA poisson2d through the plain SpMM (the CPU path of K2)."""
    kind, shape = case
    if kind == "dense":
        A = _dense_spd(shape, seed=5)
        Aj, Ap = jnp.asarray(A), torch.from_numpy(A)
        return shape, (lambda V: Aj @ V), (lambda V: Ap @ V)
    nx, ny = shape
    Aj = JaxDeviceDia.from_host(JaxDiaMatrix.from_matrix_market(
        jpoisson2d(nx, ny)))
    Ap = DeviceDia.from_host(DiaMatrix.from_matrix_market(poisson2d(nx, ny)))
    return nx * ny, (lambda V: jspmm(Aj, V)), (lambda V: spmm(Ap, V))


def _both(case, k, seed=0, **kw):
    """The JAX and the port's lobpcg on the same X0 and P."""
    n, jmat, pmat = _operators(case)
    X0 = np.random.default_rng(seed).standard_normal((n, k))
    jres = jax_lobpcg(jmat, jnp.asarray(X0), **kw)
    pres = lobpcg(pmat, torch.from_numpy(X0), P0=torch.from_numpy(
        _jax_p(n, k)), **kw)
    return jres, pres


def _assert_step_for_step(jres, pres, repeated=False, converged=True):
    assert isinstance(pres, EigResult)
    assert pres.iterations == int(jres.iterations)
    want = np.asarray(jres.eigenvalues)
    np.testing.assert_allclose(pres.eigenvalues.numpy(), want, rtol=RTOL)
    threshold = STEP_TOL * max(np.abs(want).max(), 1.0)
    res, jres_norms = pres.residual_norms.numpy(), np.asarray(
        jres.residual_norms)
    if converged:
        assert np.all(res <= threshold) and np.all(jres_norms <= threshold)
    np.testing.assert_allclose(res, jres_norms, rtol=0, atol=threshold)
    V, Vj = pres.eigenvectors.numpy(), np.asarray(jres.eigenvectors)
    if repeated:
        # a repeated eigenvalue fixes only its eigenspace: compare the
        # projector of the block
        np.testing.assert_allclose(V @ V.T, Vj @ Vj.T, atol=VEC_ATOL)
    else:
        signs = np.sign(np.sum(V * Vj, axis=0))
        np.testing.assert_allclose(V * signs, Vj, atol=VEC_ATOL)


# ------------------------------------------------------- lobpcg itself

@pytest.mark.parametrize("largest", [False, True],
                         ids=["smallest", "largest"])
@pytest.mark.parametrize("case,k,repeated", [
    (("dense", 60), 5, False),
    (("dia", (12, 9)), 4, False),
    (("dia", (12, 12)), 4, True),
], ids=["dense_spd", "poisson2d_12x9", "poisson2d_12x12"])
def test_lobpcg_step_for_step(case, k, repeated, largest):
    jres, pres = _both(case, k, tol=STEP_TOL, max_iterations=400,
                       largest=largest)
    assert pres.iterations < 400
    _assert_step_for_step(jres, pres, repeated)


def test_lobpcg_matches_analytic():
    nx, ny = 12, 9
    A = DeviceDia.from_host(DiaMatrix.from_matrix_market(poisson2d(nx, ny)))
    res = dia_eigsh(A, k=4, which="smallest", tol=1e-9, max_iterations=400)
    np.testing.assert_allclose(res.eigenvalues.numpy(),
                               _poisson_eigs(nx, ny)[:4], rtol=1e-7)
    assert np.all(res.residual_norms.numpy() < 1e-8)
    V = res.eigenvectors.numpy()
    np.testing.assert_allclose(V.T @ V, np.eye(4), atol=1e-8)
    res = dia_eigsh(A, k=3, which="largest", tol=1e-9, max_iterations=400)
    np.testing.assert_allclose(res.eigenvalues.numpy(),
                               _poisson_eigs(nx, ny)[::-1][:3], rtol=1e-7)


def test_lobpcg_jacobi_step_for_step():
    # test_eigen.py's badly scaled diagonal, through a Jacobi block apply
    rng = np.random.default_rng(6)
    n, k = 50, 3
    d = np.linspace(1.0, 1e4, n)
    A = np.diag(d)
    A[0, 1] = A[1, 0] = 1.0
    X0 = rng.standard_normal((n, k))
    Aj, Ap = jnp.asarray(A), torch.from_numpy(A)
    invj, invp = jnp.asarray(1.0 / d)[:, None], torch.from_numpy(1.0 / d)[
        :, None]
    jres = jax_lobpcg(lambda V: Aj @ V, jnp.asarray(X0),
                      preconditioner=lambda R: R * invj, tol=STEP_TOL,
                      max_iterations=500)
    pres = lobpcg(lambda V: Ap @ V, torch.from_numpy(X0),
                  preconditioner=lambda R: R * invp, tol=STEP_TOL,
                  max_iterations=500, P0=torch.from_numpy(_jax_p(n, k)))
    _assert_step_for_step(jres, pres)
    np.testing.assert_allclose(pres.eigenvalues.numpy(),
                               np.sort(np.linalg.eigvalsh(A))[:k], rtol=1e-6)


@pytest.mark.parametrize("largest", [False, True],
                         ids=["smallest", "largest"])
def test_lobpcg_amg_step_for_step(largest):
    """test_eigen.py's AMG case: the port's block apply against JAX's
    vmapped vector apply; AMG takes fewer iterations than the plain
    solve, in both packages."""
    nx = ny = 48
    n, k = nx * ny, 4
    _, jmat, pmat = _operators(("dia", (nx, ny)))
    japply, _ = jax_amg_preconditioner(JaxCsrMatrix.from_matrix_market(
        jpoisson2d(nx, ny)))
    papply, info = amg_preconditioner(CsrMatrix.from_matrix_market(
        poisson2d(nx, ny)))
    assert info["kind"] == "sa-amg"
    X0 = np.random.default_rng(2).standard_normal((n, k))
    P0 = torch.from_numpy(_jax_p(n, k))
    kw = dict(tol=STEP_TOL, max_iterations=100, largest=largest)
    jres = jax_lobpcg(jmat, jnp.asarray(X0),
                      preconditioner=jax.vmap(japply, in_axes=1, out_axes=1),
                      **kw)
    pres = lobpcg(pmat, torch.from_numpy(X0), preconditioner=papply, P0=P0,
                  **kw)
    # the V-cycle approximates A^-1, which speeds the low end only: the
    # largest end runs to the cap in both packages
    _assert_step_for_step(jres, pres, repeated=True, converged=not largest)
    if not largest:
        np.testing.assert_allclose(pres.eigenvalues.numpy(),
                                   _poisson_eigs(nx, ny)[:k], rtol=1e-6)
        plain = lobpcg(pmat, torch.from_numpy(X0), P0=P0, **kw)
        jplain = jax_lobpcg(jmat, jnp.asarray(X0), **kw)
        assert pres.iterations < 60
        assert pres.iterations < plain.iterations
        assert int(jres.iterations) < int(jplain.iterations)


def test_lobpcg_generator_start():
    """Without P0 the random P comes from the generator (seeded 0 when
    None): the same seed gives the same run."""
    A = _dense_spd(40, seed=3)
    Ap = torch.from_numpy(A)
    X0 = torch.from_numpy(np.random.default_rng(1).standard_normal((40, 3)))
    a = lobpcg(lambda V: Ap @ V, X0, tol=1e-8)
    b = lobpcg(lambda V: Ap @ V, X0, tol=1e-8,
               generator=torch.Generator().manual_seed(0))
    assert a.iterations == b.iterations
    assert torch.equal(a.eigenvalues, b.eigenvalues)
    np.testing.assert_allclose(a.eigenvalues.numpy(),
                               np.linalg.eigvalsh(A)[:3], rtol=1e-10)


def test_lobpcg_contractions_ignore_the_precision_switches():
    """The solver's products pin float32 matmul precision and restore
    the process's switches afterwards."""
    from spmv_tpu_torch.ops.eigen import _ieee_fp32

    flags = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    old = [f.fp32_precision for f in flags]
    try:
        for f in flags:
            f.fp32_precision = "tf32"
        with _ieee_fp32():
            assert [f.fp32_precision for f in flags] == ["ieee", "ieee"]
        assert [f.fp32_precision for f in flags] == ["tf32", "tf32"]
        A = torch.from_numpy(_dense_spd(30, seed=4)).float()
        res = lobpcg(lambda V: A @ V,
                     torch.from_numpy(np.random.default_rng(0)
                                      .standard_normal((30, 2))).float(),
                     tol=1e-5)
        assert res.eigenvalues.dtype == torch.float32
        assert [f.fp32_precision for f in flags] == ["tf32", "tf32"]
    finally:
        for f, o in zip(flags, old):
            f.fp32_precision = o


@pytest.mark.parametrize("entry", ["lobpcg", "cli"])
def test_entry_points_need_a_card_or_the_cpu(entry, monkeypatch,
                                             poisson_file):
    """Without a device the entry points take the card, and refuse where
    there is none unless the CPU is asked for."""
    from spmv_tpu_torch.errors import KernelError

    monkeypatch.delenv("SPMV_TPU_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = _dense_spd(20, seed=1)
    X0 = np.random.default_rng(0).standard_normal((20, 2))
    argv = ["--matrix", poisson_file, "-s", "dia", "--eigs", "2"]
    if entry == "lobpcg":
        with pytest.raises(KernelError, match="no CUDA device"):
            lobpcg(lambda V: torch.from_numpy(A) @ V, X0)
    else:
        assert _run(main, argv) == (1, "")
    monkeypatch.setenv("SPMV_TPU_TORCH_DEVICE", "cpu")
    if entry == "lobpcg":
        res = lobpcg(lambda V: torch.from_numpy(A) @ V, X0, tol=1e-9)
        assert res.eigenvalues.device.type == "cpu"
        np.testing.assert_allclose(res.eigenvalues.numpy(),
                                   np.linalg.eigvalsh(A)[:2], rtol=1e-10)
    else:
        assert _run(main, argv)[0] == 0


# ---------------------------------------------------------- validation

def test_validation_as_jax():
    A = DeviceDia.from_host(DiaMatrix.from_matrix_market(poisson2d(6, 6)))
    with pytest.raises(ValueError, match="which"):
        dia_eigsh(A, which="middle")
    with pytest.raises(ValueError, match="k <= n"):
        lobpcg(lambda V: V, torch.zeros((3, 4)))
    with pytest.warns(UserWarning, match="rank-deficient"):
        lobpcg(lambda V: 2.0 * V, torch.eye(5)[:, :2], max_iterations=1)


def test_dia_eigsh_refuses_non_square():
    from spmv_tpu_torch.io.matrix_market import MatrixMarket

    mm = MatrixMarket(
        object="matrix", format="coordinate", field="real",
        symmetry="general", num_rows=4, num_columns=5, num_entries=4,
        rows_1based=np.array([1, 2, 3, 3]), cols_1based=np.array([1, 2, 3,
                                                                  5]),
        values=np.ones(4))
    A = DeviceDia.from_host(DiaMatrix.from_matrix_market(mm))
    assert (A.num_rows, A.num_columns) == (4, 5)
    with pytest.raises(ValueError, match="square"):
        dia_eigsh(A)


def test_mask_on_a_padded_operator():
    """A poisson2d padded with zero rows: without a mask the padding's
    null space gives zero eigenvalues; with it the block stays on the
    real rows, as in the JAX function."""
    nx, ny, pad, k = 8, 6, 16, 3
    n = nx * ny
    A = np.zeros((n + pad, n + pad))
    A[:n, :n] = np.asarray(JaxCsrMatrix.from_matrix_market(
        jpoisson2d(nx, ny)).to_dense())
    mask = np.r_[np.ones(n), np.zeros(pad)]
    X0 = np.random.default_rng(7).standard_normal((n + pad, k))
    Aj, Ap = jnp.asarray(A), torch.from_numpy(A)
    P0 = torch.from_numpy(_jax_p(n + pad, k))
    jres = jax_lobpcg(lambda V: Aj @ V, jnp.asarray(X0), tol=STEP_TOL,
                      mask=jnp.asarray(mask))
    pres = lobpcg(lambda V: Ap @ V, torch.from_numpy(X0), tol=STEP_TOL,
                  mask=torch.from_numpy(mask), P0=P0)
    _assert_step_for_step(jres, pres)
    np.testing.assert_allclose(pres.eigenvalues.numpy(),
                               _poisson_eigs(nx, ny)[:k], rtol=1e-8)
    assert np.all(pres.eigenvectors.numpy()[n:] == 0.0)
    unmasked = lobpcg(lambda V: Ap @ V, torch.from_numpy(X0), tol=1e-6,
                      P0=P0)
    np.testing.assert_allclose(unmasked.eigenvalues.numpy(), 0.0,
                               atol=1e-6)


# ------------------------------------------------ the block AMG apply

@pytest.mark.parametrize("shape,k", [((24, 24), 3), ((30, 17), 8)])
def test_block_amg_apply(shape, k):
    nx, ny = shape
    n = nx * ny
    apply, _ = amg_preconditioner(CsrMatrix.from_matrix_market(
        poisson2d(nx, ny)), coarse_size=40)
    japply, _ = jax_amg_preconditioner(JaxCsrMatrix.from_matrix_market(
        jpoisson2d(nx, ny)), coarse_size=40)
    R = np.random.default_rng(11).standard_normal((n, k))
    got = apply(torch.from_numpy(R)).numpy()
    assert got.shape == (n, k)
    cols = np.stack([apply(torch.from_numpy(R[:, j].copy())).numpy()
                     for j in range(k)], axis=1)
    np.testing.assert_allclose(got, cols, rtol=1e-12, atol=1e-13)
    want = np.asarray(jax.vmap(japply, in_axes=1, out_axes=1)(
        jnp.asarray(R)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)


def test_block_amg_apply_launch_shape(monkeypatch):
    """A block goes through spmm and a vector through spmv, one call a
    product each: no column loop."""
    from spmv_tpu_torch.ops import amg as pamg

    calls = {"spmv": 0, "spmm": 0}
    real = {"spmv": pamg.spmv, "spmm": pamg.spmm}

    def counting(name):
        def f(A, v):
            calls[name] += 1
            return real[name](A, v)
        return f

    monkeypatch.setattr(pamg, "spmv", counting("spmv"))
    monkeypatch.setattr(pamg, "spmm", counting("spmm"))
    apply, info = amg_preconditioner(CsrMatrix.from_matrix_market(
        poisson2d(20, 20)), coarse_size=40)
    apply(torch.ones(400))
    per_apply = calls["spmv"]
    assert per_apply > 0 and calls["spmm"] == 0
    apply(torch.ones((400, 5)))
    assert calls["spmm"] == per_apply and calls["spmv"] == per_apply


# ------------------------------------------------------------- the CLI

def _run(fn, argv):
    out = io.StringIO()
    rc = fn(argv, out=out)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def poisson_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("eigs") / "poisson10x7.mtx"
    write_matrix_market(jpoisson2d(10, 7), str(p))
    return str(p)


FORMATS = ("dia", "csr", "coo", "ell", "hybrid", "well", "wellcw", "bsr",
           "xla-csr", "auto")


def _eigs_beside_jax(argv):
    rc, text = _run(main, argv)
    jrc, jtext = _run(jax_main, argv)
    assert rc == jrc == 0
    doc, want = json.loads(text), json.loads(jtext)
    assert set(doc) == set(want)
    assert set(doc["eigs"]) == set(want["eigs"])
    for key in ("k", "which", "method", "preconditioner", "tolerance"):
        assert doc["eigs"][key] == want["eigs"][key]
    assert doc["eigs"]["device"] == "cpu"
    np.testing.assert_allclose(doc["eigs"]["eigenvalues"],
                               want["eigs"]["eigenvalues"], rtol=CLI_RTOL)
    return doc


@pytest.mark.parametrize("fmt", FORMATS)
def test_cli_every_format_as_jax_cli(fmt, poisson_file):
    doc = _eigs_beside_jax(["--matrix", poisson_file, "-s", fmt, "--eigs",
                            "3", "--eigs-tol", "1e-9"])
    np.testing.assert_allclose(doc["eigs"]["eigenvalues"],
                               _poisson_eigs(10, 7)[:3], rtol=1e-8)
    assert doc["kernel"]["name"] == (fmt if fmt != "auto"
                                     else doc["kernel"]["name"])


@pytest.mark.parametrize("argv", [
    ["-s", "csr", "--which", "largest"],
    ["-s", "dia", "--precondition", "jacobi"],
    ["-s", "csr", "--precondition", "amg"],
    ["-s", "dia", "--precondition", "amg", "--which", "largest"],
    ["-s", "wellcw", "--precondition", "amg"],
    ["-s", "auto", "--precondition", "amg"],
], ids=lambda a: "_".join(a).replace("-", ""))
def test_cli_which_and_preconditioners_as_jax_cli(argv, poisson_file):
    doc = _eigs_beside_jax(["--matrix", poisson_file, "--eigs", "3",
                            "--eigs-tol", "1e-9"] + argv)
    want = _poisson_eigs(10, 7)
    want = want[::-1][:3] if "largest" in argv else want[:3]
    np.testing.assert_allclose(doc["eigs"]["eigenvalues"], want, rtol=1e-8)


def test_cli_jacobi_reads_the_entries(poisson_file):
    """-s ell --eigs --precondition jacobi: the JAX CLI's
    ``extract_diagonal`` has no branch for the ELL host format and raises;
    the port reads the diagonal from the Matrix Market entries."""
    argv = ["--matrix", poisson_file, "-s", "ell", "--eigs", "3",
            "--eigs-tol", "1e-9", "--precondition", "jacobi"]
    with pytest.raises(AttributeError):
        _run(jax_main, argv)
    rc, text = _run(main, argv)
    assert rc == 0
    np.testing.assert_allclose(json.loads(text)["eigs"]["eigenvalues"],
                               _poisson_eigs(10, 7)[:3], rtol=1e-8)


SYM = """%%MatrixMarket matrix coordinate real symmetric
3 3 5
1 1 2.0
2 1 -1.0
2 2 2.0
3 2 -1.0
3 3 2.0
"""
SKEW = """%%MatrixMarket matrix coordinate real skew-symmetric
3 3 2
2 1 1.0
3 2 -1.0
"""
NONSYM = """%%MatrixMarket matrix coordinate real general
4 4 6
1 1 4.0
1 2 -3.0
2 2 4.0
3 3 4.0
3 4 2.0
4 4 4.0
"""


@pytest.fixture
def files(tmp_path):
    out = {}
    for name, text in (("sym", SYM), ("skew", SKEW), ("nonsym", NONSYM)):
        p = tmp_path / f"{name}.mtx"
        p.write_text(text)
        out[name] = str(p)
    return out


@pytest.mark.parametrize("pre", ["none", "jacobi", "amg"])
def test_cli_symmetric_storage(pre, files):
    """Symmetric storage is expanded for the operator and for the AMG
    hierarchy: tridiag(-1, 2, -1) has 2 - sqrt(2), 2, 2 + sqrt(2)."""
    argv = ["--matrix", files["sym"], "-s", "csr", "--eigs", "2",
            "--eigs-tol", "1e-8", "--precondition", pre, "--eigs-maxiter",
            "300"]
    doc = _eigs_beside_jax(argv)
    want = np.sort(2.0 - 2.0 * np.cos(np.arange(1, 4) * np.pi / 4))
    np.testing.assert_allclose(doc["eigs"]["eigenvalues"], want[:2],
                               rtol=1e-6)


def test_cli_auto_expands_symmetric_storage(files, capsys):
    """-s auto on symmetric storage: the JAX CLI takes the converted
    one-triangle matrix as general storage and its probe refuses it; the
    port reads the entries' symmetry and expands them (a stated
    deviation)."""
    argv = ["--matrix", files["sym"], "-s", "auto", "--eigs", "1",
            "--eigs-tol", "1e-8"]
    assert _run(jax_main, argv) == (1, "")
    assert "numerically symmetric operator" in capsys.readouterr().err
    rc, text = _run(main, argv)
    assert rc == 0
    np.testing.assert_allclose(json.loads(text)["eigs"]["eigenvalues"],
                               [2.0 - np.sqrt(2.0)], rtol=1e-8)


@pytest.mark.parametrize("argv,message", [
    (["--triad", "100", "--eigs", "2"], "needs a matrix kernel"),
    (["@nonsym", "--eigs", "4"], "must be < the matrix dimension"),
    (["@sym", "--eigs", "2", "--precondition", "ic0"],
     "--eigs takes --precondition none, jacobi or amg"),
    (["@skew", "--eigs", "1"], "imaginary spectrum"),
    (["@nonsym", "--eigs", "1"], "numerically symmetric operator"),
], ids=["triad", "k_ge_n", "ic0", "skew_symmetric", "nonsymmetric"])
def test_cli_guards_as_jax_cli(argv, message, files, capsys):
    argv = [files[a[1:]] if a.startswith("@") else a for a in argv]
    if argv[0] != "--triad":
        argv = ["--matrix"] + argv
    rc, text = _run(main, argv)
    err = capsys.readouterr().err
    jrc, jtext = _run(jax_main, argv)
    jerr = capsys.readouterr().err
    assert rc == jrc == 1 and text == jtext == ""
    assert message in err and message in jerr
    assert err.startswith("spmv-tpu-torch: ")
    if "asymmetry" not in err:
        assert err.replace("spmv-tpu-torch:", "spmv-tpu:") == jerr

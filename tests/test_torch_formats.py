"""The reference tool's formats in the port (COO, CSR, ELL, hybrid and
the library comparison ``xla-csr``), their kernel classes, the CLI's
``-s`` modes and ``--reorder``, against the JAX package.

Inputs come from numpy with fixed seeds: poisson2d(32, 32),
banded_random(500, 16, 6), powerlaw(600, 600, 6.0), random_sparse(300,
250, 5) with rows emptied, and the powerlaw matrix with its entries in a
shuffled order (COO keeps the file's order).  They go through both
packages:

- ``CooMatrix``'s arrays equal JAX's bit for bit, and
  ``DeviceCsr.from_coo_host`` gives the arrays of
  ``csr_from_spmv_tpu(spmv_tpu ... DeviceCsr.from_coo_host)``;
- ``spmv`` and ``spmm`` (k = 1, 3, 8, 11) on COO against JAX's at rtol
  1e-12 in float64;
- each kernel class's ``flops_per_run`` and ``describe`` equal JAX's;
  ``bytes_per_run`` equals JAX's for CSR and ELL, and for COO and hybrid
  the stated deviation's count (the CSR kernel reads ``row_ptr`` and no
  row index an entry);
- the CLI's ``-s {csr,xla-csr,coo,coo-atomic,ell,hybrid}`` with
  ``--profile``, ``--spmm`` and ``--cg`` (Jacobi, ``--nrhs``, AMG) print
  the JAX CLI's keys, and their CG iteration counts are within one of
  the JAX CLI's;
- ``--reorder rcm|gp|sigma`` builds the JAX CLI's permuted entries and
  host matrix; ``-s auto --reorder`` is refused (``--reorder color`` is
  held against the JAX CLI in tests/test_torch_solver_cli.py).
"""

import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from spmv_tpu import cli as jcli
from spmv_tpu import kernels as jkernels
from spmv_tpu.io import generate as jgen
from spmv_tpu.io import write_matrix_market as jwrite
from spmv_tpu.models import CooMatrix as JCoo
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import spmm as jspmm
from spmv_tpu.ops import spmv as jspmv
from spmv_tpu_torch import cli as pcli
from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.io import generate as pgen
from spmv_tpu_torch.kernels import KERNEL_NAMES, make_kernel
from spmv_tpu_torch.models import (
    BsrMatrix,
    CooMatrix,
    CsrMatrix,
    DeviceBsr,
    DeviceCsr,
    DeviceDia,
    DeviceEll,
    DeviceHybrid,
    DeviceSparseCsr,
    DeviceWell,
    DeviceWellCw,
    DiaMatrix,
    EllMatrix,
    HybridMatrix,
    WellCwMatrix,
    WellMatrix,
    csr_from_spmv_tpu,
    device_put_matrix,
)
from spmv_tpu_torch.models.device import DEVICE_ENV
from spmv_tpu_torch.ops import sparse_csr_core, spmm, spmv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12
FORMATS = ("csr", "xla-csr", "coo", "coo-atomic", "ell", "hybrid")


@pytest.fixture(autouse=True)
def _fp64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    # the port's entry points run on the card unless asked for the CPU
    monkeypatch.setenv(DEVICE_ENV, "cpu")


def _case(gen, name):
    if name == "poisson":
        return gen.poisson2d(32, 32)
    if name == "banded":
        return gen.banded_random(500, 16, 6, seed=3)
    mm = gen.powerlaw(600, 600, 6.0, seed=4)
    if name == "powerlaw":
        return mm
    r = np.asarray(mm.rows_1based) - 1
    c = np.asarray(mm.cols_1based) - 1
    v = np.asarray(mm.values)
    if name == "shuffled":
        order = np.random.default_rng(9).permutation(r.size)
        return gen.from_coo_arrays(600, 600, r[order], c[order], v[order])
    mm = gen.random_sparse(300, 250, 5, seed=5)          # "empty_rows"
    r = np.asarray(mm.rows_1based) - 1
    keep = (r % 3 != 1) & (r < 290)
    return gen.from_coo_arrays(300, 250, r[keep],
                               np.asarray(mm.cols_1based)[keep] - 1,
                               np.asarray(mm.values)[keep])


CASES = ("poisson", "banded", "powerlaw", "shuffled", "empty_rows")


def _rel(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("name", CASES)
def test_host_coo_matches_jax(name):
    p = CooMatrix.from_matrix_market(_case(pgen, name))
    j = JCoo.from_matrix_market(_case(jgen, name))
    for f in ("num_rows", "num_columns", "num_entries", "num_padding_entries"):
        assert getattr(p, f) == getattr(j, f), f
    for f in ("row_index", "column_index", "value"):
        a, b = getattr(p, f), getattr(j, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert p.memory_usage_bytes() == j.memory_usage_bytes()
    x = np.random.default_rng(1).standard_normal(p.num_columns)
    np.testing.assert_array_equal(p.spmv(x), j.spmv(x))
    np.testing.assert_array_equal(p.to_dense(), j.to_dense())


@pytest.mark.parametrize("name", CASES)
def test_from_coo_host_matches_jax(name):
    p = CooMatrix.from_matrix_market(_case(pgen, name))
    A = DeviceCsr.from_coo_host(p, dtype=torch.float64, device="cpu")
    B = csr_from_spmv_tpu(jdev.DeviceCsr.from_coo_host(
        JCoo.from_matrix_market(_case(jgen, name))))
    for f in ("num_rows", "num_columns", "num_entries"):
        assert getattr(A, f) == getattr(B, f), f
    for f in ("row_ptr", "column_index", "value"):
        assert torch.equal(getattr(A, f), getattr(B, f)), f
    # the same entries as the CSR built from the file
    C = DeviceCsr.from_host(CsrMatrix.from_matrix_market(
        _case(pgen, name)), dtype=torch.float64, device="cpu")
    assert torch.equal(A.row_ptr, C.row_ptr)


@pytest.mark.parametrize("k", (None, 1, 3, 8, 11))
@pytest.mark.parametrize("name", CASES)
def test_coo_products_match_jax(name, k):
    p = CooMatrix.from_matrix_market(_case(pgen, name))
    A = device_put_matrix(p, dtype=torch.float64, device="cpu")
    Aj = jdev.device_put_matrix(JCoo.from_matrix_market(_case(jgen, name)))
    rng = np.random.default_rng(2)
    if k is None:
        x = rng.standard_normal(p.num_columns)
        got, want = spmv(A, torch.from_numpy(x)), jspmv(Aj, x)
    else:
        x = rng.standard_normal((p.num_columns, k))
        got, want = spmm(A, torch.from_numpy(x)), jspmm(Aj, x)
    assert tuple(got.shape) == tuple(np.shape(want))
    assert _rel(got.numpy(), np.asarray(want)) <= RTOL


@pytest.mark.parametrize("k", (None, 3))
def test_sparse_csr_core_matches_the_csr_product(k):
    mm = _case(pgen, "powerlaw")
    A = DeviceCsr.from_host(CsrMatrix.from_matrix_market(mm),
                            dtype=torch.float64, device="cpu")
    S = DeviceSparseCsr(A)
    assert S.matrix.layout == torch.sparse_csr
    shape = (A.num_columns,) if k is None else (A.num_columns, k)
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(shape))
    out = torch.empty((A.num_rows,) + shape[1:], dtype=torch.float64)
    assert sparse_csr_core(S, v, out=out) is out
    want = spmv(A, v) if k is None else spmm(A, v)
    assert _rel(out.numpy(), want.numpy()) <= RTOL
    assert _rel((spmv(S, v) if k is None else spmm(S, v)).numpy(),
                want.numpy()) <= RTOL


HOSTS = {
    "csr": (CsrMatrix, DeviceCsr), "coo": (CooMatrix, DeviceCsr),
    "ell": (EllMatrix, DeviceEll), "hybrid": (HybridMatrix, DeviceHybrid),
    "dia": (DiaMatrix, DeviceDia), "well": (WellMatrix, DeviceWell),
    "wellcw": (WellCwMatrix, DeviceWellCw), "bsr": (BsrMatrix, DeviceBsr),
}


@pytest.mark.parametrize("fmt", list(HOSTS))
def test_device_put_matrix_takes_every_host_format(fmt):
    host_cls, dev_cls = HOSTS[fmt]
    mm = _case(pgen, "poisson")
    A = device_put_matrix(host_cls.from_matrix_market(mm),
                          dtype=torch.float64, device="cpu")
    assert type(A) is dev_cls
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        A.num_columns))
    want = CsrMatrix.from_matrix_market(mm).spmv(x.numpy())
    assert _rel(A(x).double().numpy(), want) <= 1e-12
    with pytest.raises(TypeError):
        device_put_matrix(mm)


@pytest.mark.parametrize("name", ("poisson", "powerlaw", "empty_rows"))
@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel_classes_match_jax(fmt, name):
    """flops and describe equal JAX's; bytes equal JAX's for CSR and ELL,
    and the stated deviation's count for COO and hybrid: the CSR kernel
    reads each entry's column and value and ``row_ptr``, no row index
    (JAX counts ``2 * IDX + vb`` an entry), and nothing where the hybrid's
    COO part is empty."""
    p = make_kernel(fmt, mm=_case(pgen, name), device="cpu",
                    dtype=torch.float64)
    j = jkernels.make_kernel(fmt, mm=_case(jgen, name))
    p.init()
    j.init()
    assert p.flops_per_run() == j.flops_per_run()
    assert p.describe() == j.describe()
    vb, m = 8, p.matrix          # float64 in both packages
    vec = (m.num_rows + m.num_columns) * vb
    if fmt in ("coo", "coo-atomic"):
        assert j.bytes_per_run() == m.num_entries * (8 + vb) + vec
        assert p.bytes_per_run() == (m.num_entries * (4 + vb)
                                     + (m.num_rows + 1) * 4 + vec)
    elif fmt == "hybrid":
        coo = m.num_coo_entries
        ell = m.ell_value.size * (4 + vb)
        assert j.bytes_per_run() == ell + coo * (8 + vb) + vec
        assert p.bytes_per_run() == ell + vec + (
            coo * (4 + vb) + (m.num_rows + 1) * 4 if coo else 0)
    else:
        assert p.bytes_per_run() == j.bytes_per_run()
    for k in (1, 4):
        assert p.spmm_bytes_per_run(k) == p.bytes_per_run() + (k - 1) * vec


@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel_steps_chain(fmt):
    """``run_fn`` and ``spmm_fn`` chain y back into x through two
    buffers; a step is the product of the matrix."""
    mm = _case(pgen, "poisson")
    k = make_kernel(fmt, mm=mm, device="cpu", dtype=torch.float64)
    k.init()
    want = CsrMatrix.from_matrix_market(mm)
    step, (v, A) = k.run_fn()
    v0 = v.numpy().copy()          # the second step writes into v's buffer
    y = step(v, A)
    y2 = step(y, A)
    assert y2.data_ptr() != y.data_ptr()
    assert _rel(y2.numpy(), want.spmv(want.spmv(v0))) <= RTOL
    step, (V, A) = k.spmm_fn(3)
    Y = step(V, A)
    assert _rel(Y.numpy(), np.stack([want.spmv(V[:, c].numpy())
                                     for c in range(3)], 1)) <= RTOL
    with pytest.raises(KernelError):
        k.spmm_fn(0)


def test_make_kernel_takes_every_name():
    mm = _case(pgen, "poisson")
    for name in KERNEL_NAMES:
        k = make_kernel(name, mm=None if name == "triad" else mm,
                        triad_entries=64, device="cpu")
        assert k.name == name
    with pytest.raises(KernelError, match="unknown kernel"):
        make_kernel("mkl-csr", mm=mm, device="cpu")


# ------------------------------------------------------------------ CLI
def _spd_skewed(gen):
    """A symmetric, strictly diagonally dominant matrix with skewed row
    lengths (so the hybrid split puts entries in its COO part): the
    pattern of powerlaw(200, 200, 4) made symmetric, off-diagonal values
    -|a|, each diagonal 1 + (i mod 7) + the row's off-diagonal sum."""
    mm = gen.powerlaw(200, 200, 4.0, seed=6)
    r = np.asarray(mm.rows_1based) - 1
    c = np.asarray(mm.cols_1based) - 1
    off = r != c
    r, c = np.concatenate([r[off], c[off]]), np.concatenate([c[off], r[off]])
    key = np.unique(r * 200 + c)
    r, c = key // 200, key % 200
    lo, hi = np.minimum(r, c), np.maximum(r, c)
    v = -np.abs(np.sin(lo * 0.37 + hi * 0.11)) - 0.1
    diag = 1.0 + np.arange(200) % 7 + np.bincount(r, weights=-v,
                                                   minlength=200)
    return gen.from_coo_arrays(
        200, 200, np.concatenate([r, np.arange(200)]),
        np.concatenate([c, np.arange(200)]), np.concatenate([v, diag]))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("formats")
    out = {}
    for name, mm in (("skewed", _spd_skewed(jgen)),
                     ("poisson", jgen.poisson2d(16, 16)),
                     ("powerlaw", jgen.powerlaw(600, 600, 6.0, seed=4))):
        out[name] = str(d / f"{name}.mtx")
        jwrite(mm, out[name])
    return out


def _run(main, argv):
    buf = io.StringIO()
    rc = main(argv, out=buf)
    return rc, buf.getvalue()


def _keys(doc, want):
    assert set(doc) == set(want)
    for sub in ("cg", "achieved", "roofline", "device", "op"):
        if isinstance(want.get(sub), dict):
            assert set(doc[sub]) == set(want[sub]), sub


def test_skewed_cli_matrix_is_spd_with_a_coo_part():
    m = HybridMatrix.from_matrix_market(_spd_skewed(pgen))
    assert m.num_coo_entries > 0 and m.num_ell_entries > 0
    dense = CsrMatrix.from_matrix_market(_spd_skewed(pgen)).to_dense()
    np.testing.assert_array_equal(dense, dense.T)
    assert np.linalg.eigvalsh(dense).min() > 0


PROFILE_MODES = {
    "profile": ["--profile", "3"],
    "spmm": ["--profile", "3", "--spmm", "4"],
}


@pytest.mark.parametrize("mode", list(PROFILE_MODES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_cli_profile_report_matches_jax(fmt, mode, files):
    argv = ["--matrix", files["powerlaw"], "-s", fmt] + PROFILE_MODES[mode]
    rc, text = _run(pcli.main, argv)
    assert rc == 0
    doc = json.loads(text)
    jrc, jtext = _run(jcli.main, argv)
    assert jrc == 0
    want = json.loads(jtext)
    _keys(doc, want)
    assert doc["kernel"] == {**want["kernel"]}
    assert doc["op"] == want["op"]
    assert doc["device"]["platform"] == "cpu"
    assert doc["achieved"]["gflop_per_s"] > 0


CG_MODES = {
    "cg": ["--cg", "200", "--cg-tol", "1e-8"],
    "cg_nrhs": ["--cg", "200", "--cg-tol", "1e-8", "--nrhs", "2"],
    "cg_recompute": ["--cg", "200", "--cg-tol", "1e-8",
                     "--recompute-residual", "5"],
}


@pytest.mark.parametrize("mode", list(CG_MODES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_cli_cg_matches_jax(fmt, mode, files):
    argv = ["--matrix", files["skewed"], "-s", fmt] + CG_MODES[mode]
    rc, text = _run(pcli.main, argv)
    assert rc == 0
    doc = json.loads(text)
    jrc, jtext = _run(jcli.main, argv)
    assert jrc == 0
    want = json.loads(jtext)
    _keys(doc, want)
    assert doc["kernel"] == want["kernel"]
    got_it, want_it = doc["cg"]["iterations"], want["cg"]["iterations"]
    if mode == "cg_nrhs":
        assert len(got_it) == 2
        assert all(abs(a - b) <= 1 for a, b in zip(got_it, want_it))
        assert max(doc["cg"]["solution_rms_error_vs_ones"]) < 1e-6
    else:
        assert abs(got_it - want_it) <= 1
        assert doc["cg"]["solution_rms_error_vs_ones"] < 1e-6


@pytest.mark.parametrize("fmt", FORMATS)
def test_cli_jacobi_cg(fmt, files):
    """Jacobi PCG reads the diagonal from the entries: iteration counts
    within one of the JAX CLI's on the same format where it has a
    diagonal for that host format (CSR and COO), else of the JAX CLI's
    ``-s csr`` (its ``extract_diagonal`` has no ELL or hybrid branch)."""
    argv = ["--matrix", files["skewed"], "--cg", "200", "--cg-tol", "1e-8",
            "--precondition", "jacobi"]
    rc, text = _run(pcli.main, argv + ["-s", fmt])
    assert rc == 0
    doc = json.loads(text)["cg"]
    ref = fmt if fmt not in ("ell", "hybrid") else "csr"
    jrc, jtext = _run(jcli.main, argv + ["-s", ref])
    assert jrc == 0
    want = json.loads(jtext)["cg"]
    assert abs(doc["iterations"] - want["iterations"]) <= 1
    assert doc["preconditioner"] == "jacobi"
    assert doc["solution_rms_error_vs_ones"] < 1e-6


def test_jax_cli_jacobi_on_ell_has_no_diagonal(files):
    """The JAX CLI's fault the port does not copy: Jacobi on ``-s ell``
    raises there (``extract_diagonal`` reads a row index ELL lacks)."""
    with pytest.raises(AttributeError):
        _run(jcli.main, ["--matrix", files["poisson"], "-s", "ell",
                         "--cg", "20", "--precondition", "jacobi"])


@pytest.mark.parametrize("fmt", ("csr", "hybrid"))
def test_cli_amg_matches_jax(fmt, files):
    argv = ["--matrix", files["poisson"], "-s", fmt, "--cg", "100",
            "--cg-tol", "1e-8", "--precondition", "amg"]
    rc, text = _run(pcli.main, argv)
    assert rc == 0
    doc = json.loads(text)
    jrc, jtext = _run(jcli.main, argv)
    assert jrc == 0
    want = json.loads(jtext)
    _keys(doc, want)
    assert abs(doc["cg"]["iterations"] - want["cg"]["iterations"]) <= 1
    assert doc["cg"]["factorization"]["kind"] == "sa-amg"
    assert doc["cg"]["solution_rms_error_vs_ones"] < 1e-6


def _permuted(gen):
    """poisson2d(12, 12) with its rows and columns shuffled, so that every
    reordering has work to do."""
    mm = gen.poisson2d(12, 12)
    return mm.permute(np.random.default_rng(11).permutation(mm.num_rows))


@pytest.fixture(scope="module")
def shuffled_file(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("reorder") / "shuffled.mtx")
    jwrite(_permuted(jgen), p)
    return p


def _args(main_mod, argv):
    return main_mod.build_parser().parse_args(argv)


def _host_arrays(m):
    if type(m).__name__ == "WellCwMatrix":      # compared by its product
        return {}
    return {f: np.asarray(getattr(m, f)) for f in (
        "row_ptr", "column_index", "value", "data", "offsets",
        "ell_column_index", "ell_value", "coo_row_index",
        "coo_column_index", "coo_value") if hasattr(m, f)}


@pytest.mark.parametrize("order", ("rcm", "gp", "sigma"))
@pytest.mark.parametrize("fmt", ("csr", "ell", "hybrid", "dia", "wellcw"))
def test_reorder_builds_the_jax_cli_matrix(fmt, order, shuffled_file):
    argv = ["--matrix", shuffled_file, "-s", fmt, "--reorder", order,
            "--profile", "2"]
    p, auto_mm = pcli._make_kernel(_args(pcli, argv), torch.device("cpu"),
                                   torch.float64)
    j = jcli._make_kernel(_args(jcli, argv))
    assert auto_mm is None
    p.init()
    j.init()
    for f in ("rows_1based", "cols_1based", "values"):
        np.testing.assert_array_equal(getattr(p._mm, f), getattr(j._mm, f))
    pa, ja = _host_arrays(p.matrix), _host_arrays(j.matrix)
    assert pa.keys() == ja.keys()
    for f in pa:
        np.testing.assert_array_equal(pa[f], ja[f])
    x = np.random.default_rng(12).standard_normal(p.matrix.num_columns)
    assert _rel(p.matrix.spmv(x), j.matrix.spmv(x)) <= RTOL
    assert p.describe() == j.describe()
    # the reordered matrix is a relabelling: same entries, moved
    orig = _permuted(pgen)
    assert sorted(np.asarray(p._mm.values)) == sorted(
        np.asarray(orig.values))


@pytest.mark.parametrize("fmt", ("csr", "hybrid"))
def test_reorder_cli_runs(fmt, shuffled_file):
    argv = ["--matrix", shuffled_file, "-s", fmt, "--reorder", "rcm"]
    for extra in (["--profile", "2", "--spmm", "2"],
                  ["--cg", "100", "--cg-tol", "1e-8"]):
        rc, text = _run(pcli.main, argv + extra)
        assert rc == 0
        doc = json.loads(text)
        if "cg" in doc:
            assert doc["cg"]["solution_rms_error_vs_ones"] < 1e-6


# --eigs is ported: this case stood in test_reorder_refusals and keeps its
# argv here, run beside the JAX CLI on the permuted matrix
@pytest.mark.parametrize("argv", [
    ["-s", "csr", "--reorder", "color", "--eigs", "2"],
], ids=lambda a: "_".join(a).replace("-", ""))
def test_reorder_eigs_as_jax_cli(argv, shuffled_file):
    argv = ["--matrix", shuffled_file] + argv
    rc, text = _run(pcli.main, argv)
    jrc, jtext = _run(jcli.main, argv)
    assert rc == jrc == 0
    np.testing.assert_allclose(json.loads(text)["eigs"]["eigenvalues"],
                               json.loads(jtext)["eigs"]["eigenvalues"],
                               rtol=1e-8)


@pytest.mark.parametrize("argv,message", [
    (["-s", "ell", "--reorder", "color", "--cg", "10", "--precondition",
      "ic0", "--nrhs", "2"], "use single-RHS solves"),
    (["-s", "auto", "--reorder", "rcm", "--profile", "2"],
     "drop --reorder"),
    (["-s", "auto", "--reorder", "color", "--profile", "2"],
     "drop --reorder"),
])
def test_reorder_refusals(argv, message, shuffled_file, capsys):
    rc, text = _run(pcli.main, ["--matrix", shuffled_file] + argv)
    assert rc == 1 and text == ""
    assert message in capsys.readouterr().err


def test_default_format_is_csr(files):
    rc, text = _run(pcli.main, ["--matrix", files["poisson"], "--profile",
                                "2"])
    assert rc == 0
    assert json.loads(text)["kernel"]["name"] == "csr"


def test_formats_cli_imports_no_jax(files):
    code = textwrap.dedent(f"""
        import io, json, sys
        from spmv_tpu_torch.cli import main
        for fmt in {FORMATS!r}:
            for extra in (["--profile", "2"], ["--profile", "2", "--spmm",
                          "2"], ["--cg", "20"], ["--cg", "20", "--nrhs", "2"],
                          ["--cg", "20", "--precondition", "jacobi"]):
                out = io.StringIO()
                rc = main(["--matrix", {files["skewed"]!r}, "-s", fmt]
                          + extra, out=out)
                assert rc == 0, (fmt, extra, rc)
                json.loads(out.getvalue())
        for order in ("rcm", "gp", "sigma"):
            out = io.StringIO()
            assert main(["--matrix", {files["skewed"]!r}, "-s", "ell",
                         "--reorder", order, "--profile", "2"], out=out) == 0
        assert "jax" not in sys.modules, "the port imported jax"
        shared = sorted(m for m in sys.modules
                        if m == "spmv_tpu" or m.startswith("spmv_tpu."))
        assert not shared, shared
        print("ok")
    """)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env[DEVICE_ENV] = "cpu"
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")

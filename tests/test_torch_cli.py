"""The port's CLI against the JAX package's, on a tiny matrix.

Each ported mode prints a document with the JAX CLI's top-level keys
for the same flags; simulation mode and ``--traffic-split`` exit as the
JAX CLI does; every unported mode exits 1 with "not yet ported";
importing the port and running its CPU paths never loads JAX nor any
module of the JAX package (checked in a subprocess, since this test
process already imported both, and by a scan of the port's imports);
without a card the entry points refuse to run unless the caller asks for
the CPU; and the kernel build fails loudly, naming the command, when
nvcc is missing or fails.
"""

import ast
import glob

import io
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from spmv_tpu.cli import main as jax_main
from spmv_tpu_torch.cli import main
from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.models.device import DEVICE_ENV, default_device
from spmv_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MTX = """%%MatrixMarket matrix coordinate real general
4 4 8
1 1 4.0
1 2 -1.0
2 1 -1.0
2 2 4.0
2 3 -1.0
3 2 -1.0
3 3 4.0
4 4 1.0
"""


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


@pytest.fixture
def matrix_file(tmp_path):
    p = tmp_path / "small.mtx"
    p.write_text(MTX)
    return str(p)


def _run(fn, argv):
    out = io.StringIO()
    rc = fn(argv, out=out)
    return rc, out.getvalue()


MODES = {
    "profile": ["--spmv-format", "dia", "--profile", "2"],
    "spmm": ["--spmv-format", "dia", "--profile", "2", "--spmm", "3"],
    "cg": ["--spmv-format", "dia", "--cg", "50", "--cg-tol", "1e-10"],
    "cg_jacobi": ["--spmv-format", "dia", "--cg", "50", "--cg-tol",
                  "1e-10", "--precondition", "jacobi"],
}


@pytest.mark.parametrize("mode", list(MODES) + ["triad", "list_devices"])
def test_report_keys_match_jax_cli(mode, matrix_file):
    if mode == "triad":
        argv = ["--triad", "1000", "--profile", "2"]
    elif mode == "list_devices":
        argv = ["--list-devices"]
    else:
        argv = ["--matrix", matrix_file] + MODES[mode]
    rc, text = _run(main, argv)
    assert rc == 0
    doc = json.loads(text)
    jrc, jtext = _run(jax_main, argv)
    assert jrc == 0
    want = json.loads(jtext)
    if mode == "list_devices":
        # the port names torch and nvcc where JAX names its own version
        assert set(doc) - {"torch_version", "nvcc_version"} == \
            set(want) - {"jax_version"}
        assert doc["machine_models"][0]["hbm_gbps"] > 0
        return
    assert set(doc) == set(want)
    for sub in ("cg", "achieved", "roofline", "device"):
        if sub in want:
            assert set(doc[sub]) == set(want[sub]), sub
    if mode.startswith("cg"):
        assert doc["cg"]["iterations"] == want["cg"]["iterations"]
        assert doc["cg"]["solution_rms_error_vs_ones"] < 1e-8
        assert doc["cg"]["device"] == "cpu"
    else:
        assert doc["op"] == want["op"]
        assert doc["device"]["platform"] == "cpu"
        assert doc["achieved"]["gflop_per_s"] > 0
        assert doc["kernel"] == want["kernel"]


@pytest.mark.parametrize("argv", [
    # these ids named modes of the reference tool's formats and of
    # --reorder, which are ported now; they hold modes that are not
    pytest.param(["--spmv-format", "ell", "--profile", "2",
                  "--flush-caches"], id="spmvformat_well_profile_2"),
    pytest.param(["--spmv-format", "hybrid", "--cg", "10", "--solver",
                  "gmres"], id="spmvformat_well_cg_10_nrhs_2"),
    pytest.param(["--spmv-format", "coo", "--cg", "10", "--precondition",
                  "ilu0"], id="spmvformat_bsr_profile_2"),
    pytest.param(["--spmv-format", "coo-atomic", "--profile", "2",
                  "--jax-profile", "d"],
                 id="spmvformat_cooatomic_profile_2_spmm_2"),
    pytest.param(["--spmv-format", "xla-csr", "--cg", "10", "--solver",
                  "bicgstab"], id="spmvformat_xlacsr_cg_10"),
    ["--spmv-format", "bsr", "--cg", "10", "--solver", "gmres"],
    ["--spmv-format", "auto", "--eigs", "2"],
    ["--spmv-format", "dia", "--cg", "10", "--solver", "bicgstab"],
    ["--spmv-format", "dia", "--cg", "10", "--precondition", "ic0"],
    ["--spmv-format", "dia", "--eigs", "2"],
    ["--spmv-format", "dia", "--scaling", "2"],
    ["--spmv-format", "dia", "--profile", "2", "--jax-profile", "d"],
    ["--spmv-format", "dia", "--profile", "2", "--flush-caches"],
    pytest.param(["--spmv-format", "dia", "--profile", "2", "--reorder",
                  "color"], id="spmvformat_dia_profile_2_reorder_rcm"),
], ids=lambda a: "_".join(a).replace("-", "") or "simulate")
def test_unported_modes_exit_1(argv, matrix_file, capsys):
    rc, text = _run(main, ["--matrix", matrix_file] + argv)
    assert rc == 1 and text == ""
    assert "not yet ported" in capsys.readouterr().err


# Simulation mode and --traffic-split are ported: these cases stood in
# test_unported_modes_exit_1 and keep their ids here.  Where the JAX CLI
# exits 1 (simulation mode without --trace-config; -s dia, which has no
# traffic variants) the port does too, with its message; -s csr reports a
# traffic_split section.
@pytest.mark.parametrize("argv,jax_exit", [
    pytest.param([], 1, id="simulate"),
    pytest.param(["--spmv-format", "csr", "--profile", "2",
                  "--traffic-split"], 0, id="spmvformat_csr_profile_2"),
    pytest.param(["--spmv-format", "dia", "--profile", "2",
                  "--traffic-split"], 1,
                 id="spmvformat_dia_profile_2_trafficsplit"),
])
def test_measurement_modes_exit_as_jax_cli(argv, jax_exit, matrix_file,
                                           capsys):
    import jax

    torch.set_default_dtype(torch.float32)    # restored by _fp64
    rc, text = _run(main, ["--matrix", matrix_file] + argv)
    err = capsys.readouterr().err
    with jax.enable_x64(False):     # the JAX CLI's own default
        jrc, jtext = _run(jax_main, ["--matrix", matrix_file] + argv)
    jerr = capsys.readouterr().err
    assert rc == jrc == jax_exit
    assert "not yet ported" not in err
    if jax_exit:
        assert text == "" and err.startswith("spmv-tpu-torch: ")
        assert err.replace("spmv-tpu-torch:", "spmv-tpu:") in jerr
    else:
        ts, jts = (json.loads(text)["traffic_split"],
                   json.loads(jtext)["traffic_split"])
        assert set(ts) == set(jts) and ts["format"] == jts["format"]


@pytest.fixture(scope="module")
def poisson_file(tmp_path_factory):
    from spmv_tpu.io import write_matrix_market
    from spmv_tpu.io.generate import poisson2d

    p = tmp_path_factory.mktemp("wellcw") / "poisson16.mtx"
    write_matrix_market(poisson2d(16, 16), str(p))
    return str(p)


WELLCW_MODES = {
    "profile": ["--spmv-format", "wellcw", "--profile", "2"],
    "cg": ["--spmv-format", "wellcw", "--cg", "300", "--cg-tol", "1e-10"],
}


@pytest.mark.parametrize("mode", list(WELLCW_MODES))
def test_wellcw_report_matches_jax_cli(mode, poisson_file):
    argv = ["--matrix", poisson_file] + WELLCW_MODES[mode]
    rc, text = _run(main, argv)
    assert rc == 0
    doc = json.loads(text)
    jrc, jtext = _run(jax_main, argv)
    assert jrc == 0
    want = json.loads(jtext)
    assert set(doc) == set(want)
    for sub in ("cg", "achieved", "roofline", "device"):
        if sub in want:
            assert set(doc[sub]) == set(want[sub]), sub
    assert doc["kernel"] == want["kernel"]
    if mode == "cg":
        assert doc["cg"]["iterations"] == want["cg"]["iterations"]
        assert doc["cg"]["solution_rms_error_vs_ones"] < 1e-8
    else:
        assert doc["op"] == want["op"]
        assert doc["device"]["platform"] == "cpu"


def test_wellcw_jacobi_cg_runs_the_dia_iteration(poisson_file):
    """Jacobi PCG on a WELL-CW matrix takes the DIA path's iteration
    count on the same matrix (the JAX CLI has no WELL-CW diagonal)."""
    args = ["--matrix", poisson_file, "--cg", "300", "--cg-tol", "1e-10",
            "--precondition", "jacobi"]
    docs = {}
    for fmt in ("wellcw", "dia"):
        rc, text = _run(main, args + ["--spmv-format", fmt])
        assert rc == 0
        docs[fmt] = json.loads(text)["cg"]
    assert docs["wellcw"]["iterations"] == docs["dia"]["iterations"] > 0
    assert docs["wellcw"]["solution_rms_error_vs_ones"] < 1e-8


def test_cli_errors_exit_1(matrix_file, capsys):
    assert _run(main, ["--profile", "2"])[0] == 1          # no matrix
    assert _run(main, ["--triad", "64", "--cg", "10"])[0] == 1
    assert _run(main, ["--triad", "64", "--profile", "2",
                       "--spmm", "2"])[0] == 1
    assert _run(main, ["--matrix", "/does/not/exist.mtx", "-s", "dia",
                       "--profile", "2"])[0] == 1
    assert "spmv-tpu-torch:" in capsys.readouterr().err


def test_port_never_imports_jax(matrix_file):
    code = textwrap.dedent(f"""
        import io, json, sys
        import spmv_tpu_torch
        from spmv_tpu_torch.cli import main
        for argv in (["-s", "dia", "--profile", "2"],
                     ["-s", "wellcw", "--profile", "2"],
                     ["-s", "wellcw", "--cg", "20"],
                     ["-s", "wellcw", "--profile", "2", "--spmm", "2"],
                     ["-s", "wellcw", "--cg", "20", "--nrhs", "2"],
                     ["-s", "dia", "--cg", "20", "--nrhs", "2"],
                     ["-s", "well", "--profile", "2"],
                     ["-s", "well", "--cg", "20"],
                     ["-s", "well", "--profile", "2", "--spmm", "2"],
                     ["-s", "well", "--cg", "20", "--nrhs", "2"],
                     ["-s", "bsr", "--profile", "2", "--spmm", "2"],
                     ["-s", "bsr", "--cg", "20", "--nrhs", "2"],
                     ["-s", "auto", "--profile", "2", "--spmm", "2"],
                     ["-s", "auto", "--cg", "20", "--precondition",
                      "jacobi"],
                     ["-s", "hybrid", "--profile", "2", "--traffic-split"],
                     ["-s", "well", "--profile", "0", "--trace-config",
                      {os.path.join(REPO, "configs", "cpu-2thread.json")!r}]):
            out = io.StringIO()
            rc = main(["--matrix", {matrix_file!r}] + argv, out=out)
            assert rc == 0, (argv, rc)
            doc = json.loads(out.getvalue())
            assert (doc.get("device") or doc.get("cg")
                    or doc["cache_misses"]) is not None
        import spmv_tpu_torch.kernels, spmv_tpu_torch.profile.report
        import spmv_tpu_torch.profile.harness, spmv_tpu_torch.perfmodel
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


def _imports_of_the_jax_package(path):
    """(line, statement) of each import of ``spmv_tpu`` or a module of it
    in the file, at any depth (inside functions too)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name == "spmv_tpu" or name.startswith("spmv_tpu."):
                found.append((node.lineno, name))
    return found


def test_port_imports_nothing_of_the_jax_package():
    """No module of the port and no line of chip_smoke.py imports
    ``spmv_tpu``: the port keeps its own copies of what it needs."""
    files = glob.glob(os.path.join(REPO, "spmv_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 30
    bad = {os.path.relpath(f, REPO): hits for f in files
           if (hits := _imports_of_the_jax_package(f))}
    assert not bad, bad


def test_import_scan_finds_imports_inside_functions(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nimport spmv_tpu_torch.ops\n"
                 "def f():\n    from spmv_tpu.io import generate\n"
                 "    import spmv_tpu.models as m\n")
    assert _imports_of_the_jax_package(str(p)) == [
        (4, "spmv_tpu.io"), (5, "spmv_tpu.models")]


def test_no_card_and_no_cpu_request_raises(monkeypatch, matrix_file,
                                           capsys):
    """Without a visible card the entry points refuse to run unless the
    caller asks for the CPU; listing devices still works."""
    monkeypatch.delenv(DEVICE_ENV)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KernelError, match=DEVICE_ENV):
        default_device()
    rc, text = _run(main, ["--matrix", matrix_file, "-s", "dia",
                           "--profile", "2"])
    assert rc == 1 and text == ""
    assert f"{DEVICE_ENV}=cpu" in capsys.readouterr().err
    rc, text = _run(main, ["--list-devices"])
    assert rc == 0 and json.loads(text)["default_backend"] == "cpu"
    monkeypatch.setenv(DEVICE_ENV, "gpu")
    with pytest.raises(KernelError, match="expected 'cpu' or 'cuda'"):
        default_device()
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    assert default_device() == torch.device("cpu")


def test_cli_without_card_exits_nonzero(matrix_file):
    """``python -m spmv_tpu_torch`` with no visible card and no request
    for the CPU exits non-zero, naming the variable, and prints no
    report."""
    env = {k: v for k, v in os.environ.items() if k != DEVICE_ENV}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-m", "spmv_tpu_torch", "--matrix",
                        matrix_file, "-s", "dia", "--profile", "2"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert DEVICE_ENV in r.stderr


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build_library(build_dir=tmp_path / "build")


def test_failed_compile_names_command_and_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError) as e:
        _build.build_library(build_dir=tmp_path / "build")
    msg = str(e.value)
    assert "exit code 3" in msg and "no sm_90a here" in msg
    assert str(fake) in msg and "sm_90a" in msg
    assert not list((tmp_path / "build").glob("*.so"))

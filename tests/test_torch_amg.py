"""The port's smoothed-aggregation AMG (``spmv_tpu_torch/ops/amg.py`` and
``ops/_amg_native.py``) and the CLI's ``--precondition amg`` against the
JAX package.

Inputs come from numpy with fixed seeds and go through both packages:

- the host helpers, the native aggregation (the port's loader builds
  ``csrc/amg.cpp`` into its own build directory) and the SA and block
  setups are the JAX package's numpy code, copied: their arrays must be
  EQUAL, bit for bit;
- the generic and block V-cycles run the same arithmetic in another
  framework: the sums differ in rounding order only, so they are held to
  the JAX functions at rtol 1e-12 in float64 (the JAX tests run with x64
  on, tests/conftest.py);
- PCG iteration counts (``amg_solve``, PCG with either V-cycle, and the
  CLI) must equal the JAX package's.
"""

import importlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.cli import main as jax_main
from spmv_tpu.io.generate import banded_random as jbanded_random
from spmv_tpu.io.generate import poisson2d as jpoisson2d
from spmv_tpu.io.matrix_market import write_matrix_market
from spmv_tpu.models import CsrMatrix as JaxCsrMatrix
from spmv_tpu.models import DiaMatrix as JaxDiaMatrix
from spmv_tpu.models.device import DeviceCsr as JaxDeviceCsr
from spmv_tpu.ops import preconditioned_conjugate_gradient as jax_pcg
from spmv_tpu.ops import spmv as jspmv
from spmv_tpu_torch.cli import main
from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.io.generate import poisson2d
from spmv_tpu_torch.models import CsrMatrix, DeviceCsr, DiaMatrix
from spmv_tpu_torch.ops import (
    amg_preconditioner,
    amg_solve,
    block_aggregation_setup,
    block_amg_preconditioner,
    preconditioned_conjugate_gradient,
    smoothed_aggregation_setup,
    spmv,
)
from spmv_tpu_torch.ops import _amg_native
from spmv_tpu_torch.ops.amg import block_amg_device, block_vcycle

ja = importlib.import_module("spmv_tpu.ops.amg")
pa = importlib.import_module("spmv_tpu_torch.ops.amg")

RTOL = 1e-12        # float64, rounding order only


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
    # the same ids (held in lockstep below), so the JAX side takes it
    monkeypatch.setattr(importlib.import_module("spmv_tpu.ops._amg_native"),
                        "available", lambda: False)


def _both(shape):
    """poisson2d(*shape) as a host CSR of each package."""
    return (JaxCsrMatrix.from_matrix_market(jpoisson2d(*shape)),
            CsrMatrix.from_matrix_market(poisson2d(*shape)))


def _rand_csr(n_rows, n_cols, density, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((n_rows, n_cols)) < density
    dense = np.where(mask, rng.standard_normal((n_rows, n_cols)), 0.0)
    dense[np.arange(min(n_rows, n_cols)),
          np.arange(min(n_rows, n_cols))] += 4.0
    rows, cols = np.nonzero(dense)
    rp = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=rp[1:])
    return rp, cols.astype(np.int32), dense[rows, cols]


def _equal(a, b):
    """Tuples, NamedTuples and arrays equal, bit for bit."""
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


# ------------------------------------------------------- host helpers

def _helper_args(name):
    (ar, ac, av), (br, bc, bv) = _rand_csr(23, 17, 0.2, 0), \
        _rand_csr(17, 29, 0.25, 1)
    rng = np.random.default_rng(2)
    sq = _rand_csr(40, 40, 0.15, 3)
    rows = rng.integers(0, 9, 60)
    cols = rng.integers(0, 7, 60)
    vals = rng.standard_normal(60)
    return {
        "_csr_from_coo": (9, rows, cols, vals),
        "_coo_dedupe": (9, 7, rows, cols, vals),
        "_spgemm": (23, ar, ac, av, br, bc, bv, 29),
        "_transpose": (23, 17, ar, ac, av),
        "_host_spmv_fast": (ar, ac, av, rng.standard_normal(17)),
        "_extract_diag": (40, *sq),
        "_strength_graph": (40, *sq, 0.08),
        "_lambda_max_dinv_a": (40, *sq, 1.0 / np.abs(
            ja._extract_diag(40, *sq))),
        "_aggregate_py": (40, *ja._strength_graph(40, *sq, 0.08)[:2]),
        "_pad_csr_identity": (40, 44, *sq, 2.5),
    }[name]


@pytest.mark.parametrize("name", [
    "_csr_from_coo", "_coo_dedupe", "_spgemm", "_transpose",
    "_host_spmv_fast", "_extract_diag", "_strength_graph",
    "_lambda_max_dinv_a", "_aggregate_py", "_pad_csr_identity"])
def test_host_helper_equals_jax(name):
    args = _helper_args(name)
    _equal(getattr(pa, name)(*args), getattr(ja, name)(*args))


@pytest.mark.parametrize("shape", [(20, 20), (7, 31), (1, 64), (70, 70)])
def test_native_aggregation_lockstep(shape):
    """The port's native aggregation (csrc/amg.cpp through its own
    loader) gives the Python loop's ids, and both give JAX's."""
    assert _amg_native.available()
    m = CsrMatrix.from_matrix_market(poisson2d(*shape))
    rp, cols, vals = pa._as_host_csr(m)
    srp, scols, _ = pa._strength_graph(m.num_rows, rp, cols, vals, 0.08)
    agg_py, cnt_py = pa._aggregate_py(m.num_rows, srp, scols)
    agg_c, cnt_c = _amg_native.aggregate(srp, scols)
    assert cnt_c == cnt_py
    np.testing.assert_array_equal(agg_c, agg_py)
    _equal(pa._aggregate(m.num_rows, srp, scols),
           ja._aggregate(m.num_rows, srp, scols))


# ------------------------------------------------------------ setups

def _assert_hierarchies_equal(hp, hj):
    assert len(hp.levels) == len(hj.levels)
    for lp, lj in zip(hp.levels, hj.levels):
        assert lp._fields == lj._fields
        _equal(tuple(lp), tuple(lj))
    np.testing.assert_array_equal(hp.coarse_inv, hj.coarse_inv)
    assert hp.operator_complexity == hj.operator_complexity


@pytest.mark.parametrize("case", ["csr", "dia", "mm", "native"])
def test_sa_setup_equals_jax(case):
    shape, kw = ((70, 70), {"coarse_size": 600}) if case == "native" \
        else ((20, 20), {"coarse_size": 50})
    if case == "dia":
        mp = DiaMatrix.from_matrix_market(poisson2d(*shape))
        mj = JaxDiaMatrix.from_matrix_market(jpoisson2d(*shape))
    elif case == "mm":
        mp, mj = poisson2d(*shape), jpoisson2d(*shape)
    else:
        mj, mp = _both(shape)
    hp = smoothed_aggregation_setup(mp, **kw)
    hj = ja.smoothed_aggregation_setup(mj, **kw)
    assert len(hp.levels) >= 1
    _assert_hierarchies_equal(hp, hj)
    assert (hp.theta, hp.omega) == (hj.theta, hj.omega)


@pytest.mark.parametrize("case", ["p13x11", "p65x63", "dia", "smooth0"])
def test_block_setup_equals_jax(case):
    shape, kw = {
        "p13x11": ((13, 11), {"coarse_size": 20}),
        "p65x63": ((65, 63), {"coarse_size": 100}),
        "dia": ((32, 32), {"coarse_size": 64}),
        "smooth0": ((24, 24), {"coarse_size": 40, "smooth_levels": 0}),
    }[case]
    if case == "dia":
        mp = DiaMatrix.from_matrix_market(poisson2d(*shape))
        mj = JaxDiaMatrix.from_matrix_market(jpoisson2d(*shape))
    else:
        mj, mp = _both(shape)
    hp = block_aggregation_setup(mp, **kw)
    hj = ja.block_aggregation_setup(mj, **kw)
    _assert_hierarchies_equal(hp, hj)
    if case in ("p13x11", "p65x63"):
        # odd sizes pad with identity rows
        assert hp.levels[0].n_pad > hp.levels[0].n


def test_setups_refuse_as_jax():
    rect = CsrMatrix.from_matrix_market(
        importlib.import_module("spmv_tpu_torch.io.generate").random_sparse(
            20, 30, 3, seed=1))
    with pytest.raises(ValueError, match="square"):
        smoothed_aggregation_setup(rect)
    with pytest.raises(ValueError, match="block must be >= 2"):
        block_aggregation_setup(_both((8, 8))[1], block=1)
    with pytest.raises(TypeError, match="unsupported host matrix"):
        pa._as_host_csr(object())


# ------------------------------------------------------------ V-cycles

@pytest.mark.parametrize("shape,coarse", [((24, 24), 512), ((48, 48), 128)])
def test_generic_vcycle_matches_jax(shape, coarse):
    mj, mp = _both(shape)
    hj = ja.smoothed_aggregation_setup(mj, coarse_size=coarse)
    hp = smoothed_aggregation_setup(mp, coarse_size=coarse)
    japply, jinfo = ja.amg_preconditioner(hierarchy=hj, dtype=jnp.float64)
    papply, pinfo = amg_preconditioner(hierarchy=hp, dtype=torch.float64)
    r = np.random.default_rng(1).standard_normal(mp.num_rows)
    want = np.asarray(japply(jnp.asarray(r)))
    got = papply(torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    assert pinfo == jinfo


@pytest.mark.parametrize("max_diagonals", [96, 6])
def test_block_vcycle_matches_jax(max_diagonals):
    """max_diagonals 6 forces the Galerkin levels onto DeviceCsr."""
    mj, mp = _both((40, 36))
    hj = ja.block_aggregation_setup(mj, coarse_size=64)
    hp = block_aggregation_setup(mp, coarse_size=64)
    dj = ja.block_amg_device(hj, dtype=jnp.float64,
                             max_diagonals=max_diagonals)
    dp = block_amg_device(hp, dtype=torch.float64,
                          max_diagonals=max_diagonals)
    kinds = [type(lv.a).__name__ for lv in dp.levels]
    assert kinds == [type(lv.a).__name__ for lv in dj.levels]
    assert ("DeviceCsr" in kinds) == (max_diagonals == 6)
    r = np.random.default_rng(2).standard_normal(hp.levels[0].n_pad)
    want = np.asarray(ja.block_vcycle(dj, jnp.asarray(r)))
    got = block_vcycle(dp, torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_block_preconditioner_matches_jax():
    mj, mp = _both((13, 11))       # 143 rows, padded at level 0
    japply, jinfo = ja.block_amg_preconditioner(mj, dtype=jnp.float64,
                                                coarse_size=20)
    papply, pinfo = block_amg_preconditioner(mp, dtype=torch.float64,
                                             coarse_size=20)
    r = np.random.default_rng(3).standard_normal(143)
    want = np.asarray(japply(jnp.asarray(r)))
    got = papply(torch.from_numpy(r)).numpy()
    assert got.shape == (143,)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    assert pinfo == jinfo


# ------------------------------------------------- PCG iteration counts

def test_amg_solve_iterations_equal_jax():
    mj, mp = _both((65, 63))        # odd sizes pad at every level
    x_true = np.random.default_rng(1).standard_normal(mp.num_rows)
    b = mp.spmv(x_true)
    rj, ij = ja.amg_solve(mj, b, tol=1e-10, max_iterations=500,
                          coarse_size=100)
    rp, ip = amg_solve(mp, b, tol=1e-10, max_iterations=500,
                       coarse_size=100)
    assert ip == ij
    assert all(f == "DeviceDia" for f in ip["level_formats"])
    assert rp.iterations == int(rj.iterations) < 40
    np.testing.assert_allclose(rp.x.numpy(), x_true, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(rp.x.numpy(), np.asarray(rj.x), rtol=1e-9,
                               atol=1e-11)


@pytest.mark.parametrize("kind", ["generic", "block"])
def test_pcg_iterations_equal_jax(kind):
    mj, mp = _both((48, 48))
    x_true = np.random.default_rng(0).standard_normal(mp.num_rows)
    b = mp.spmv(x_true)
    if kind == "generic":
        japply, _ = ja.amg_preconditioner(mj, dtype=jnp.float64)
        papply, _ = amg_preconditioner(mp, dtype=torch.float64)
    else:
        japply, _ = ja.block_amg_preconditioner(mj, dtype=jnp.float64,
                                                coarse_size=64)
        papply, _ = block_amg_preconditioner(mp, dtype=torch.float64,
                                             coarse_size=64)
    Aj = JaxDeviceCsr.from_host(mj, dtype=jnp.float64)
    Ap = DeviceCsr.from_host(mp, dtype=torch.float64)
    rj = jax_pcg(lambda v: jspmv(Aj, v), jnp.asarray(b), japply,
                 tol=1e-10, max_iterations=500)
    rp = preconditioned_conjugate_gradient(
        lambda v: spmv(Ap, v), torch.from_numpy(b), papply, tol=1e-10,
        max_iterations=500)
    assert rp.iterations == int(rj.iterations) < 60
    np.testing.assert_allclose(rp.x.numpy(), x_true, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("entry", ["amg_preconditioner",
                                   "block_amg_preconditioner", "amg_solve"])
def test_entry_points_need_a_card_or_the_cpu(entry, monkeypatch):
    """Without ``device=`` the entry points take the card, and raise
    where there is none unless the CPU is asked for."""
    monkeypatch.delenv("SPMV_TPU_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _both((12, 12))[1]
    call = {
        "amg_preconditioner": lambda: amg_preconditioner(m, coarse_size=40),
        "block_amg_preconditioner": lambda: block_amg_preconditioner(
            m, coarse_size=40),
        "amg_solve": lambda: amg_solve(m, np.ones(m.num_rows),
                                       coarse_size=40),
    }[entry]
    with pytest.raises(KernelError, match="no CUDA device"):
        call()
    monkeypatch.setenv("SPMV_TPU_TORCH_DEVICE", "cpu")
    call()


# ------------------------------------------------------------- the CLI

def _run(fn, argv):
    out = io.StringIO()
    rc = fn(argv, out=out)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def poisson32_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("amg") / "poisson32.mtx"
    write_matrix_market(jpoisson2d(32, 32), str(p))
    return str(p)


@pytest.mark.parametrize("fmt", ["dia", "wellcw", "well", "auto"])
def test_cli_amg_iterations_equal_jax_cli(fmt, poisson32_file):
    argv = ["--matrix", poisson32_file, "--spmv-format", fmt, "--cg",
            "200", "--precondition", "amg"]
    rc, text = _run(main, argv)
    assert rc == 0
    doc = json.loads(text)
    jrc, jtext = _run(jax_main, argv)
    assert jrc == 0
    want = json.loads(jtext)
    assert set(doc) == set(want) and set(doc["cg"]) == set(want["cg"])
    assert doc["cg"]["iterations"] == want["cg"]["iterations"] == 8
    assert doc["cg"]["factorization"] == want["cg"]["factorization"]
    assert doc["cg"]["factorization"]["level_rows"] == [1024, 176]
    # the default tolerance 1e-6; the same iterates as JAX's up to rounding
    np.testing.assert_allclose(doc["cg"]["solution_rms_error_vs_ones"],
                               want["cg"]["solution_rms_error_vs_ones"],
                               rtol=1e-6)
    assert doc["cg"]["solution_rms_error_vs_ones"] < 1e-6


def test_cli_auto_amg_reads_the_entries(tmp_path):
    """-s auto packs banded_random(3000, 64, 6) as WELL; the JAX CLI then
    hands the WELL matrix to ``_as_host_csr``, which raises TypeError (a
    reference fault); the port builds the hierarchy from the Matrix
    Market entries."""
    path = str(tmp_path / "band.mtx")
    write_matrix_market(jbanded_random(3000, 64, 6, seed=1), path)
    argv = ["--matrix", path, "--spmv-format", "auto", "--cg", "200",
            "--precondition", "amg"]
    with pytest.raises(TypeError, match="WellMatrix"):
        _run(jax_main, argv)
    rc, text = _run(main, argv)
    assert rc == 0
    doc = json.loads(text)
    assert doc["kernel"]["matrix_format"] == "well"
    assert doc["cg"]["factorization"]["kind"] == "sa-amg"
    assert doc["cg"]["factorization"]["level_rows"][0] == 3000


@pytest.mark.parametrize("argv,message", [
    (["--spmv-format", "dia", "--cg", "50", "--precondition", "amg",
      "--nrhs", "3"], "use single-RHS solves for ic0/ilu0/amg"),
    (["--spmv-format", "dia", "--cg", "50", "--precondition", "ilu0",
      "--nrhs", "3"], "use single-RHS solves for ic0/ilu0/amg"),
    (["--spmv-format", "well", "--cg", "50", "--precondition",
      "ic0-sweeps", "--solver", "chebyshev"],
     "does not take a preconditioner"),
])
def test_cli_amg_refusals(argv, message, poisson32_file, capsys):
    rc, text = _run(main, ["--matrix", poisson32_file] + argv)
    assert rc == 1 and text == ""
    assert message in capsys.readouterr().err

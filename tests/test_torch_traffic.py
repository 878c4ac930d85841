"""The port's traffic-isolation variants (``--traffic-split``) against the
JAX package's ``spmv_tpu.ops.traffic``.

Inputs come from numpy with fixed seeds, on the JAX traffic tests' own
matrices (``tests/test_traffic.py::_cases``: a rectangular CSR, the same
with host row alignment 4, ELL, hybrid, WELL and WELL with a spill),
plus segmented WELL and COO through ``DeviceCsr.from_coo_host``, and go
through both packages:

- the stream-only and gather-only plain versions (what the wrappers run
  for CPU tensors) against ``spmv_regular_traffic`` /
  ``spmv_irregular_traffic`` at rtol 1e-12 in float64 (the sums differ
  only in order), except WELL's gather-only leg: the port reads the live
  slots only, as K5 does, so it equals JAX's result minus the all-zero
  slots' gathers, computed here from JAX's container (a stated
  deviation);
- the byte model pinned at poisson2d(64, 64), float32, beside JAX's
  numbers (the port prices no device row padding, overflow row, sublane
  padding, dead WELL slot or empty COO part: a stated deviation);
- ``measure_traffic_split``'s keys and finite times on the CPU;
- the CLI's ``traffic_split`` section against the JAX CLI's keys on csr,
  coo, ell, hybrid and well, and JAX's exit code and message for every
  refusal (dia, wellcw, bsr, ``-s auto`` picking dia, ``--triad``,
  ``--spmm``), both CLIs in float32 (the JAX CLI without x64, its own
  default);
- a fault of the JAX CLI the port does not copy: with x64 on, its
  measurement makes x float32 for a container without ``value``
  (``spmv_tpu/profile/traffic.py:65-67``), so the hybrid's split raises
  ``TypeError`` (and dia, wellcw and bsr raise it before their
  ``KernelError``); the port takes the value dtype.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.cli import main as jax_main
from spmv_tpu.io import generate as jgen
from spmv_tpu.io import write_matrix_market
from spmv_tpu.models import CooMatrix as JCoo
from spmv_tpu.models import CsrMatrix as JCsr
from spmv_tpu.models import EllMatrix as JEll
from spmv_tpu.models import HybridMatrix as JHybrid
from spmv_tpu.models import device as jdev
from spmv_tpu.models.well import WellMatrix as JWell
from spmv_tpu.ops import traffic as jtraffic
from spmv_tpu_torch.cli import main
from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.io import generate as pgen
from spmv_tpu_torch.models import (
    CooMatrix,
    CsrMatrix,
    DeviceCsr,
    DeviceDia,
    DeviceWell,
    DiaMatrix,
    EllMatrix,
    HybridMatrix,
    WellMatrix,
    device_put_matrix,
)
from spmv_tpu_torch.models.device import DEVICE_ENV
from spmv_tpu_torch.ops import (
    csr_irregular_core,
    csr_regular_core,
    ell_irregular_core,
    ell_regular_core,
    spmv_irregular_traffic,
    spmv_regular_traffic,
    traffic_variant_bytes,
    well_irregular_core,
    well_regular_core,
)
from spmv_tpu_torch.profile import measure_traffic_split

RTOL = 1e-12
LANE = 128


@pytest.fixture(autouse=True)
def _fp64(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _pair(name):
    """(JAX container, the port's container) of one case, each built by
    its own package from its own generator (the generators are copies)."""
    def both(mm_of, jconv, pconv, jdev_of=jdev.device_put_matrix,
             pdev_of=device_put_matrix):
        return jdev_of(jconv(mm_of(jgen))), pdev_of(pconv(mm_of(pgen)))

    rect = lambda g: g.random_sparse(37, 41, 6, seed=7)  # noqa: E731
    scat = lambda g: g.random_sparse(50, 50, 8, seed=8)  # noqa: E731
    band = lambda g: g.banded_random(256, 256, 4, seed=9)  # noqa: E731
    if name == "csr":
        return both(rect, JCsr.from_matrix_market, CsrMatrix.from_matrix_market)
    if name == "csr_aligned":
        return both(rect, lambda m: JCsr.from_matrix_market(m, row_alignment=4),
                    lambda m: CsrMatrix.from_matrix_market(m, row_alignment=4))
    if name == "coo":
        return both(scat, JCoo.from_matrix_market, CooMatrix.from_matrix_market)
    if name == "ell":
        return both(rect, JEll.from_matrix_market, EllMatrix.from_matrix_market)
    if name == "hybrid":
        return both(scat, JHybrid.from_matrix_market,
                    HybridMatrix.from_matrix_market)
    if name == "well":
        return both(band, JWell.from_matrix_market,
                    WellMatrix.from_matrix_market)
    if name == "well_spill":
        return both(scat, JWell.from_matrix_market,
                    WellMatrix.from_matrix_market)
    # segmented WELL: a band read through segments of 4 x-rows
    big = lambda g: g.banded_random(2000, 60, 5, seed=30)  # noqa: E731
    return both(lambda g: big(g),
                lambda m: JWell.from_matrix_market(m, window_rows=2),
                lambda m: WellMatrix.from_matrix_market(m, window_rows=2),
                lambda m: jdev.DeviceWell.from_host(m, segment_rows=4),
                lambda m: DeviceWell.from_host(m, segment_rows=4))


CASES = ("csr", "csr_aligned", "coo", "ell", "hybrid", "well", "well_spill",
         "well_segmented")


def _x(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n)


def _dead_slot_gathers(Aj, x):
    """Per row, the sum of x at the columns of JAX's WELL slots that hold
    no nonzero (the gathers JAX's gather-only leg issues and the port's
    does not); also asserts that no live slot reads past the end, where
    JAX clips and the port reads 0."""
    cols = np.asarray(jtraffic._well_window_columns(Aj))   # (chunks, 8, 128)
    dead = ~(np.asarray(Aj.value) != 0).any(axis=2)          # (chunks, 8)
    assert dead.any(), "the case must hold dead slots"
    assert (cols[~dead] < Aj.num_columns).all()
    g = np.asarray(x)[np.minimum(cols, Aj.num_columns - 1)]
    contrib = (g * dead[:, :, None]).sum(axis=1)             # (chunks, 128)
    y = np.zeros((Aj.num_groups, LANE))
    np.add.at(y, np.asarray(Aj.group_of_chunk).reshape(-1), contrib)
    return y.reshape(-1)[: Aj.num_rows]


@pytest.mark.parametrize("name", CASES)
def test_variants_match_jax(name):
    Aj, Ap = _pair(name)
    x = _x(Ap.num_columns)
    xt = torch.from_numpy(x)
    reg = spmv_regular_traffic(Ap, xt)
    irr = spmv_irregular_traffic(Ap, xt)
    assert reg.shape == irr.shape == (Ap.num_rows,)
    assert reg.dtype == irr.dtype == torch.float64
    want_reg = np.asarray(jtraffic.spmv_regular_traffic(Aj, jnp.asarray(x)))
    want_irr = np.asarray(jtraffic.spmv_irregular_traffic(Aj, jnp.asarray(x)))
    np.testing.assert_allclose(reg.numpy(), want_reg, rtol=RTOL, atol=1e-13)
    if isinstance(Ap, DeviceWell):
        # the stated deviation: no gather of an all-zero slot
        want_irr = want_irr - _dead_slot_gathers(Aj, x)
    np.testing.assert_allclose(irr.numpy(), want_irr, rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("name", ["well", "well_spill", "well_segmented"])
def test_well_gather_only_leaves_out_dead_slots(name):
    """The port's WELL gather-only leg differs from JAX's by exactly the
    all-zero slots' gathers, and by a visible amount: a stencil fills 5
    of a chunk's 8 slots."""
    Aj, Ap = _pair(name)
    x = np.abs(_x(Ap.num_columns, seed=11)) + 1.0
    got = spmv_irregular_traffic(Ap, torch.from_numpy(x)).numpy()
    jax_irr = np.asarray(jtraffic.spmv_irregular_traffic(Aj, jnp.asarray(x)))
    dead = _dead_slot_gathers(Aj, x)
    assert dead.sum() > 0
    np.testing.assert_allclose(got, jax_irr - dead, rtol=RTOL, atol=1e-12)
    assert not np.allclose(got, jax_irr)


@pytest.mark.parametrize("core,kind", [
    (csr_regular_core, "csr"), (csr_irregular_core, "csr"),
    (ell_regular_core, "ell"), (ell_irregular_core, "ell"),
    (well_regular_core, "well"), (well_irregular_core, "well")],
    ids=lambda v: getattr(v, "__name__", v))
def test_cpu_tensors_take_the_plain_version(core, kind):
    """On CPU tensors each wrapper runs its plain version and counts no
    launch; ``out`` (and, for the CSR variants, which the hybrid adds
    into y with, ``accumulate``) behave as for the products."""
    Ap = _pair(kind)[1]
    x = torch.from_numpy(_x(Ap.num_columns))
    args = (Ap,) if "_regular" in core.__name__ else (Ap, x)
    before = core.launches
    y = core(*args)
    out = torch.full((Ap.num_rows,), 0.5)
    core(*args, out=out)
    assert torch.equal(out, y)
    if kind == "csr":
        acc = torch.full((Ap.num_rows,), 0.5)
        core(*args, out=acc, accumulate=True)
        torch.testing.assert_close(acc, y + 0.5, rtol=RTOL, atol=0)
        with pytest.raises(KernelError, match="accumulate"):
            core(*args, accumulate=True)
    assert core.launches == before


def test_unsupported_formats_raise_jax_message():
    mm = pgen.banded_random(64, 64, 1, seed=5)
    A = DeviceDia.from_host(DiaMatrix.from_matrix_market(mm))
    for fn, args in ((spmv_regular_traffic, (A, None)),
                     (spmv_irregular_traffic, (A, torch.ones(64))),
                     (traffic_variant_bytes, (A,)),
                     (measure_traffic_split, (A,))):
        with pytest.raises(KernelError, match="traffic-isolation variants "
                           "are not defined for DeviceDia"):
            fn(*args)


# The byte model at poisson2d(64, 64), float32: (JAX's, the port's).
# csr: JAX pads the entries to 20,480 and the rows with an overflow row;
# ell: equal here (4,096 rows, a multiple of 8); hybrid: JAX prices its
# empty COO part (1,024 padded entries and a row pointer), the port
# nothing; well: the port counts the 5 live slots of 8 (a window start
# each), the mask and a group a live chunk.
BYTES_64 = {
    "csr": {"stored_entries": (20480, 20224),
            "structure_bytes": (16420, 16388),
            "regular_bytes": (114724, 113668),
            "irregular_bytes": (131108, 130052),
            "full_bytes": (213028, 210948)},
    "ell": {"stored_entries": (20480, 20480), "structure_bytes": (0, 0),
            "regular_bytes": (98304, 98304),
            "irregular_bytes": (114688, 114688),
            "full_bytes": (196608, 196608)},
    "hybrid": {"stored_entries": (21504, 20480),
               "structure_bytes": (16420, 0),
               "regular_bytes": (118820, 98304),
               "irregular_bytes": (135204, 114688),
               "full_bytes": (221220, 196608)},
    "well": {"stored_entries": (32768, 20480),
             "structure_bytes": (1152, 180),
             "index_bytes": (131072, 82560),
             "regular_bytes": (148608, 98484),
             "irregular_bytes": (164992, 115508),
             "full_bytes": (296064, 197428)},
}


@pytest.mark.parametrize("fmt", list(BYTES_64))
def test_byte_model_pinned_beside_jax(fmt):
    jconv = {"csr": JCsr, "ell": JEll, "hybrid": JHybrid, "well": JWell}[fmt]
    pconv = {"csr": CsrMatrix, "ell": EllMatrix, "hybrid": HybridMatrix,
             "well": WellMatrix}[fmt]
    Aj = jdev.device_put_matrix(jconv.from_matrix_market(
        jgen.poisson2d(64, 64)), dtype=jnp.float32)
    Ap = device_put_matrix(pconv.from_matrix_market(pgen.poisson2d(64, 64)),
                           dtype=torch.float32)
    j = jtraffic.traffic_variant_bytes(Aj, jnp.float32)
    p = traffic_variant_bytes(Ap, torch.float32)
    assert set(p) == set(j)
    for key, (want_j, want_p) in BYTES_64[fmt].items():
        assert (j[key], p[key]) == (want_j, want_p), key
    assert p["x_footprint_bytes"] == j["x_footprint_bytes"] == 16384
    assert p["y_bytes"] == j["y_bytes"] == 16384
    # the legs share only the structure and y
    assert (p["regular_bytes"] + p["irregular_bytes"] - p["structure_bytes"]
            - p["y_bytes"] == p["full_bytes"])


def test_ell_byte_model_prices_no_sublane_padding():
    """JAX pads ELL rows to a multiple of 8 (37 rows to 40); the port
    stores and prices the 37."""
    Aj, Ap = _pair("ell")
    j = jtraffic.traffic_variant_bytes(Aj, jnp.float64)
    p = traffic_variant_bytes(Ap, torch.float64)
    L = Ap.padded_row_length
    assert j["stored_entries"] == 40 * L and p["stored_entries"] == 37 * L


@pytest.mark.parametrize("name", ["csr", "ell", "hybrid", "well"])
def test_measure_traffic_split_on_the_cpu(name):
    from spmv_tpu_torch.perfmodel import measured_machine

    Ap = _pair(name)[1]
    out = measure_traffic_split(Ap, runs=2,
                                machine=measured_machine(torch.device("cpu")))
    assert set(out) == {
        "format", "rows", "columns", "stored_entries", "seconds_full",
        "seconds_regular", "seconds_irregular", "regular_fraction_of_full",
        "irregular_fraction_of_full", "additivity", "analytic",
        "achieved_gbps", "roofline_fraction"}
    assert out["format"] == Ap.format_name
    for k in ("seconds_full", "seconds_regular", "seconds_irregular",
              "additivity"):
        assert np.isfinite(out[k]) and out[k] > 0, k
    b = out["analytic"]
    assert b["regular_bytes"] < b["full_bytes"]
    assert b["irregular_bytes"] < b["full_bytes"]


@pytest.fixture(scope="module")
def matrix_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("traffic")
    p = d / "poisson.mtx"
    write_matrix_market(jgen.poisson2d(16, 16), str(p))
    s = d / "scattered.mtx"
    write_matrix_market(jgen.random_sparse(30, 30, 6, seed=21), str(s))
    return str(p), str(s)


def _run(fn, argv):
    out = io.StringIO()
    rc = fn(argv, out=out)
    return rc, out.getvalue()


def _run_f32(argv):
    """Both CLIs in float32: the port's value dtype and the JAX CLI
    without x64."""
    torch.set_default_dtype(torch.float32)     # restored by _fp64
    got = _run(main, argv)
    with jax.enable_x64(False):
        want = _run(jax_main, argv)
    return got, want


@pytest.mark.parametrize("fmt", ["csr", "coo", "ell", "hybrid", "well"])
def test_cli_traffic_split_matches_jax_cli(fmt, matrix_files):
    argv = ["--matrix", matrix_files[1], "-s", fmt, "--profile", "2",
            "--traffic-split"]
    (rc, text), (jrc, jtext) = _run_f32(argv)
    assert rc == jrc == 0
    doc, want = json.loads(text), json.loads(jtext)
    assert set(doc) == set(want)
    ts, jts = doc["traffic_split"], want["traffic_split"]
    assert set(ts) == set(jts)
    for sub in ("analytic", "achieved_gbps", "roofline_fraction"):
        assert set(ts[sub]) == set(jts[sub]), sub
    for k in ("format", "rows", "columns"):
        assert ts[k] == jts[k], k
    assert ts["seconds_regular"] > 0 and ts["seconds_irregular"] > 0


@pytest.mark.parametrize("argv", [
    ["-s", "dia", "--profile", "2", "--traffic-split"],
    ["-s", "wellcw", "--profile", "2", "--traffic-split"],
    ["-s", "bsr", "--profile", "2", "--traffic-split"],
    ["-s", "auto", "--profile", "2", "--traffic-split"],
    ["-s", "csr", "--profile", "2", "--spmm", "4", "--traffic-split"],
    ["--triad", "1024", "--profile", "2", "--traffic-split"],
], ids=lambda a: "_".join(a).replace("-", ""))
def test_cli_refusals_match_jax_cli(argv, matrix_files, capsys):
    full = argv if argv[0] == "--triad" else ["--matrix",
                                              matrix_files[0]] + argv
    (rc, text), (jrc, _) = _run_f32(full)
    err = capsys.readouterr().err
    assert rc == jrc == 1 and text == ""
    lines = err.strip().splitlines()
    assert lines[0].startswith("spmv-tpu-torch: ")
    assert lines[1] == "spmv-tpu: " + lines[0].split(": ", 1)[1]


def test_jax_cli_x64_hybrid_split_fault_not_copied(matrix_files):
    """With x64 on, the JAX CLI's hybrid split raises TypeError (x made
    float32 where the container has no ``value``); the port's runs in
    float64."""
    argv = ["--matrix", matrix_files[1], "-s", "hybrid", "--profile", "2",
            "--traffic-split"]
    with pytest.raises(TypeError, match="carry"):
        _run(jax_main, argv)
    rc, text = _run(main, argv)
    assert rc == 0
    assert json.loads(text)["traffic_split"]["seconds_irregular"] > 0

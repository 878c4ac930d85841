"""The host side of the port's sharded paths against the JAX package.

The row partitioners, ``communication_volume`` and ``build_halo_plan``
must give equal arrays; ``build_exchange_schedule`` equal ``send_idx``,
slots and exchange mode (neighbor, all2all, none); the port's
``exchange_halos`` (one gather over the stacked x by ``receive_index``)
the receive vectors JAX's ``exchange_halos`` gives inside a
``shard_map`` on the 8 virtual CPU devices.  ``--scaling`` runs beside
the JAX CLI: the same keys under the stated mapping (``ici_*`` ->
``interconnect_*``, plus ``interconnect``), equal measured volumes, and
``comm_bytes_per_shard`` equal in float32 and twice JAX's in float64
(the JAX CLI prices 4 bytes at every dtype).  The refusals: non-square
matrices, a DIA halo wider than a shard, a mesh over distinct devices,
more shards than devices.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from spmv_tpu.cli import main as jax_main
from spmv_tpu.io import generate as jgen
from spmv_tpu.models import CsrMatrix as JCsr
from spmv_tpu.models import partition as jpart
from spmv_tpu.parallel import halo as jhalo
from spmv_tpu.parallel import halo_shard as jhs
from spmv_tpu.parallel import make_mesh as jax_mesh
from spmv_tpu_torch.cli import main
from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.io import generate as tgen
from spmv_tpu_torch.io import write_matrix_market
from spmv_tpu_torch.models import CsrMatrix, DiaMatrix
from spmv_tpu_torch.models import partition as tpart
from spmv_tpu_torch.models.device import DEVICE_ENV
from spmv_tpu_torch.parallel import (
    MeshError,
    build_halo_plan,
    communication_volume,
    make_mesh,
    mesh_info,
    shard_csr,
    shard_csr_halo,
    shard_dia,
    stack_vector,
)
from spmv_tpu_torch.parallel.halo_shard import (
    build_exchange_schedule,
    exchange_halos,
    receive_index,
)
from spmv_tpu_torch.perfmodel.scaling import spmv_scaling_model

CPU = torch.device("cpu")

# (generator name, args): the JAX tests' kinds of matrix
MATRICES = {
    "poisson16x8": ("poisson2d", (16, 8), {}),
    "poisson20x20": ("poisson2d", (20, 20), {}),
    "random200": ("random_sparse", (200, 200, 6), {"seed": 7}),
    "powerlaw400": ("powerlaw", (400, 400, 7.0), {"seed": 1}),
}


@pytest.fixture(autouse=True)
def _cpu_fp64(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _pair(name):
    """(port host CSR, JAX host CSR) of the same generated matrix."""
    gen, args, kw = MATRICES[name]
    return (CsrMatrix.from_matrix_market(getattr(tgen, gen)(*args, **kw)),
            JCsr.from_matrix_market(getattr(jgen, gen)(*args, **kw)))


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("parts", [1, 2, 3, 8])
def test_partitions_and_volume_match_jax(name, parts):
    m, jm = _pair(name)
    np.testing.assert_array_equal(
        tpart.rows_partition_equal(m.num_rows, parts),
        jpart.rows_partition_equal(jm.num_rows, parts))
    bounds = tpart.rows_partition_balanced_nnz(m.row_ptr, parts)
    np.testing.assert_array_equal(
        bounds, jpart.rows_partition_balanced_nnz(jm.row_ptr, parts))
    np.testing.assert_array_equal(
        tpart.nnz_per_part(m.row_ptr, bounds),
        jpart.nnz_per_part(jm.row_ptr, bounds))
    np.testing.assert_array_equal(tpart.partition_bounds_to_sizes(bounds),
                                  jpart.partition_bounds_to_sizes(bounds))
    vol, jvol = (communication_volume(m, bounds),
                 jhalo.communication_volume(jm, bounds))
    assert set(vol) == set(jvol)
    np.testing.assert_array_equal(vol.pop("need"), jvol.pop("need"))
    assert vol == jvol
    plan, jplan = build_halo_plan(m, bounds), jhalo.build_halo_plan(jm,
                                                                    bounds)
    assert plan.local_slices == jplan.local_slices
    assert plan.max_halo() == jplan.max_halo()
    for a, b in zip(plan.halo_indices + plan.halo_sources,
                    jplan.halo_indices + jplan.halo_sources):
        np.testing.assert_array_equal(a, b)


SCHEDULES = [
    ("poisson20x20", 8, "auto", "neighbor"),
    ("poisson20x20", 8, "all2all", "all2all"),
    ("random200", 8, "auto", "all2all"),
    ("random200", 3, "neighbor", "neighbor"),   # forced: D = 2
    ("powerlaw400", 4, "auto", "neighbor"),
    ("poisson16x8", 1, "auto", "none"),
]


def _schedules(name, parts, exchange):
    m, _ = _pair(name)
    bounds = tpart.rows_partition_balanced_nnz(m.row_ptr, parts)
    needs = list(build_halo_plan(m, bounds).halo_indices)
    return (bounds, build_exchange_schedule(needs, bounds, exchange),
            jhs.build_exchange_schedule(needs, bounds, exchange))


@pytest.mark.parametrize("name,parts,exchange,mode", SCHEDULES)
def test_exchange_schedule_matches_jax(name, parts, exchange, mode):
    _, s, js = _schedules(name, parts, exchange)
    assert s.exchange == js.exchange == mode
    for f in ("num_shards", "max_distance", "halo_slots", "num_strips",
              "comm_elements_exact", "comm_elements_padded"):
        assert getattr(s, f) == getattr(js, f), f
    np.testing.assert_array_equal(s.send_idx, js.send_idx)
    for a, b in zip(s._needs + s._slots, js._needs + js._slots):
        np.testing.assert_array_equal(a, b)


def _jax_received(js, x_stacked):
    """JAX's receive vectors: its ``exchange_halos`` in a shard_map over
    the first P virtual CPU devices."""
    P = js.num_shards
    mesh = jax_mesh(P)

    def body(x, idx):
        return jhs.exchange_halos(
            x[0], idx[0], "shards", exchange=js.exchange, num_shards=P,
            max_distance=js.max_distance)[None]

    spec = PartitionSpec("shards")
    fn = jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                       out_specs=spec)
    return np.asarray(fn(jnp.asarray(x_stacked), jnp.asarray(js.send_idx)))


@pytest.mark.parametrize("name,parts,exchange,mode",
                         [c for c in SCHEDULES if c[3] != "none"])
@pytest.mark.parametrize("k", [0, 3])
def test_exchange_halos_match_jax(name, parts, exchange, mode, k):
    """The port's one gather by ``receive_index`` gives every shard the
    receive vector JAX's collective gives it, zeros where no shard
    sends, for vectors (P, R) and blocks (P, R, k)."""
    bounds, s, js = _schedules(name, parts, exchange)
    R = int(np.diff(bounds).max()) + 8
    rng = np.random.default_rng(5)
    x = rng.standard_normal((parts, R) + ((k,) if k else ()))
    index = receive_index(s.send_idx, R, s.exchange, s.max_distance)
    missing = index < 0
    got = exchange_halos(torch.from_numpy(x),
                         torch.from_numpy(np.maximum(index, 0)),
                         torch.from_numpy(missing) if missing.any()
                         else None)
    np.testing.assert_array_equal(got.numpy(), _jax_received(js, x))
    assert missing.any() == (mode == "neighbor")


def _run(fn, argv):
    out = io.StringIO()
    rc = fn(argv, out=out)
    return rc, (json.loads(out.getvalue()) if rc == 0 else None)


# the JAX report's ICI-named keys and the port's
KEY_MAP = {"ici_efficiency_breakeven": "interconnect_efficiency_breakeven",
           "ici_efficiency_assumed": "interconnect_efficiency_assumed"}


@pytest.fixture(scope="module")
def scaling_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scaling")
    out = {}
    for name, mm in (("poisson", tgen.poisson2d(24, 24)),
                     ("powerlaw", tgen.powerlaw(600, 600, 8.0, seed=5))):
        out[name] = str(d / f"{name}.mtx")
        write_matrix_market(mm, out[name])
    return out


@pytest.mark.parametrize("matrix,fmt,parts", [
    ("poisson", "dia", 4), ("poisson", "csr", 8), ("powerlaw", "csr", 4),
    ("powerlaw", "ell", 2), ("poisson", "wellcw", 1)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_scaling_report_matches_jax_cli(matrix, fmt, parts, dtype,
                                        scaling_files):
    argv = ["--matrix", scaling_files[matrix], "-s", fmt, "--scaling",
            str(parts)]
    torch.set_default_dtype(getattr(torch, dtype))    # restored by fixture
    rc, doc = _run(main, argv)
    with jax.enable_x64(dtype == "float64"):
        jrc, want = _run(jax_main, argv)
    assert rc == jrc == 0
    assert doc["kernel"] == want["kernel"]
    got, want = doc["scaling"], want["scaling"]
    assert set(got) == {KEY_MAP.get(k, k) for k in want} | {"interconnect"}
    for key in ("halo_elements_measured", "all_gather_elements",
                "rows_per_shard", "num_shards", "scheme",
                "weak_scaling_target"):
        assert got[key] == want[key], key
    assert (got["interconnect_efficiency_assumed"]
            == want["ici_efficiency_assumed"])
    scale = 2 if dtype == "float64" else 1
    assert got["comm_bytes_per_shard"] == scale * want["comm_bytes_per_shard"]
    assert got["interconnect"]["gbps_both_directions"] == 900.0
    assert 0 < got["t_local_s"] <= got["t_step_s"]


def test_scaling_report_counts_the_host_volume(scaling_files):
    """``halo_elements_measured`` is the worst shard's off-shard distinct
    reads of the nnz-balanced partition, as ``communication_volume``
    counts them."""
    rc, doc = _run(main, ["--matrix", scaling_files["powerlaw"], "-s",
                          "csr", "--scaling", "4"])
    assert rc == 0
    m = CsrMatrix.from_matrix_market(tgen.powerlaw(600, 600, 8.0, seed=5))
    need = communication_volume(
        m, tpart.rows_partition_balanced_nnz(m.row_ptr, 4))["need"]
    assert doc["scaling"]["halo_elements_measured"] == int(
        (need.sum(axis=1) - np.diag(need)).max())


@pytest.mark.parametrize("scheme", ["dia-halo", "ragged-halo", "all-gather"])
@pytest.mark.parametrize("parts", [1, 4])
def test_scaling_model_prices_the_link(scheme, parts):
    """The comm bytes are JAX's; the time is the bytes over NVLink's
    450 GB/s a direction times the assumed 0.70; the breakeven is the
    efficiency at which the weak efficiency meets 0.80."""
    from spmv_tpu.perfmodel.scaling import spmv_scaling_model as jax_model
    from spmv_tpu_torch.perfmodel.machine import GpuMachineModel

    machine = GpuMachineModel("H100 (test)", 3000.0, 3000.0, 67e12, 989e12,
                              datasheet_hbm_gbps=3350.0)
    kw = dict(num_shards=parts, rows_per_shard=1 << 20, num_diagonals=5,
              halo=4096, value_bytes=8, scheme=scheme)
    got, want = spmv_scaling_model(machine=machine, **kw), jax_model(**kw)
    assert got.comm_bytes_per_shard == want.comm_bytes_per_shard
    assert got.t_local_s == pytest.approx(7 * 8 * (1 << 20) / 3000e9)
    assert got.t_comm_s == pytest.approx(got.comm_bytes_per_shard
                                         / (450e9 * 0.70))
    assert got.hbm_efficiency_measured == pytest.approx(3000 / 3350)
    if got.comm_bytes_per_shard:
        e = got.interconnect_efficiency_breakeven
        t_comm = got.comm_bytes_per_shard / (450e9 * e)
        step = (max(got.t_local_s, t_comm) if scheme != "all-gather"
                else got.t_local_s + t_comm)
        assert got.t_local_s / step == pytest.approx(0.80)
    else:
        assert got.interconnect_efficiency_breakeven == 0.0


def test_refusals():
    """Non-square matrices, a DIA halo wider than a shard's rows, a mesh
    over distinct devices, and more shards than devices."""
    rect = CsrMatrix.from_matrix_market(tgen.random_sparse(64, 256, 3,
                                                           seed=2))
    mesh = make_mesh(2, devices=[CPU] * 2)
    for build in (shard_csr, shard_csr_halo):
        with pytest.raises(MatrixError, match="square"):
            build(rect, 2, mesh=mesh)
    with pytest.raises(MatrixError, match="square"):
        shard_dia(DiaMatrix.from_matrix_market(tgen.random_sparse(
            64, 60, 3, seed=2)), 2, mesh=mesh)
    # poisson2d(200, 2): halo 200 against 128 rows a shard at P = 4
    with pytest.raises(MatrixError, match="halo 200 exceeds rows per "
                                          "shard 128"):
        shard_dia(DiaMatrix.from_matrix_market(tgen.poisson2d(200, 2)), 4,
                  mesh=make_mesh(4, devices=[CPU] * 4))
    with pytest.raises(MeshError, match="ROADMAP"):
        make_mesh(2, devices=[torch.device("cuda", 0),
                              torch.device("cuda", 1)])
    with pytest.raises(ValueError, match="requested 3 shards but only 2"):
        make_mesh(3, devices=[CPU] * 2)
    A = shard_csr(CsrMatrix.from_matrix_market(tgen.poisson2d(8, 8)), 2,
                  mesh=mesh)
    with pytest.raises(ValueError, match="does not hold"):
        stack_vector(np.ones(64), A, make_mesh(4, devices=[CPU] * 4))
    assert mesh_info(make_mesh(8, devices=[CPU] * 8)) == {
        "axis_names": ["shards"], "shape": {"shards": 8}, "num_devices": 8,
        "device_kinds": ["cpu"], "num_processes": 1}

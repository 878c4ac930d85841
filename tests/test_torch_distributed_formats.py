"""The second half of the process mesh: the WELL, WELL-CW and BSR paths,
block-Jacobi IC(0) and the remaining solvers across ``torch.distributed``
ranks, against the JAX package's 8-device functions and the port's own
single-process mesh.

A module fixture starts two Gloo jobs on the CPU at once, of 2 and 4
ranks, each over a mesh of P = 8 shards, each rank a process of
``tests/_torch_mp_worker.py formats`` with a ``file://`` store, float64
and ``SPMV_TPU_TORCH_DEVICE=cpu``; while they run, it computes every
case on the single-process mesh and through JAX.  A rank that exits with
an error, or a job that outlasts ``WALL_S``, fails the tests: no case
skips.  Every rank computes the worker's ``FORMAT_CASES`` on the
matrices of ``tests/test_torch_shard_formats.py`` and
``tests/test_torch_shard_solvers.py`` (the WELL all-gather and halo
SpMV, the WELL-CW halo SpMV and SpMM and the BSR halo SpMM, each
exchange forced; the block-IC(0) apply; block-IC(0) PCG, Chebyshev with
``lanczos_bounds``, ``lanczos_bounds`` from its own global draw, GMRES,
BiCGSTAB plain and with block-IC(0), and masked LOBPCG with JAX's random
P, each over the halo CSR), then ``dryrun_multichip(8)``.  Stacked in
rank order, the rows are held:

- against JAX: products at rtol 1e-12; every rank's envelope and
  exchange numbers equal to JAX's container's; solvers at JAX's
  iteration counts on every rank, x at rtol 1e-10; LOBPCG at tol 1e-5,
  its count JAX's and its eigenvalues at rtol 1e-10; the Lanczos bounds
  at rtol 1e-10;
- against ``run_format_case`` on the port's single-process mesh of 8
  virtual shards: every product bitwise, every rank's unstacked result
  too; solvers at equal counts, x at rtol 1e-10 (a rank's dots are
  all-reduced, so they sum in another order), and every rank's
  unstacked x (LOBPCG: eigenvalues) bitwise every other rank's;
- two ranks' PCG and BiCGSTAB bitwise that mesh's when its dots sum in
  the ranks' order;
- the dryrun's dict equal on every rank, each of its eleven strategies
  within its bound.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_mp_worker as worker

from spmv_tpu import ops as jops
from spmv_tpu import parallel as jpar
from spmv_tpu.io import generate as jgen
from spmv_tpu.models import CsrMatrix as JCsr
from spmv_tpu.models.bsr import BsrMatrix as JBsr
from spmv_tpu.parallel import bsr_shard as jbsr
from spmv_tpu.parallel import precond_shard as jpre
from spmv_tpu_torch import parallel as tpar
from spmv_tpu_torch.io import generate as tgen
from spmv_tpu_torch.models import CsrMatrix
from spmv_tpu_torch.models.device import DEVICE_ENV
from spmv_tpu_torch.parallel.dryrun import MAX_EIG_REL_ERR, MAX_REL_ERR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mp_worker.py")
CPU = torch.device("cpu")
WORLDS = (2, 4)
WALL_S = 120
P = worker.P
NAMES = {worker.case_name(c): c for c in worker.FORMAT_CASES}
# the cases JAX computes too (LOBPCG's own draw of P is the port's)
AGAINST_JAX = [n for n in NAMES if not n.startswith("lobpcg_draw")]
# the solvers whose every reduction is ``ops.solvers._vdot``
RANK_ORDER = ("ic0_pcg-aniso24", "bicgstab-poisson16",
              "bicgstab_ic0-aniso24")
STRATEGIES = ("csr_all_gather", "dia_halo", "csr_halo", "well_halo",
              "wellcw_halo", "bsr_halo", "chebyshev", "jacobi_pcg",
              "batched_dia_halo", "block_ic0_pcg", "lobpcg")


@pytest.fixture(autouse=True)
def _cpu_fp64(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _jax_p0(n: int, k: int) -> np.ndarray:
    """The JAX LOBPCG's random P block."""
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (n, k),
                                      jnp.float64))


def _csrs(mat):
    gen, args, kw = worker.MATS[mat]
    mm, jmm = (getattr(tgen, gen)(*args, **kw),
               getattr(jgen, gen)(*args, **kw))
    return CsrMatrix.from_matrix_market(mm), JCsr.from_matrix_market(jmm), jmm


def _np_stack(v, JA):
    """Rows of v in the stacked (P, R, ...) layout of a halo CSR
    container."""
    v = np.asarray(v)
    out = np.zeros((P, JA.rows_per_shard) + v.shape[1:])
    for p in range(P):
        out[p, : JA.bounds[p + 1] - JA.bounds[p]] = \
            v[JA.bounds[p]: JA.bounds[p + 1]]
    return jnp.asarray(out)


HALO = ("exchange", "max_distance", "halo_slots", "comm_elements_exact",
        "comm_elements_padded")


def _jax_case(case, single, jmesh) -> dict:
    """JAX's 8-device result of a case: {"rows": stacked output (x for a
    solver, eigenvalues for LOBPCG), "iterations", "envelope": its
    container's numbers, "bounds"}."""
    kind, mat, exchange = case
    m, jm, jmm = _csrs(mat)
    ex = exchange or "auto"
    path = kind.split("_")[0]
    inp = jnp.asarray(single["input"])
    if kind.endswith(("spmv", "spmm")):
        if path == "well":
            JA = jpar.shard_well(jm, P, window_rows=worker.WINDOW_ROWS,
                                 mesh=jmesh)
            fn, fields = jpar.sharded_well_spmv, (
                "rows_per_shard", "chunks_per_shard", "spill_per_shard")
        elif path == "wellhalo":
            JA = jpar.shard_well_halo(jm, P, window_rows=worker.WINDOW_ROWS,
                                      mesh=jmesh, exchange=ex)
            fn, fields = jpar.sharded_well_halo_spmv, ("rows_per_shard",) \
                + HALO
        elif path == "wellcw":
            JA = jpar.shard_wellcw_halo(jm, P, mesh=jmesh, exchange=ex)
            fn = (jpar.sharded_wellcw_halo_spmm if kind.endswith("spmm")
                  else jpar.sharded_wellcw_halo_spmv)
            fields = ("rows_per_shard",) + HALO
        else:
            JA = jbsr.shard_bsr_halo(JBsr.from_matrix_market(
                jmm, block_rows=worker.BSR_ROWS), P, mesh=jmesh, exchange=ex)
            fn, fields = jbsr.sharded_bsr_spmm, (
                "rows_per_shard", "interior_per_shard", "boundary_per_shard",
                "comm_blocks_exact") + HALO
        y = jax.jit(lambda v: fn(JA, v, jmesh))(inp)
        return {"rows": np.asarray(y), "iterations": None,
                "envelope": {f: getattr(JA, f) for f in fields}}
    JA = jpar.shard_csr_halo(jm, P, mesh=jmesh)
    env = {f: getattr(JA, f) for f in ("rows_per_shard",) + HALO}
    jmv = jpar.make_sharded_halo_matvec(JA, jmesh)
    R = JA.rows_per_shard
    out = {"iterations": None, "envelope": env, "bounds": None}
    if "ic0" in kind:
        JM = jpre.block_jacobi_ic0(jm, JA.bounds, R, mesh=jmesh)
        env.update(shift_used=JM.shift_used, num_levels=JM.num_levels,
                   width=JM.width, max_deps=JM.max_deps)
    if kind == "ic0_apply":
        out["rows"] = np.asarray(jax.jit(
            lambda v: jpre.sharded_block_ic0_apply(JM, v, jmesh))(inp))
        return out
    if kind == "lanczos":
        out["bounds"] = jops.lanczos_bounds(
            jmv, (P, R), num_steps=worker.LANCZOS_STEPS, dtype=jnp.float64)
        out["rows"] = np.zeros(0)
        return out
    if kind == "lobpcg":
        k = worker.EIG_K
        jmm_ = jpar.make_sharded_halo_matmat(JA, jmesh)
        mask = jnp.asarray(tpar.halo_shard.stacked_row_mask(
            tpar.shard_csr_halo(m, P, mesh=tpar.make_mesh(
                P, devices=[CPU] * P))).numpy())
        r = jax.jit(lambda V: jops.lobpcg(
            lambda W: jmm_(W.reshape(P, R, k)).reshape(P * R, k), V,
            tol=worker.EIG_TOL, max_iterations=worker.EIG_MAX,
            mask=mask))(inp.reshape(P * R, k))
        out.update(rows=np.asarray(r.eigenvalues),
                   iterations=int(r.iterations))
        return out
    if kind == "ic0_pcg":
        pre = jpre.make_sharded_block_ic0_preconditioner(JM, jmesh)
        r = jax.jit(lambda v: jops.preconditioned_conjugate_gradient(
            jmv, v, pre, tol=worker.SOLVER_TOL, max_iterations=2000))(inp)
    elif kind == "chebyshev":
        v0 = _np_stack(np.random.default_rng(4).standard_normal(m.num_rows),
                       JA)
        lo, hi = jops.lanczos_bounds(jmv, (P, R),
                                     num_steps=worker.LANCZOS_STEPS,
                                     dtype=jnp.float64, v0=v0)
        out["bounds"] = (lo, hi)
        r = jax.jit(lambda v: jops.chebyshev(
            jmv, v, lo, hi, tol=worker.SOLVER_TOL, max_iterations=3000,
            check_every=10))(inp)
    elif kind == "gmres":
        r = jax.jit(lambda v: jops.gmres(
            jmv, v, tol=worker.SOLVER_TOL, restart=8,
            max_iterations=500))(inp)
    else:
        pre = (jpre.make_sharded_block_ic0_preconditioner(JM, jmesh)
               if kind == "bicgstab_ic0" else None)
        r = jax.jit(lambda v: jops.bicgstab(
            jmv, v, pre, tol=worker.SOLVER_TOL, max_iterations=500))(inp)
    out.update(rows=np.asarray(r.x), iterations=int(r.iterations))
    return out


def _start(world, out, env) -> list:
    return [subprocess.Popen(
        [sys.executable, WORKER, str(out / "store"), str(world), str(rank),
         str(out), "formats"], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": {world: (out dir, [meta of each rank])}, "single": {name:
    run_format_case on the single-process mesh}, "jax": {name: JAX's
    result}}.  The jobs run while this process computes the other two."""
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env[DEVICE_ENV] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "LOCAL_RANK"):
        env.pop(name, None)
    m, _, _ = _csrs("poisson16")
    R = tpar.shard_csr_halo(m, P, mesh=tpar.make_mesh(
        P, devices=[CPU] * P)).rows_per_shard
    p0 = _jax_p0(P * R, worker.EIG_K)
    jobs, procs = {}, []
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"formats{world}")
        np.save(out / "lobpcg_p0.npy", p0)
        jobs[world] = str(out)
        procs += _start(world, out, env)
    deadline = time.monotonic() + WALL_S
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(DEVICE_ENV, "cpu")
            torch.set_default_dtype(torch.float64)
            torch.set_num_threads(1)
            mesh = tpar.make_mesh(P, devices=[CPU] * P)
            single = {n: worker.run_format_case(c, mesh, p0)
                      for n, c in NAMES.items()}
            torch.set_num_threads(threads)
            jmesh = jpar.make_mesh(P)
            ref = {n: _jax_case(NAMES[n], single[n], jmesh)
                   for n in AGAINST_JAX}
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))
                for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank outlasted {WALL_S} s")
    finally:
        torch.set_default_dtype(dtype)
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank {p.args[3:5]} failed:\n{err[-3000:]}"
    ranks = {}
    for world, out in jobs.items():
        metas = []
        for rank in range(world):
            with open(os.path.join(out, f"meta.r{rank}.json")) as f:
                metas.append(json.load(f))
        ranks[world] = (out, metas)
    return {"ranks": ranks, "single": single, "jax": ref}


def _rows(runs, world, name, full=False):
    """Every rank's rows of a case stacked in rank order, or each rank's
    unstacked whole result (``full``)."""
    out, _ = runs["ranks"][world]
    tag = ".full" if full else ""
    got = [np.load(os.path.join(out, f"{name}{tag}.r{r}.npy"))
           for r in range(world)]
    return got if full else np.concatenate(got)


def _close(got, want, rtol):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _bounds_close(got, want):
    """Lanczos bounds: the ceiling at rtol 1e-10; the floor within 1e-10
    of the ceiling (from a start with padding it is a rounding-level
    Ritz value, clamped positive)."""
    lo, hi = want
    np.testing.assert_allclose(got[1], hi, rtol=1e-10)
    assert abs(got[0] - lo) <= 1e-10 * hi


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", AGAINST_JAX)
def test_ranks_match_jax(runs, world, name):
    want = runs["jax"][name]
    metas = runs["ranks"][world][1]
    if name.startswith("lanczos"):
        for meta in metas:
            _bounds_close(meta["envelope"][name]["bounds"], want["bounds"])
        return
    if want["iterations"] is None:
        _close(_rows(runs, world, name), want["rows"], 1e-12)
        return
    assert all(meta["iterations"][name] == want["iterations"]
               for meta in metas)
    assert want["iterations"] < 2000
    if name.startswith("lobpcg"):
        for vals in _rows(runs, world, name, full=True):
            np.testing.assert_allclose(vals, want["rows"], rtol=1e-10)
        return
    _close(_rows(runs, world, name), want["rows"], 1e-10)
    if want["bounds"] is not None:
        for meta in metas:
            np.testing.assert_allclose(meta["envelope"][name]["bounds"],
                                       want["bounds"], rtol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", AGAINST_JAX)
def test_every_rank_reports_jax_envelope(runs, world, name):
    """Each rank sees only its own shards, yet reports the JAX
    container's numbers over all of them."""
    want = runs["jax"][name]["envelope"]
    for meta in runs["ranks"][world][1]:
        got = {k: v for k, v in meta["envelope"][name].items()
               if k != "bounds"}
        assert got == want


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(NAMES))
def test_ranks_match_the_single_process_mesh(runs, world, name):
    want = runs["single"][name]
    got = _rows(runs, world, name)
    metas = runs["ranks"][world][1]
    fulls = _rows(runs, world, name, full=True)
    if want["iterations"] is None and not name.startswith("lanczos"):
        assert got.dtype == want["rows"].dtype
        assert np.array_equal(got, want["rows"])        # bitwise
        for full in fulls:
            assert np.array_equal(full, want["full"])
        return
    # every rank the same result, bit for bit: its dots are all-reduced
    for full in fulls[1:]:
        assert np.array_equal(full, fulls[0])
    if name.startswith("lanczos"):
        _bounds_close(fulls[0], want["full"])
        return
    assert all(m["iterations"][name] == want["iterations"] for m in metas)
    if name.startswith("lobpcg"):
        np.testing.assert_allclose(fulls[0], want["full"], rtol=1e-10)
        return
    _close(got, want["rows"], 1e-10)
    _close(fulls[0], want["full"], 1e-10)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_dryrun_across_ranks(runs, world, strategy):
    """``dryrun_multichip(8)`` over the ranks: every rank's dict the same,
    the strategy within its bound."""
    metas = runs["ranks"][world][1]
    got = metas[0]["dryrun"][strategy]
    assert all(m["dryrun"][strategy] == got for m in metas)
    bound = MAX_EIG_REL_ERR if strategy == "lobpcg" else MAX_REL_ERR
    assert got["rel_err"] < bound


@pytest.mark.parametrize("name", RANK_ORDER)
def test_two_ranks_are_one_process_summing_in_their_order(runs, name,
                                                          monkeypatch):
    """Two ranks' solve is bitwise the single-process mesh's whose every
    dot sums each rank's rows and then the two sums, as the all-reduce
    does: where a count moves with the order of the sums (BiCGSTAB's),
    it moves with that order alone."""
    from spmv_tpu_torch.ops import solvers

    def in_rank_order(a, b, mesh=None):
        a, b = a.reshape(2, -1), b.reshape(2, -1)
        return torch.dot(a[0], b[0]) + torch.dot(a[1], b[1])

    monkeypatch.setattr(solvers, "_vdot", in_rank_order)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = worker.run_format_case(NAMES[name], tpar.make_mesh(
            P, devices=[CPU] * P))
    finally:
        torch.set_num_threads(threads)
    assert np.array_equal(_rows(runs, 2, name), want["rows"])
    assert all(m["iterations"][name] == want["iterations"]
               for m in runs["ranks"][2][1])

"""The port's process mesh (``parallel.distributed``, ``parallel.comm``)
against the JAX package's sharded functions and the port's own
single-process mesh.

A module fixture starts three Gloo jobs on the CPU at once, of 1, 2 and
4 ranks, each over a mesh of P = 8 shards (the JAX mp worker's 2 x 4
and 4 x 2, and one rank holding all 8 through the group's collectives),
each rank a process of ``tests/_torch_mp_worker.py`` with a ``file://``
store, float64 and ``SPMV_TPU_TORCH_DEVICE=cpu``.  A rank that exits
with an error, or a job that outlasts ``WALL_S``, fails the tests: no
case skips.  Every rank computes the worker's cases (the DIA halo SpMV
and SpMM at poisson2d(16, 16) and (32, 32); the all-gather CSR SpMV;
the halo CSR SpMV and SpMM with ``neighbor`` and ``all2all`` forced on
banded_random(256, 80, 6), whose strips come from up to 3 shards away;
CG over the three paths, Jacobi-PCG and batched CG at k = 2 over DIA
and the halo CSR at poisson2d(16, 16)) and writes its shards' rows.
Stacked in rank order, the rows are held:

- against JAX's sharded functions on its 8 virtual CPU devices, as
  ``tests/test_torch_shard.py`` holds the single-process mesh: products
  at rtol 1e-12, solvers at JAX's iteration counts with x at rtol 1e-10;
- against ``run_case`` on the port's single-process mesh of 8 virtual
  shards: products and the halo receive buffers bitwise, every rank's
  unstacked vector too; solvers at equal counts, x at rtol 1e-10 (a
  rank's dots are all-reduced, so they sum in another order).

In one process: ``initialize_distributed`` without an address,
``host_local_info``'s keys, the meshes that raise ``MeshError``, a
container built on one process and handed a mesh that claims two ranks,
the solvers that reduce over the process mesh their closure carries (and
refuse another ``mesh=``), and block-Jacobi IC(0)'s shift ladder agreed
across ranks (a fake group whose all-reduce a test plays: nothing is
spawned).
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
from spmv_tpu.models import DiaMatrix as JDia
from spmv_tpu_torch import ops as tops
from spmv_tpu_torch import parallel as tpar
from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.io import generate as tgen
from spmv_tpu_torch.models import CsrMatrix
from spmv_tpu_torch.models.device import DEVICE_ENV
from spmv_tpu_torch.parallel import Mesh, MeshError, distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mp_worker.py")
CPU = torch.device("cpu")
WORLDS = (1, 2, 4)
WALL_S = 120
P = worker.P


@pytest.fixture(autouse=True)
def _cpu_fp64(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world size: (out dir, [meta of each rank])} of the three jobs."""
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env[DEVICE_ENV] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "LOCAL_RANK"):
        env.pop(name, None)
    jobs, procs = {}, []
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"world{world}")
        jobs[world] = str(out)
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(out / "store"), str(world),
                 str(rank), str(out)], env=env, cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + WALL_S
    try:
        outs = [p.communicate(timeout=max(deadline - time.monotonic(), 1))
                for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank outlasted {WALL_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank {p.args[3:5]} failed:\n{err[-3000:]}"
    result = {}
    for world, out in jobs.items():
        metas = []
        for rank in range(world):
            with open(os.path.join(out, f"meta.r{rank}.json")) as f:
                metas.append(json.load(f))
        result[world] = (out, metas)
    return result


def _rows(ranks, world, name, full=False):
    """Every rank's rows of a case stacked in rank order, or each rank's
    unstacked whole vector (``full``)."""
    out, _ = ranks[world]
    tag = ".full" if full else ""
    got = [np.load(os.path.join(out, f"{name}{tag}.r{r}.npy"))
           for r in range(world)]
    return got if full else np.concatenate(got)


def _close(got, want, rtol):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


_SINGLE, _JAX = {}, {}


def _single(case):
    """``run_case`` on the port's single-process mesh of P virtual
    shards."""
    if case not in _SINGLE:
        _SINGLE[case] = worker.run_case(
            case, tpar.make_mesh(P, devices=[CPU] * P))
    return _SINGLE[case]


def _np_stack(v, JA):
    """Rows of v in JAX's stacked (P, R, ...) layout of a CSR container."""
    v = np.asarray(v)
    out = np.zeros((P, JA.rows_per_shard) + v.shape[1:])
    for p in range(P):
        out[p, : JA.bounds[p + 1] - JA.bounds[p]] = \
            v[JA.bounds[p]: JA.bounds[p + 1]]
    return jnp.asarray(out)


def _jax(case):
    """(stacked rows, iterations) of JAX's sharded function of a case on
    P of its virtual CPU devices."""
    if case in _JAX:
        return _JAX[case]
    kind, mat, exchange = case
    gen, args, kw = worker.MATS[mat]
    mm = getattr(jgen, gen)(*args, **kw)
    jm, jd = JCsr.from_matrix_market(mm), JDia.from_matrix_market(mm)
    host = CsrMatrix.from_matrix_market(getattr(tgen, gen)(*args, **kw))
    got = worker.inputs(kind, host)
    jmesh = jpar.make_mesh(P)
    path = kind.split("_")[-1] if kind[:3] in ("cg_", "pcg", "bcg") \
        else kind.split("_")[0]
    if path == "dia":
        JA = jpar.shard_dia(jd, P)
        stack = lambda v: jpar.stack_dia_vector(jnp.asarray(v), JA)  # noqa
        mv, product = jpar.make_sharded_dia_matvec(JA, jmesh), None
        if kind == "dia_spmm":
            product = jpar.sharded_dia_spmm
            stacked = jpar.stack_dia_matrix(jnp.asarray(got["X"]), JA)
    elif path == "csr":
        JA = jpar.shard_csr(jm, P, mesh=jmesh)
        stack = lambda v: _np_stack(v, JA)       # noqa: E731
        mv = jpar.make_sharded_matvec(JA, jmesh)
    else:
        JA = jpar.shard_csr_halo(jm, P, mesh=jmesh,
                                 exchange=exchange or "auto")
        stack = lambda v: _np_stack(v, JA)       # noqa: E731
        mv = jpar.make_sharded_halo_matvec(JA, jmesh)
        if kind == "halo_spmm":
            product = jpar.sharded_halo_spmm
            stacked = _np_stack(got["X"], JA)
    if kind.endswith("spmv"):
        res = (np.asarray(jax.jit(mv)(stack(got["x"]))), None)
    elif kind.endswith("spmm"):
        res = (np.asarray(jax.jit(lambda V: product(JA, V, jmesh))(stacked)),
               None)
    elif kind.startswith("bcg"):
        if path == "dia":
            mm_ = jpar.make_sharded_dia_matmat(JA, jmesh)
            Bs = jpar.stack_dia_matrix(jnp.asarray(got["B"]), JA)
        else:
            hm = jpar.make_sharded_halo_matmat(JA, jmesh)

            def mm_(V):
                return jnp.swapaxes(hm(jnp.swapaxes(V, 1, 2)), 1, 2)

            Bs = jnp.swapaxes(_np_stack(got["B"], JA), 1, 2)
        r = jax.jit(lambda V: jops.batched_conjugate_gradient(
            mm_, V, tol=worker.TOL,
            max_iterations=worker.MAX_ITERATIONS))(Bs)
        res = (np.asarray(r.x), [int(i) for i in r.iterations])
    else:
        bs = stack(got["b"])
        if kind.startswith("pcg"):
            pre = jops.jacobi_preconditioner(
                stack(tops.extract_diagonal(host)))
            r = jax.jit(lambda v: jops.preconditioned_conjugate_gradient(
                mv, v, pre, tol=worker.TOL,
                max_iterations=worker.MAX_ITERATIONS))(bs)
        else:
            r = jax.jit(lambda v: jops.conjugate_gradient(
                mv, v, tol=worker.TOL,
                max_iterations=worker.MAX_ITERATIONS))(bs)
        res = (np.asarray(r.x), int(r.iterations))
    _JAX[case] = res
    return res


NAMES = {worker.case_name(c): c for c in worker.CASES}
AGAINST_JAX = [worker.case_name(c) for c in worker.PRODUCTS + worker.SOLVERS]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", AGAINST_JAX)
def test_ranks_match_jax(ranks, world, name):
    case = NAMES[name]
    want, iterations = _jax(case)
    got = _rows(ranks, world, name)
    if iterations is None:
        _close(got, want, 1e-12)
        return
    assert ranks[world][1][0]["iterations"][name] == iterations
    assert max(np.max(iterations), 0) < worker.MAX_ITERATIONS
    _close(got, want, 1e-10)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(NAMES))
def test_ranks_match_the_single_process_mesh(ranks, world, name):
    case = NAMES[name]
    want = _single(case)
    got = _rows(ranks, world, name)
    metas = ranks[world][1]
    if want["iterations"] is None:
        assert got.dtype == want["rows"].dtype
        assert np.array_equal(got, want["rows"])        # bitwise
    else:
        assert all(m["iterations"][name] == want["iterations"]
                   for m in metas)
        _close(got, want["rows"], 1e-10)
    if want["full"] is not None:
        for full in _rows(ranks, world, name, full=True):
            if want["iterations"] is None:
                assert np.array_equal(full, want["full"])
            else:
                _close(full, want["full"], 1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_know_their_place(ranks, world):
    """Each rank holds its contiguous block of P / world_size shards, rank
    0's first, and reports JAX's keys of ``host_local_info``."""
    spr = P // world
    for rank, meta in enumerate(ranks[world][1]):
        assert meta["local_shards"] == [rank * spr, (rank + 1) * spr]
        assert meta["info"] == {"process_index": rank,
                                "process_count": world,
                                "local_device_count": 1,
                                "global_device_count": world}
        assert meta["mesh_info"]["num_processes"] == world
        assert meta["mesh_info"]["shape"] == {"shards": P}


def test_initialize_without_an_address_is_a_noop(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert tpar.initialize_distributed() is False
    assert tpar.initialize_distributed() is False       # idempotent
    assert not torch.distributed.is_initialized()
    assert not tpar.is_multi_host()
    mesh = tpar.global_mesh(4)
    assert (mesh.size, mesh.world_size, mesh.group) == (4, 1, None)


def test_initialize_needs_rank_and_world_size(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="world size"):
        tpar.initialize_distributed("file:///nowhere", world_size=2)
    assert not torch.distributed.is_initialized()


def test_a_local_rank_without_a_card_raises(monkeypatch):
    """Rank r runs on cuda:LOCAL_RANK: past the visible cards it raises
    rather than share one or fall back to the CPU."""
    monkeypatch.delenv(DEVICE_ENV)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="no card of its own"):
        distributed._rank_device(None, 1)
    assert distributed._rank_device("cuda:0", 1) == torch.device("cuda", 0)


def test_host_local_info_has_jax_keys():
    assert set(tpar.host_local_info()) == set(jpar.host_local_info())
    assert tpar.host_local_info()["process_count"] == 1


def test_make_mesh_over_distinct_devices_still_raises():
    with pytest.raises(MeshError, match="global_mesh"):
        tpar.make_mesh(2, devices=[CPU, torch.device("meta")])


@pytest.mark.parametrize("world,shards", [(4, 6), (3, 8), (2, 1)])
def test_a_process_mesh_must_split_evenly(world, shards):
    with pytest.raises(MeshError, match="split evenly"):
        Mesh((CPU,) * shards, world_size=world, rank=0, group=object())


def _fake(world=2, shards=4):
    return Mesh((CPU,) * shards, world_size=world, rank=0, group=object())


def test_local_rows_keep_the_ranks_shards():
    arr = np.arange(24.0).reshape(8, 3)
    mesh = Mesh((CPU,) * 8, world_size=4, rank=2, group=object())
    assert mesh.local_shards == range(4, 6)
    np.testing.assert_array_equal(tpar.local_rows(arr, mesh).numpy(),
                                  arr[4:6])
    np.testing.assert_array_equal(
        tpar.local_rows(arr, tpar.make_mesh(8, devices=[CPU] * 8)).numpy(),
        arr)


@pytest.mark.parametrize("path", ["sharded_well_spmv_given_a_process_mesh"])
def test_paths_not_carried_across_ranks_refuse_a_process_mesh(path):
    """Every path runs across ranks, but a container keeps the mesh it was
    built on: one built on a single-process mesh and handed a mesh that
    claims two ranks raises."""
    m = CsrMatrix.from_matrix_market(tgen.poisson2d(16, 16))
    A = tpar.shard_well(m, 4, mesh=tpar.make_mesh(4, devices=[CPU] * 4))
    with pytest.raises(ValueError, match="does not hold"):
        tpar.sharded_well_spmv(A, torch.zeros(4, 128), _fake())


SOLVERS = ["cg", "pcg", "batched_cg", "gmres", "chebyshev",
           "lanczos_bounds", "bicgstab", "lobpcg"]


def _solve_on_closure(solver, **kw):
    """Run ``solver`` over a diagonal SPD closure that carries a fake
    two-rank mesh of 4 shards (rank 0's rows: 2 shards of 64)."""
    mesh = _fake()
    d = torch.linspace(1.0, 2.0, 128)
    matvec = (lambda v: v * d.reshape(v.shape))          # noqa: E731
    matvec.mesh = mesh
    matmat = (lambda V: V * d[:, None])                  # noqa: E731
    matmat.mesh = mesh
    b = torch.ones(2, 64)
    run = {"cg": lambda: tops.conjugate_gradient(matvec, b, **kw),
           "pcg": lambda: tops.preconditioned_conjugate_gradient(
               matvec, b, lambda r: r, **kw),
           "batched_cg": lambda: tops.batched_conjugate_gradient(
               matmat, torch.ones(128, 2), **kw),
           "gmres": lambda: tops.gmres(matvec, b, **kw),
           "chebyshev": lambda: tops.chebyshev(matvec, b, 0.9, 2.1, **kw),
           "lanczos_bounds": lambda: tops.lanczos_bounds(
               matvec, (4, 64), num_steps=5, dtype=d.dtype, **kw),
           "bicgstab": lambda: tops.bicgstab(matvec, b, **kw),
           "lobpcg": lambda: tops.lobpcg(
               matmat, torch.linspace(0.0, 1.0, 256).reshape(128, 2) ** 2,
               max_iterations=3, **kw)}[solver]
    return mesh, run


@pytest.mark.parametrize("solver", SOLVERS)
def test_solvers_reduce_over_the_closures_mesh(solver, monkeypatch):
    """A solver handed a closure over a process mesh, and no mesh=, sums
    its dots over the closure's mesh: every all-reduce it makes goes to
    that mesh (a fake group whose all-reduce is recorded and keeps this
    rank's values)."""
    from spmv_tpu_torch.parallel import comm

    seen = []

    def recorded(t, got_mesh):
        seen.append(got_mesh)
        return t

    monkeypatch.setattr(comm, "all_reduce_sum", recorded)
    mesh, run = _solve_on_closure(solver)
    run()
    assert seen and all(m is mesh for m in seen), seen[:3]


def test_solver_refuses_a_mesh_other_than_its_closures():
    """A mesh= that differs from the closure's raises before any dot."""
    _, run = _solve_on_closure("cg", mesh=_fake(world=4))
    with pytest.raises(MeshError, match="mesh="):
        run()


def _ladder_matrix():
    """A 32-row SPD matrix whose diagonal blocks break down at shift 0
    (``tests/test_torch_shard_solvers.py``'s ladder case)."""
    n = 32
    a = np.eye(n)
    for i in range(n - 1):
        a[i, i + 1] = a[i + 1, i] = -0.49
    for i in range(n - 2):
        a[i, i + 2] = a[i + 2, i] = -0.49
    r, c = np.nonzero(a)
    return CsrMatrix.from_matrix_market(tgen.from_coo_arrays(n, n, r, c,
                                                             a[r, c]))


@pytest.mark.parametrize("peer_fails", ["one_shift", "every_shift"])
def test_shift_ladder_is_one_decision_for_the_job(peer_fails, monkeypatch):
    """Rank 0 of a fake two-rank job factors its own blocks at shift 0;
    its peer's blocks fail there (the played all-reduce says so), so
    rank 0 climbs to the next shift with it, and where the peer fails
    every shift rank 0 raises the same error it does, not waiting in a
    collective the peer never reaches.  The envelope is the largest of
    the two ranks'."""
    from spmv_tpu_torch.parallel import comm, precond_shard

    m = CsrMatrix.from_matrix_market(tgen.poisson2d(8, 8))
    mesh = _fake(world=2, shards=2)
    peer_envelope = (1000, 7, 3)
    calls = []

    def played(values, got_mesh):
        assert got_mesh is mesh
        values = [int(v) for v in values]
        calls.append(values)
        if len(values) == 3:                       # the envelope
            return tuple(max(a, b) for a, b in zip(values, peer_envelope))
        assert values[mesh.rank] == 0              # rank 0 factors
        fails = peer_fails == "every_shift" or len(calls) == 1
        return (0, int(fails))

    monkeypatch.setattr(comm, "max_over_ranks", played)
    shifts = (0.0, 0.01, 0.1)
    if peer_fails == "every_shift":
        with pytest.raises(MatrixError, match=r"rank\(s\) \[1\] broke down"):
            precond_shard.block_jacobi_ic0(m, np.array([0, 32, 64]), 40,
                                           shifts=shifts, mesh=mesh)
        assert len(calls) == len(shifts)
        return
    M = precond_shard.block_jacobi_ic0(m, np.array([0, 32, 64]), 40,
                                       shifts=shifts, mesh=mesh)
    assert M.shift_used == 0.01
    assert len(M.lower) == 1 and M.num_shards == 2
    assert M.num_levels == 1000 and M.width >= 7 and M.max_deps >= 3
    assert calls[:2] == [[0, 0], [0, 0]]


EXAMPLE = os.path.join(REPO, "examples", "03_multichip_torch.py")
EXAMPLE_S = 60
# the JAX example's two lines
EXAMPLE_LINES = (r"sharded CG over (\d+) devices: iters (\d+) rel_err \S+ "
                 r"\(halo \d+ elems/step\)",
                 r"block-Jacobi-IC\(0\) PCG: iters (\d+)")


def _example(argv, env):
    """The example's two lines' (P, CG, PCG) counts, run by ``argv``
    within EXAMPLE_S (past it, the test fails)."""
    import re

    try:
        r = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=EXAMPLE_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{argv} outlasted {EXAMPLE_S} s")
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 2, r.stdout
    m0 = re.fullmatch(EXAMPLE_LINES[0], lines[0])
    m1 = re.fullmatch(EXAMPLE_LINES[1], lines[1])
    assert m0 and m1, lines
    return int(m0[1]), int(m0[2]), int(m1[1])


def _torchrun_env():
    """The CPU's environment for a ``torchrun`` job of the port: no
    inherited rank, address or port, and torchrun's shared store left on
    (``TORCH_DISABLE_SHARE_RDZV_TCP_STORE`` unset)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    env[DEVICE_ENV] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "LOCAL_RANK", "TORCH_DISABLE_SHARE_RDZV_TCP_STORE"):
        env.pop(name, None)
    return env


def _torchrun(nproc: int) -> list:
    """``torchrun --standalone``: its agent binds the rendezvous store on
    a port the kernel picks (``localhost:0``) and hands that store to the
    ranks, so no port is chosen, released and claimed again, which
    another process could take in between."""
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(nproc)]


def test_example_runs_under_torchrun_as_in_one_process():
    """``examples/03_multichip_torch.py`` under ``torchrun
    --nproc-per-node 2`` on the CPU (Gloo): rank 0 prints the JAX
    example's two lines, at the single-process run's iteration counts."""
    env = _torchrun_env()
    two = _example(_torchrun(2) + [EXAMPLE], env)
    one = _example([sys.executable, EXAMPLE], env)
    assert two == one
    assert one[0] == 4 and 0 < one[2] < one[1] < 500


# one rank of ``torchrun --standalone``: initialize_distributed from
# torchrun's environment, one all-reduce over the group, then the rank's
# view of the job as JSON, in <argv[1]>/<rank>.json
_RENDEZVOUS_RANK = """
import json, os, sys
import torch
import torch.distributed as dist
from spmv_tpu_torch.parallel import initialize_distributed
assert initialize_distributed()
t = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(t)
doc = {"rank": dist.get_rank(), "world": dist.get_world_size(),
       "backend": dist.get_backend(), "sum": float(t),
       "port": int(os.environ["MASTER_PORT"]),
       "agent_store": os.environ.get("TORCHELASTIC_USE_AGENT_STORE")}
with open(os.path.join(sys.argv[1], f"{dist.get_rank()}.json"), "w") as f:
    json.dump(doc, f)
dist.destroy_process_group()
"""


def test_torchrun_standalone_rendezvous_on_the_cpu(tmp_path):
    """The rendezvous the example's test runs under: two ranks of
    ``torchrun --standalone`` meet on the store its agent bound, through
    ``initialize_distributed`` (Gloo on the CPU), and agree on its
    port."""
    script = tmp_path / "rank.py"
    script.write_text(_RENDEZVOUS_RANK)
    try:
        r = subprocess.run(_torchrun(2) + [str(script), str(tmp_path)],
                           cwd=REPO, env=_torchrun_env(),
                           capture_output=True, text=True,
                           timeout=EXAMPLE_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"torchrun --standalone outlasted {EXAMPLE_S} s")
    assert r.returncode == 0, r.stderr[-3000:]
    docs = [json.loads((tmp_path / f"{rank}.json").read_text())
            for rank in (0, 1)]
    assert [d["rank"] for d in docs] == [0, 1]
    assert {d["world"] for d in docs} == {2}
    assert {d["backend"] for d in docs} == {"gloo"}
    assert {d["sum"] for d in docs} == {3.0}
    assert len({d["port"] for d in docs}) == 1 and docs[0]["port"] > 0
    assert {d["agent_store"] for d in docs} == {"True"}

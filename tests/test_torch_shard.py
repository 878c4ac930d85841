"""The port's sharded SpMV, SpMM and CG against the JAX package's.

The port runs on a mesh of P virtual shards of the CPU (each shard's
product the kernel's plain version), JAX on the first P of its 8
virtual CPU devices, both in float64 on the same host-built matrix and
``default_rng`` inputs, at P = 1, 2 and 8.  Stacked outputs compare
element for element at rtol 1e-12: the all-gather CSR SpMV, the DIA
SpMV and SpMM (K1 / K2 a shard on a window of the stacked x), the halo
CSR SpMV and SpMM (neighbor and all2all).  The stacked geometry (bounds,
rows a shard, exchange) is JAX's.  CG over each strategy and batched
CG over the DIA matmat at k = 2 stop at JAX's iteration counts, x at
rtol 1e-10; ``dryrun_multichip(8)``'s eleven strategies stop at the
counts of a live run of JAX's (LOBPCG: its eigenvalues).  Also: CG and batched CG keep their bits on 1-D vectors and
(n, k) blocks after the change to stacked reductions, and JAX's batched
CG over its halo matmat (columns on axis 2) is not a batched solve.
"""

import contextlib
import importlib.util
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu import ops as jops
from spmv_tpu import parallel as jpar
from spmv_tpu.io import generate as jgen
from spmv_tpu.models import CsrMatrix as JCsr
from spmv_tpu.models import DiaMatrix as JDia
from spmv_tpu_torch import ops as tops
from spmv_tpu_torch import parallel as tpar
from spmv_tpu_torch.io import generate as tgen
from spmv_tpu_torch.models import CsrMatrix, DiaMatrix
from spmv_tpu_torch.models.device import DEVICE_ENV
from spmv_tpu_torch.ops import csr_kernels, dia_kernels
from spmv_tpu_torch.parallel.dryrun import dryrun_multichip

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SHARDS = (1, 2, 8)
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _cpu_fp64(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


_JAX_MESHES = {}


def _meshes(P):
    if P not in _JAX_MESHES:
        _JAX_MESHES[P] = jpar.make_mesh(P)
    return tpar.make_mesh(P, devices=[CPU] * P), _JAX_MESHES[P]


def _mats(gen, *args, **kw):
    return (getattr(tgen, gen)(*args, **kw), getattr(jgen, gen)(*args, **kw))


def _jit(product, JA, jmesh):
    """JAX's sharded ``product`` of JA, jitted (an eager shard_map
    dispatches op by op), on a port's stacked tensor."""
    fn = jax.jit(lambda v: product(JA, v, jmesh))
    return lambda v: fn(jnp.asarray(v.numpy()))


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


CSR_MATS = {"poisson16x8": ("poisson2d", (16, 8), {}),
            "random200": ("random_sparse", (200, 200, 6), {"seed": 7}),
            "powerlaw400": ("powerlaw", (400, 400, 7.0), {"seed": 1})}


@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("name", list(CSR_MATS))
@pytest.mark.parametrize("partition", ["nnz", "rows"])
def test_csr_all_gather_spmv_matches_jax(P, name, partition):
    gen, args, kw = CSR_MATS[name]
    mm, jmm = _mats(gen, *args, **kw)
    m, jm = CsrMatrix.from_matrix_market(mm), JCsr.from_matrix_market(jmm)
    mesh, jmesh = _meshes(P)
    A = tpar.shard_csr(m, P, partition=partition, mesh=mesh)
    JA = jpar.shard_csr(jm, P, partition=partition, mesh=jmesh)
    assert (A.bounds, A.rows_per_shard) == (JA.bounds, JA.rows_per_shard)
    x = np.random.default_rng(3).standard_normal(m.num_rows)
    xs = tpar.stack_vector(x, A, mesh)
    _close(xs, jpar.stack_vector(x, JA, jmesh), 0)
    n0 = csr_kernels.csr_spmv_core.launches
    y = tpar.sharded_spmv(A, xs, mesh)
    assert csr_kernels.csr_spmv_core.launches == n0     # the CPU: no launch
    _close(y, _jit(jpar.sharded_spmv, JA, jmesh)(xs))
    assert (y[:, -1] == 0).all()                        # the overflow slot
    np.testing.assert_allclose(tpar.unstack_vector(y, A), m.spmv(x),
                               rtol=1e-12)


DIA_SHAPES = [(16, 24), (20, 20), (13, 11)]


@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("shape", DIA_SHAPES)
def test_dia_halo_spmv_and_spmm_match_jax(P, shape):
    mm, jmm = _mats("poisson2d", *shape)
    d, jd = DiaMatrix.from_matrix_market(mm), JDia.from_matrix_market(jmm)
    mesh, jmesh = _meshes(P)
    A, JA = tpar.shard_dia(d, P, mesh=mesh), jpar.shard_dia(jd, P)
    assert ((A.rows_per_shard, A.halo, A.offsets)
            == (JA.rows_per_shard, JA.halo, JA.offsets))
    _close(A.data, JA.data, 0)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(d.num_rows)
    xs = tpar.stack_dia_vector(x, A)
    _close(xs, jpar.stack_dia_vector(jnp.asarray(x), JA), 0)
    y = tpar.sharded_dia_spmv(A, xs, mesh)
    _close(y, _jit(jpar.sharded_dia_spmv, JA, jmesh)(xs))
    np.testing.assert_allclose(tpar.unstack_dia_vector(y, A), d.spmv(x),
                               rtol=1e-12)
    X = rng.standard_normal((d.num_rows, 3))
    Xs = tpar.stack_dia_matrix(X, A)
    _close(Xs, jpar.stack_dia_matrix(jnp.asarray(X), JA), 0)
    Y = tpar.sharded_dia_spmm(A, Xs, mesh)
    _close(Y, _jit(jpar.sharded_dia_spmm, JA, jmesh)(Xs))
    np.testing.assert_allclose(tpar.unstack_dia_matrix(Y, A),
                               np.stack([d.spmv(c) for c in X.T], axis=1),
                               rtol=1e-12)


def test_dia_windows_are_views_of_the_stacked_x():
    """Shard q's window starts h rows into shard q-1 (none for the first)
    and ends h rows into shard q+1 (none for the last); its DeviceDia's
    data is a view of ``data[q]``."""
    d = DiaMatrix.from_matrix_market(tgen.poisson2d(16, 24))
    A = tpar.shard_dia(d, 3, mesh=tpar.make_mesh(3, devices=[CPU] * 3))
    rb, h = A.rows_per_shard, A.halo
    assert A.windows == ((0, rb + h), (rb - h, 2 * rb + h),
                         (2 * rb - h, 3 * rb))
    for q, blk in enumerate(A.blocks):
        assert blk.data.data_ptr() == A.data[q].data_ptr()
        assert blk.num_columns == A.windows[q][1] - A.windows[q][0]
        shift = q * rb - A.windows[q][0]
        assert blk.offsets == tuple(o + shift for o in A.offsets)


HALO_CASES = [("poisson20x20", "auto", "neighbor"),
              ("poisson20x20", "all2all", "all2all"),
              ("random200", "auto", "all2all"),
              ("powerlaw400", "auto", None)]
HALO_MATS = {**CSR_MATS, "poisson20x20": ("poisson2d", (20, 20), {})}


@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("name,exchange,mode", HALO_CASES)
def test_csr_halo_spmv_and_spmm_match_jax(P, name, exchange, mode):
    gen, args, kw = HALO_MATS[name]
    mm, jmm = _mats(gen, *args, **kw)
    m, jm = CsrMatrix.from_matrix_market(mm), JCsr.from_matrix_market(jmm)
    mesh, jmesh = _meshes(P)
    A = tpar.shard_csr_halo(m, P, mesh=mesh, exchange=exchange)
    JA = jpar.shard_csr_halo(jm, P, mesh=jmesh, exchange=exchange)
    for f in ("bounds", "rows_per_shard", "exchange", "max_distance",
              "halo_slots", "comm_elements_exact", "comm_elements_padded"):
        assert getattr(A, f) == getattr(JA, f), f
    if P == 1:
        assert A.boundary == (None,)
        assert A.exchange == ("none" if exchange == "auto" else exchange)
    elif P == 8 and mode is not None:
        assert A.exchange == mode
    np.testing.assert_array_equal(A.send_idx, np.asarray(JA.send_idx))
    rng = np.random.default_rng(4)
    x = rng.standard_normal(m.num_rows)
    xs = tpar.stack_vector(x, A)
    y = tpar.sharded_halo_spmv(A, xs, mesh)
    _close(y, _jit(jpar.sharded_halo_spmv, JA, jmesh)(xs))
    np.testing.assert_allclose(tpar.unstack_vector(y, A), m.spmv(x),
                               rtol=1e-12)
    X = rng.standard_normal((m.num_rows, 3))
    Xs = tpar.stack_block(X, A)
    _close(Xs, jpar.stack_block(X, JA, jmesh), 0)
    Y = tpar.sharded_halo_spmm(A, Xs, mesh)
    _close(Y, _jit(jpar.sharded_halo_spmm, JA, jmesh)(Xs))
    np.testing.assert_allclose(tpar.unstack_block(Y, A),
                               np.stack([m.spmv(c) for c in X.T], axis=1),
                               rtol=1e-12)


def _strategy(kind, P, mm, jmm):
    """(port matvec, stacked b, unstack, JAX matvec, JAX stacked b) for
    ``kind``, b = A @ ones."""
    mesh, jmesh = _meshes(P)
    if kind == "dia":
        d, jd = DiaMatrix.from_matrix_market(mm), JDia.from_matrix_market(jmm)
        A, JA = tpar.shard_dia(d, P, mesh=mesh), jpar.shard_dia(jd, P)
        b = d.spmv(np.ones(d.num_rows))
        return (tpar.make_sharded_dia_matvec(A, mesh),
                tpar.stack_dia_vector(b, A),
                lambda v: tpar.unstack_dia_vector(v, A),
                jpar.make_sharded_dia_matvec(JA, jmesh),
                jpar.stack_dia_vector(jnp.asarray(b), JA))
    m, jm = CsrMatrix.from_matrix_market(mm), JCsr.from_matrix_market(jmm)
    b = m.spmv(np.ones(m.num_rows))
    if kind == "csr":
        A = tpar.shard_csr(m, P, mesh=mesh)
        JA = jpar.shard_csr(jm, P, mesh=jmesh)
        make, jmake = tpar.make_sharded_matvec, jpar.make_sharded_matvec
    else:
        A = tpar.shard_csr_halo(m, P, mesh=mesh)
        JA = jpar.shard_csr_halo(jm, P, mesh=jmesh)
        make = tpar.make_sharded_halo_matvec
        jmake = jpar.make_sharded_halo_matvec
    bs = tpar.stack_vector(b, A)
    return (make(A, mesh), bs, lambda v: tpar.unstack_vector(v, A),
            jmake(JA, jmesh), jnp.asarray(bs.numpy()))


@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("kind", ["csr", "dia", "halo"])
def test_cg_over_each_strategy_matches_jax(P, kind):
    mm, jmm = _mats("poisson2d", 16, 16)
    matvec, b, unstack, jmatvec, jb = _strategy(kind, P, mm, jmm)
    res = tops.conjugate_gradient(matvec, b, tol=1e-10, max_iterations=500)
    jres = jax.jit(lambda v: jops.conjugate_gradient(
        jmatvec, v, tol=1e-10, max_iterations=500))(jb)
    assert res.iterations == int(jres.iterations) < 500
    _close(res.x, jres.x, 1e-10)
    np.testing.assert_allclose(unstack(res.x), 1.0, rtol=1e-8)


@pytest.mark.parametrize("P", SHARDS)
def test_batched_cg_over_dia_matmat_matches_jax(P):
    """Batched CG over the DIA matmat's stacked (P, k, Rb) block, k = 2:
    per-column counts and X equal JAX's."""
    mm, jmm = _mats("poisson2d", 20, 20)
    d, jd = DiaMatrix.from_matrix_market(mm), JDia.from_matrix_market(jmm)
    mesh, jmesh = _meshes(P)
    A, JA = tpar.shard_dia(d, P, mesh=mesh), jpar.shard_dia(jd, P)
    x = np.random.default_rng(0).standard_normal(d.num_rows)
    X = np.stack([x, 2.0 * x[::-1].copy()], axis=1)
    B = np.stack([d.spmv(c) for c in X.T], axis=1)
    res = tops.batched_conjugate_gradient(
        tpar.make_sharded_dia_matmat(A, mesh), tpar.stack_dia_matrix(B, A),
        tol=1e-10, max_iterations=500)
    jmatmat = jpar.make_sharded_dia_matmat(JA, jmesh)
    jres = jax.jit(lambda V: jops.batched_conjugate_gradient(
        jmatmat, V, tol=1e-10, max_iterations=500))(
            jpar.stack_dia_matrix(jnp.asarray(B), JA))
    np.testing.assert_array_equal(res.iterations.numpy(),
                                  np.asarray(jres.iterations))
    _close(res.x, jres.x, 1e-10)
    err = np.abs(tpar.unstack_dia_matrix(res.x, A) - X).max()
    assert err < 1e-6 * np.abs(X).max()


def _cg_before(matvec, b, tol, max_iterations):
    """CG as ``ops.solvers`` ran it before its dots took stacked layouts:
    ``torch.dot`` on the 1-D vectors themselves."""
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = r.clone()
    rz = torch.dot(r, r)
    tol2 = torch.tensor(tol, dtype=b.dtype) ** 2 * torch.clamp(
        torch.dot(b, b), min=1e-300)
    k = 0
    while k < max_iterations and bool(rz > tol2):
        ap = matvec(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rz_new = torch.dot(r, r)
        p = r + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, k


def _batched_before(matmat, B, tol, max_iterations):
    """Batched CG as it ran before: dim-0 column sums, (k,) scalars."""
    X, R = torch.zeros_like(B), B.clone()
    P = R.clone()
    rz = (R * R).sum(dim=0)
    tol2 = torch.tensor(tol, dtype=B.dtype) ** 2 * torch.clamp(
        (B * B).sum(dim=0), min=1e-300)
    iters = torch.zeros(B.shape[1], dtype=torch.int32)
    for _ in range(max_iterations):
        active = rz > tol2
        if not bool(active.any()):
            break
        AP = matmat(P)
        pap = (P * AP).sum(dim=0)
        one = torch.ones_like(pap)
        alpha = torch.where(active, rz / torch.where(active, pap, one), 0.0)
        X = X + alpha * P
        R = R - alpha * AP
        rz_new = (R * R).sum(dim=0)
        beta = torch.where(active, rz_new / torch.where(active, rz, one),
                           0.0)
        P = R + beta * P
        rz = rz_new
        iters += active.to(torch.int32)
    return X, iters


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cg_and_batched_cg_keep_their_bits(dtype):
    """On a 1-D b and an (n, k) B the stacked reductions are the same
    reductions: CG's and batched CG's results are bitwise those of the
    loops before the change."""
    from spmv_tpu_torch.models.device import DeviceCsr

    m = CsrMatrix.from_matrix_market(tgen.poisson2d(24, 24))
    A = DeviceCsr.from_host(m, dtype=dtype, device=CPU)
    rng = np.random.default_rng(2)
    b = torch.from_numpy(rng.standard_normal(m.num_rows)).to(dtype)
    res = tops.conjugate_gradient(lambda v: tops.spmv(A, v), b, tol=1e-6,
                                  max_iterations=300)
    x, k = _cg_before(lambda v: tops.spmv(A, v), b, 1e-6, 300)
    assert res.iterations == k
    assert torch.equal(res.x, x)
    B = torch.from_numpy(rng.standard_normal((m.num_rows, 3))).to(dtype)
    bres = tops.batched_conjugate_gradient(
        lambda V: csr_kernels.csr_spmm_core(A, V), B, tol=1e-6,
        max_iterations=300)
    X, iters = _batched_before(lambda V: csr_kernels.csr_spmm_core(A, V), B,
                               1e-6, 300)
    assert torch.equal(bres.iterations, iters)
    assert torch.equal(bres.x, X)


def test_jax_batched_cg_over_halo_matmat_is_not_a_batched_solve():
    """A reference fault the port does not copy: JAX's halo matmat block
    is (P, R, k), column on axis 2, and its batched CG reduces over every
    axis but 1, so it runs R recurrences, one a row slot across shards
    and columns.  Its ``iterations`` come back of length R, not k, and
    after as many iterations as batched CG over the DIA matmat (the same
    system, columns on axis 1) needs to converge, X is far off or NaN."""
    mm = jgen.poisson2d(12, 12)
    jm, jd = JCsr.from_matrix_market(mm), JDia.from_matrix_market(mm)
    _, jmesh = _meshes(2)
    X = np.stack([np.ones(jm.num_rows), np.arange(jm.num_rows) / 100.0],
                 axis=1)
    B = np.stack([jm.spmv(c) for c in X.T], axis=1)
    JD = jpar.shard_dia(jd, 2)
    dmatmat = jpar.make_sharded_dia_matmat(JD, jmesh)
    good = jax.jit(lambda V: jops.batched_conjugate_gradient(
        dmatmat, V, tol=1e-8, max_iterations=200))(
            jpar.stack_dia_matrix(jnp.asarray(B), JD))
    n = int(np.max(np.asarray(good.iterations)))
    good_err = np.abs(jpar.unstack_dia_matrix(good.x, JD) - X).max()
    JA = jpar.shard_csr_halo(jm, 2, mesh=jmesh)
    hmatmat = jpar.make_sharded_halo_matmat(JA, jmesh)
    res = jax.jit(lambda V: jops.batched_conjugate_gradient(
        hmatmat, V, tol=1e-8, max_iterations=n))(
            jpar.stack_block(B, JA, jmesh))
    assert np.asarray(res.iterations).shape == (JA.rows_per_shard,)
    err = np.abs(jpar.unstack_block(res.x, JA) - X).max()
    assert n < 200 and good_err < 1e-6
    assert not err <= 1e3 * good_err        # NaN here: 0 / 0 in a slot


def _jax_dryrun_counts(n):
    """What a live run of JAX's ``dryrun_multichip(n)`` prints for its
    eleven strategies: iteration counts, exchanges and volumes."""
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    entry = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(entry)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        entry.dryrun_multichip(n)
    line = buf.getvalue()

    def one(pattern):
        return re.search(pattern, line).groups()

    halo = one(r"CSR\(halo-(\w+), (\d+) elems/step\) CG iters=(\d+)")
    return {
        "csr_all_gather": int(one(r"CSR\(all-gather\) CG iters=(\d+)")[0]),
        "dia_halo": int(one(r"DIA\(halo-ppermute\) CG iters=(\d+)")[0]),
        "csr_halo": (halo[0], int(halo[1]), int(halo[2])),
        "well_halo": one(r"WELL\(halo-(\w+)\) SpMV")[0],
        "wellcw_halo": tuple(one(
            r"WELL-CW\(halo-(\w+), (\d+) elems/step\) SpMV")),
        "bsr_halo": tuple(one(r"BSR\(halo-(\w+), (\d+) blocks/step\) SpMM")),
        "chebyshev": int(one(r"Chebyshev\(halo-\w+, no-reduction loop\) "
                             r"iters=(\d+)")[0]),
        "jacobi_pcg": int(one(r"Jacobi-PCG\(halo-\w+, residual replacement "
                              r"every 25\) iters=(\d+)")[0]),
        "batched_dia_halo": [int(i) for i in one(
            r"batched-CG\(halo-ppermute, k=2 RHS\) iters=\[(\d+), (\d+)\]")],
        "block_ic0_pcg": tuple(one(r"block-Jacobi-IC0 PCG\(local tri-solves, "
                                   r"shift=([\d.]+)\) iters=(\d+)")),
        "lobpcg": one(r"LOBPCG\(halo-\w+ SpMM, k=2, masked basis\) "
                      r"iters=(\d+) eig_rel_err=(\S+)"),
    }


def test_dryrun_matches_a_live_jax_dryrun(capsys):
    """All eleven strategies: JAX's iteration counts, exchanges and
    volumes; LOBPCG to JAX's 1e-4 of the analytic eigenvalues (its random
    P is the port's own draw, so its count is not JAX's)."""
    got = dryrun_multichip(8, device="cpu")
    line = capsys.readouterr().out
    assert line.startswith("dryrun_multichip(8): ok — 128 rows, 592 nnz")
    want = _jax_dryrun_counts(8)
    assert len(got) == len(want) == 11
    for name in ("csr_all_gather", "dia_halo", "chebyshev", "jacobi_pcg",
                 "batched_dia_halo"):
        assert got[name]["iterations"] == want[name], name
    h = got["csr_halo"]
    assert ((h["exchange"], h["comm_elements_padded"], h["iterations"])
            == want["csr_halo"])
    assert got["well_halo"]["exchange"] == want["well_halo"]
    c, b = got["wellcw_halo"], got["bsr_halo"]
    assert (c["exchange"], str(c["comm_elements_padded"])) == \
        want["wellcw_halo"]
    assert (b["exchange"], str(b["comm_blocks_exact"])) == want["bsr_halo"]
    bj = got["block_ic0_pcg"]
    assert (str(bj["shift_used"]), str(bj["iterations"])) == \
        want["block_ic0_pcg"]
    assert got["lobpcg"]["rel_err"] < 1e-4
    for res in got.values():
        assert res["rel_err"] < 1e-5


def test_each_product_is_one_call_a_shard(monkeypatch):
    """The launch structure the card runs, counted on the CPU through the
    wrappers: one CSR SpMV a shard (all-gather), one K1 / K2 a shard (DIA),
    and an interior plus, where the shard reads a halo, a boundary CSR
    SpMV / SpMM a shard, ``accumulate=True``."""
    calls = []

    def spy(name, fn):
        def wrapped(A, x, *args, **kw):
            calls.append((name, A.num_rows, A.num_columns,
                          kw.get("accumulate", False)))
            return fn(A, x, *args, **kw)
        return wrapped

    from spmv_tpu_torch.parallel import dia_shard, halo_shard, shard

    monkeypatch.setattr(shard, "csr_spmv_core",
                        spy("csr", csr_kernels.csr_spmv_core))
    monkeypatch.setattr(halo_shard, "csr_spmv_core",
                        spy("csr", csr_kernels.csr_spmv_core))
    monkeypatch.setattr(halo_shard, "csr_spmm_core",
                        spy("csr_spmm", csr_kernels.csr_spmm_core))
    monkeypatch.setattr(dia_shard, "dia_spmv_core",
                        spy("k1", dia_kernels.dia_spmv_core))
    monkeypatch.setattr(dia_shard, "dia_spmm_core",
                        spy("k2", dia_kernels.dia_spmm_core))
    mm = tgen.poisson2d(20, 20)
    m, d = CsrMatrix.from_matrix_market(mm), DiaMatrix.from_matrix_market(mm)
    mesh = tpar.make_mesh(4, devices=[CPU] * 4)
    x = np.ones(m.num_rows)
    A = tpar.shard_csr(m, 4, mesh=mesh)
    tpar.sharded_spmv(A, tpar.stack_vector(x, A), mesh)
    R = A.rows_per_shard
    assert calls == [("csr", R, 4 * R, False)] * 4
    calls.clear()
    H = tpar.shard_csr_halo(m, 4, mesh=mesh)
    slots = H.recv_index.shape[1]
    tpar.sharded_halo_spmv(H, tpar.stack_vector(x, H), mesh)
    assert calls == [("csr", R, R, False), ("csr", R, slots, True)] * 4
    calls.clear()
    tpar.sharded_halo_spmm(H, tpar.stack_block(np.ones((m.num_rows, 2)), H),
                           mesh)
    assert calls == [("csr_spmm", R, R, False),
                     ("csr_spmm", R, slots, True)] * 4
    calls.clear()
    D = tpar.shard_dia(d, 4, mesh=mesh)
    tpar.sharded_dia_spmv(D, tpar.stack_dia_vector(x, D), mesh)
    tpar.sharded_dia_spmm(D, tpar.stack_dia_matrix(np.ones((m.num_rows, 2)),
                                                   D), mesh)
    assert [c[0] for c in calls] == ["k1"] * 4 + ["k2"] * 4

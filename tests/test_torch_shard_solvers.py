"""The solvers over the port's sharded operators against the JAX
package's, and block-Jacobi IC(0) (``parallel.precond_shard``).

Both run in float64 on a mesh of P virtual CPU shards (the port's kernels'
plain versions; JAX's first P of its 8 virtual CPU devices), on the same
host matrices and ``default_rng`` inputs:

- the block-Jacobi IC(0) apply at P = 1, 2 and 8 against JAX's at rtol
  1e-12, ``shift_used`` and the (levels, width, deps) envelope equal
  (the port's solves are unpadded), the shift ladder; block-IC(0) PCG
  beats Jacobi-PCG on the anisotropic Laplacian of
  ``tests/test_precond_shard.py``, each at JAX's iteration count;
- Chebyshev with ``lanczos_bounds`` (the bounds at rtol 1e-10), Jacobi-PCG
  (residual replaced every 25; the stacked diagonal's padding zeros pass
  through), GMRES, and CG over the WELL, WELL-CW and BSR sharded
  matvecs, each at JAX's iteration count, x at rtol 1e-10;
- LOBPCG over the halo CSR and WELL-CW SpMMs with the padding rows
  masked and JAX's random P passed as ``P0``: JAX's iteration count,
  eigenvalues at rtol 1e-10; without the mask the padding's null space
  poisons it, as it poisons JAX's.  LOBPCG runs at ``tol`` 1e-5, as in
  ``tests/test_torch_eigen.py``, and GMRES at 1e-8: at 1e-9 and 1e-10
  they stopped one step from JAX, where a residual lay within rounding
  of its threshold (the stacked sums run in another order);
- ``ops.krylov`` on 1-D vectors keeps its bits: GMRES, Chebyshev and
  ``lanczos_bounds`` against copies of the loops before their dots took
  stacked layouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu import ops as jops
from spmv_tpu import parallel as jpar
from spmv_tpu.io import generate as jgen
from spmv_tpu.models import CsrMatrix as JCsr
from spmv_tpu.models.bsr import BsrMatrix as JBsr
from spmv_tpu.parallel import bsr_shard as jbsr
from spmv_tpu.parallel import precond_shard as jpre
from spmv_tpu_torch import ops as tops
from spmv_tpu_torch import parallel as tpar
from spmv_tpu_torch.io import generate as tgen
from spmv_tpu_torch.models import CsrMatrix
from spmv_tpu_torch.models.bsr import BsrMatrix
from spmv_tpu_torch.models.device import DEVICE_ENV, DeviceCsr
from spmv_tpu_torch.ops import krylov
from spmv_tpu_torch.ops.solvers import CgResult, _eps, _np_type, _tol2
from spmv_tpu_torch.parallel import bsr_shard

CPU = torch.device("cpu")
SHARDS = (1, 2, 8)


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


def _csrs(gen, *args, **kw):
    return (CsrMatrix.from_matrix_market(getattr(tgen, gen)(*args, **kw)),
            JCsr.from_matrix_market(getattr(jgen, gen)(*args, **kw)))


def _close(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _halo(m, jm, P):
    mesh, jmesh = _meshes(P)
    A = tpar.shard_csr_halo(m, P, mesh=mesh)
    JA = jpar.shard_csr_halo(jm, P, mesh=jmesh)
    return A, JA, mesh, jmesh


PRECOND_MATS = {"poisson16x16": ("poisson2d", (16, 16), {}),
                "aniso24x24": ("anisotropic2d", (24, 24), {"epsilon": 0.01})}


@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("name", list(PRECOND_MATS))
def test_block_ic0_apply_matches_jax(P, name):
    gen, args, kw = PRECOND_MATS[name]
    m, jm = _csrs(gen, *args, **kw)
    A, JA, mesh, jmesh = _halo(m, jm, P)
    M = tpar.block_jacobi_ic0(m, A.bounds, A.rows_per_shard, mesh=mesh)
    JM = jpre.block_jacobi_ic0(jm, JA.bounds, JA.rows_per_shard, mesh=jmesh)
    assert M.shift_used == JM.shift_used
    assert ((M.num_levels, M.width, M.max_deps)
            == (JM.num_levels, JM.width, JM.max_deps))
    assert M.launches_an_apply()["tri_solve_core"] >= 2 * P
    r = np.random.default_rng(0).standard_normal(m.num_rows)
    rs = tpar.stack_vector(r, A)
    z = tpar.sharded_block_ic0_apply(M, rs, mesh)
    jz = jax.jit(lambda v: jpre.sharded_block_ic0_apply(JM, v, jmesh))(
        jnp.asarray(rs.numpy()))
    _close(z, jz, 1e-12)
    assert (z[:, -1] == 0).all()


def test_block_ic0_shift_ladder_as_jax():
    """A block that breaks down at shift 0 climbs the ladder to the shift
    JAX's climbs to, and the two applies agree."""
    n = 32
    a = np.eye(n)
    for i in range(n - 1):
        a[i, i + 1] = a[i + 1, i] = -0.49
    for i in range(n - 2):
        a[i, i + 2] = a[i + 2, i] = -0.49
    r, c = np.nonzero(a)
    m = CsrMatrix.from_matrix_market(tgen.from_coo_arrays(n, n, r, c,
                                                          a[r, c]))
    jm = JCsr.from_matrix_market(jgen.from_coo_arrays(n, n, r, c, a[r, c]))
    shifts = (0.0, 0.05, 0.2, 0.5, 2.0)
    M = tpar.block_jacobi_ic0(m, np.array([0, 16, 32]), 24, shifts=shifts,
                              mesh=_meshes(2)[0])
    JM = jpre.block_jacobi_ic0(jm, np.array([0, 16, 32]), 24, shifts=shifts)
    assert M.shift_used == JM.shift_used > 0.0
    rs = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 24)))
    rs[:, 16:] = 0.0
    _close(tpar.sharded_block_ic0_apply(M, rs),
           jpre.sharded_block_ic0_apply(JM, jnp.asarray(rs.numpy()),
                                        _meshes(2)[1]), 1e-12)


def test_block_ic0_pcg_beats_jacobi_as_jax():
    """On the anisotropic Laplacian block-IC(0) PCG takes fewer iterations
    than Jacobi-PCG; both stop at JAX's counts."""
    m, jm = _csrs("anisotropic2d", 24, 24, epsilon=0.01)
    A, JA, mesh, jmesh = _halo(m, jm, 8)
    x_true = np.random.default_rng(1).standard_normal(m.num_rows)
    b = m.spmv(x_true)
    bs = tpar.stack_vector(b, A)
    jbs = jnp.asarray(bs.numpy())
    mv, jmv = (tpar.make_sharded_halo_matvec(A, mesh),
               jpar.make_sharded_halo_matvec(JA, jmesh))
    jac = tops.jacobi_preconditioner(
        tpar.stack_vector(tops.extract_diagonal(m), A))
    jjac = jops.jacobi_preconditioner(jnp.asarray(
        tpar.stack_vector(tops.extract_diagonal(m), A).numpy()))
    M = tpar.block_jacobi_ic0(m, A.bounds, A.rows_per_shard, mesh=mesh)
    JM = jpre.block_jacobi_ic0(jm, JA.bounds, JA.rows_per_shard, mesh=jmesh)
    pre = tpar.make_sharded_block_ic0_preconditioner(M, mesh)
    jpre_ = jpre.make_sharded_block_ic0_preconditioner(JM, jmesh)
    its = {}
    for name, p, jp in (("jacobi", jac, jjac), ("block_ic0", pre, jpre_)):
        res = tops.preconditioned_conjugate_gradient(
            mv, bs, p, tol=1e-8, max_iterations=2000)
        jres = jax.jit(lambda v: jops.preconditioned_conjugate_gradient(
            jmv, v, jp, tol=1e-8, max_iterations=2000))(jbs)
        assert res.iterations == int(jres.iterations), name
        _close(res.x, jres.x, 1e-9)
        err = np.linalg.norm(tpar.unstack_vector(res.x, A) - x_true)
        assert err < 1e-5 * np.linalg.norm(x_true)
        its[name] = res.iterations
    assert its["block_ic0"] < its["jacobi"]


@pytest.mark.parametrize("P", SHARDS)
def test_chebyshev_over_halo_matvec_matches_jax(P):
    m, jm = _csrs("poisson2d", 16, 16)
    A, JA, mesh, jmesh = _halo(m, jm, P)
    mv, jmv = (tpar.make_sharded_halo_matvec(A, mesh),
               jpar.make_sharded_halo_matvec(JA, jmesh))
    rng = np.random.default_rng(2)
    bs = tpar.stack_vector(m.spmv(np.ones(m.num_rows)), A)
    v0 = tpar.stack_vector(rng.standard_normal(m.num_rows), A)
    lo, hi = tops.lanczos_bounds(mv, tuple(bs.shape), num_steps=30,
                                 dtype=torch.float64, v0=v0)
    jlo, jhi = jops.lanczos_bounds(jmv, tuple(bs.shape), num_steps=30,
                                   dtype=jnp.float64,
                                   v0=jnp.asarray(v0.numpy()))
    np.testing.assert_allclose((lo, hi), (jlo, jhi), rtol=1e-10)
    res = tops.chebyshev(mv, bs, lo, hi, tol=1e-8, max_iterations=3000,
                         check_every=10)
    jres = jax.jit(lambda v: jops.chebyshev(
        jmv, v, jlo, jhi, tol=1e-8, max_iterations=3000,
        check_every=10))(jnp.asarray(bs.numpy()))
    assert res.iterations == int(jres.iterations) < 3000
    _close(res.x, jres.x, 1e-10)


@pytest.mark.parametrize("P", SHARDS)
def test_jacobi_pcg_over_halo_matvec_matches_jax(P):
    m, jm = _csrs("random_sparse", 300, 300, 5, seed=3)
    # an SPD operator from a scattered pattern: S + S^T + a dominant
    # diagonal, so the halo exchange is all2all at P = 8
    d = np.zeros((300, 300))
    np.add.at(d, (np.repeat(np.arange(300), np.diff(m.row_ptr)),
                  m.column_index[: m.num_entries]), m.value[: m.num_entries])
    d = d + d.T
    d[np.diag_indices(300)] += np.abs(d).sum(axis=1) + 1.0
    r, c = np.nonzero(d)
    m = CsrMatrix.from_matrix_market(tgen.from_coo_arrays(300, 300, r, c,
                                                          d[r, c]))
    jm = JCsr.from_matrix_market(jgen.from_coo_arrays(300, 300, r, c,
                                                      d[r, c]))
    A, JA, mesh, jmesh = _halo(m, jm, P)
    bs = tpar.stack_vector(m.spmv(np.random.default_rng(4).standard_normal(
        300)), A)
    diag = tpar.stack_vector(tops.extract_diagonal(m), A)
    res = tops.preconditioned_conjugate_gradient(
        tpar.make_sharded_halo_matvec(A, mesh), bs,
        tops.jacobi_preconditioner(diag), tol=1e-10, max_iterations=500,
        recompute_every=25)
    jmv = jpar.make_sharded_halo_matvec(JA, jmesh)
    jres = jax.jit(lambda v: jops.preconditioned_conjugate_gradient(
        jmv, v, jops.jacobi_preconditioner(jnp.asarray(diag.numpy())),
        tol=1e-10, max_iterations=500, recompute_every=25))(
            jnp.asarray(bs.numpy()))
    assert res.iterations == int(jres.iterations) < 500
    _close(res.x, jres.x, 1e-10)


@pytest.mark.parametrize("P", (2, 8))
def test_gmres_over_halo_matvec_matches_jax(P):
    m, jm = _csrs("poisson2d", 16, 16)
    A, JA, mesh, jmesh = _halo(m, jm, P)
    bs = tpar.stack_vector(m.spmv(np.ones(m.num_rows)), A)
    res = tops.gmres(tpar.make_sharded_halo_matvec(A, mesh), bs, tol=1e-8,
                     restart=8, max_iterations=500)
    jmv = jpar.make_sharded_halo_matvec(JA, jmesh)
    jres = jax.jit(lambda v: jops.gmres(jmv, v, tol=1e-8, restart=8,
                                        max_iterations=500))(
        jnp.asarray(bs.numpy()))
    assert res.iterations == int(jres.iterations) < 500
    _close(res.x, jres.x, 1e-9)


def _format_matvecs(kind, m, jm, P):
    """(port matvec, stacked b, JAX matvec) of a sharded format, b = A
    ones."""
    mesh, jmesh = _meshes(P)
    b = m.spmv(np.ones(m.num_rows))
    if kind == "bsr":
        bm = BsrMatrix.from_csr(m, block_rows=8)
        A = tpar.shard_bsr_halo(bm, P, mesh=mesh)
        JA = jbsr.shard_bsr_halo(JBsr.from_csr(jm, block_rows=8), P,
                                 mesh=jmesh)
        return (tpar.make_sharded_bsr_matvec(A, mesh),
                bsr_shard.stack_columns(b, A)[..., 0].contiguous(),
                jbsr.make_sharded_bsr_matvec(JA, jmesh))
    build, jbuild, make, jmake = {
        "well": (tpar.shard_well, jpar.shard_well,
                 tpar.make_sharded_well_matvec,
                 jpar.make_sharded_well_matvec),
        "well_halo": (tpar.shard_well_halo, jpar.shard_well_halo,
                      tpar.make_sharded_well_halo_matvec,
                      jpar.make_sharded_well_halo_matvec),
        "wellcw_halo": (tpar.shard_wellcw_halo, jpar.shard_wellcw_halo,
                        tpar.make_sharded_wellcw_halo_matvec,
                        jpar.make_sharded_wellcw_halo_matvec)}[kind]
    A, JA = build(m, P, mesh=mesh), jbuild(jm, P, mesh=jmesh)
    return make(A, mesh), tpar.stack_vector(b, A), jmake(JA, jmesh)


@pytest.mark.parametrize("P", (2, 8))
@pytest.mark.parametrize("kind", ["well", "well_halo", "wellcw_halo", "bsr"])
def test_cg_over_format_matvecs_matches_jax(P, kind):
    m, jm = _csrs("poisson2d", 32, 32)
    mv, bs, jmv = _format_matvecs(kind, m, jm, P)
    res = tops.conjugate_gradient(mv, bs, tol=1e-10, max_iterations=500)
    jres = jax.jit(lambda v: jops.conjugate_gradient(
        jmv, v, tol=1e-10, max_iterations=500))(jnp.asarray(bs.numpy()))
    assert res.iterations == int(jres.iterations) < 500
    _close(res.x, jres.x, 1e-10)


def _mask(A):
    P, R = A.num_shards, A.rows_per_shard
    msk = np.zeros((P, R))
    for q in range(P):
        msk[q, : A.bounds[q + 1] - A.bounds[q]] = 1.0
    msk[:, R - 1] = 0.0
    return msk.reshape(-1)


def _jax_p(n, k):
    """The JAX function's random P block."""
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (n, k),
                                      jnp.float64))


def _lobpcg_pair(A, JA, mesh, jmesh, make, jmake, k, X0, tol, masked=True):
    P, R = A.num_shards, A.rows_per_shard
    mm, jmm = make(A, mesh), jmake(JA, jmesh)
    mask = _mask(A) if masked else None
    res = tops.lobpcg(
        lambda V: mm(V.reshape(P, R, k)).reshape(P * R, k),
        X0.reshape(P * R, k), tol=tol, max_iterations=400,
        mask=None if mask is None else torch.from_numpy(mask),
        P0=torch.from_numpy(_jax_p(P * R, k)))
    jres = jax.jit(lambda V: jops.lobpcg(
        lambda W: jmm(W.reshape(P, R, k)).reshape(P * R, k), V, tol=tol,
        max_iterations=400,
        mask=None if mask is None else jnp.asarray(mask)))(
            jnp.asarray(X0.reshape(P * R, k).numpy()))
    return res, jres


def _poisson_eigs(nx, ny, k):
    i, j = np.arange(1, nx + 1), np.arange(1, ny + 1)
    lam = (4.0 - 2.0 * np.cos(i * np.pi / (nx + 1))[:, None]
           - 2.0 * np.cos(j * np.pi / (ny + 1))[None, :])
    return np.sort(lam.reshape(-1))[:k]


@pytest.mark.parametrize("P", (2, 8))
def test_masked_lobpcg_over_halo_spmm_matches_jax(P):
    m, jm = _csrs("poisson2d", 16, 16)
    A, JA, mesh, jmesh = _halo(m, jm, P)
    X0 = tpar.stack_block(np.random.default_rng(1).standard_normal(
        (m.num_rows, 4)), A)
    res, jres = _lobpcg_pair(A, JA, mesh, jmesh,
                             tpar.make_sharded_halo_matmat,
                             jpar.make_sharded_halo_matmat, 4, X0, 1e-5)
    assert int(res.iterations) == int(jres.iterations) < 400
    np.testing.assert_allclose(res.eigenvalues.numpy(),
                               np.asarray(jres.eigenvalues), rtol=1e-10)
    np.testing.assert_allclose(res.eigenvalues.numpy(),
                               _poisson_eigs(16, 16, 4), rtol=1e-7)


def test_masked_lobpcg_over_wellcw_spmm_matches_jax():
    """The scattered format's SpMM under LOBPCG (JAX's slow-marked test,
    at a quarter of its size): an SPD operator S + S^T + a dominant
    diagonal, all2all exchange."""
    n = 256
    base = tgen.random_sparse(n, n, 5, seed=4)
    d = np.zeros((n, n))
    np.add.at(d, (base.rows_1based - 1, base.cols_1based - 1), base.values)
    d = d + d.T
    d[np.diag_indices(n)] += np.abs(d).sum(axis=1) + 1.0
    r, c = np.nonzero(d)
    m = CsrMatrix.from_matrix_market(tgen.from_coo_arrays(n, n, r, c,
                                                          d[r, c]))
    jm = JCsr.from_matrix_market(jgen.from_coo_arrays(n, n, r, c, d[r, c]))
    mesh, jmesh = _meshes(2)
    A = tpar.shard_wellcw_halo(m, 2, mesh=mesh, exchange="all2all")
    JA = jpar.shard_wellcw_halo(jm, 2, mesh=jmesh, exchange="all2all")
    X0 = tpar.stack_block(np.random.default_rng(5).standard_normal((n, 2)),
                          A)
    res, jres = _lobpcg_pair(A, JA, mesh, jmesh,
                             tpar.make_sharded_wellcw_halo_matmat,
                             jpar.make_sharded_wellcw_halo_matmat, 2, X0,
                             1e-5)
    assert int(res.iterations) == int(jres.iterations) < 400
    np.testing.assert_allclose(res.eigenvalues.numpy(),
                               np.asarray(jres.eigenvalues), rtol=1e-10)
    np.testing.assert_allclose(res.eigenvalues.numpy(),
                               np.sort(np.linalg.eigvalsh(d))[:2],
                               rtol=1e-6)


def test_lobpcg_without_mask_is_poisoned_as_jax():
    """Without the mask the padding rows' null space comes back as
    eigenvalues near 0, in the port as in JAX (why the dryrun passes
    one)."""
    m, jm = _csrs("poisson2d", 16, 16)
    A, JA, mesh, jmesh = _halo(m, jm, 8)
    n = A.num_shards * A.rows_per_shard
    X0 = torch.from_numpy(np.random.default_rng(2).standard_normal((n, 2)))
    res, jres = _lobpcg_pair(A, JA, mesh, jmesh,
                             tpar.make_sharded_halo_matmat,
                             jpar.make_sharded_halo_matmat, 2, X0, 1e-9,
                             masked=False)
    want = _poisson_eigs(16, 16, 2)[0]
    assert np.any(np.asarray(jres.eigenvalues) < 0.5 * want)
    assert np.any(res.eigenvalues.numpy() < 0.5 * want)


# ops.krylov as it ran before its dots and basis products took stacked
# layouts: torch.dot on the 1-D vectors and the basis as it is.


def _gmres_before(matvec, b, tol, restart, max_iterations):
    m = int(restart)
    dtype, dev = b.dtype, b.device
    nd = _np_type(dtype)
    x = torch.zeros_like(b)
    tol2 = _tol2(b, tol)
    tol_abs = nd(np.sqrt(tol2.cpu().numpy()))
    eps = _eps(dtype)
    V = torch.zeros((m + 1,) + tuple(b.shape), dtype=dtype, device=dev)
    r = b - matvec(x)
    rr = torch.dot(r, r)
    k = 0
    while bool(rr > tol2) and k < max_iterations:
        beta_t = torch.sqrt(torch.dot(r, r))
        beta = nd(beta_t.item())
        V.zero_()
        V[0] = r / (beta_t if beta > eps else 1.0)
        R = np.eye(m, dtype=nd)
        g = np.zeros(m + 1, dtype=nd)
        g[0] = beta
        cs = np.zeros(m, dtype=nd)
        sn = np.zeros(m, dtype=nd)
        steps = 0
        done = beta <= eps
        for j in range(m):
            if done:
                break
            w = matvec(V[j])
            Vj = V[: j + 1]
            h1 = Vj @ w
            w = w - h1 @ Vj
            h2 = Vj @ w
            w = w - h2 @ Vj
            hn_t = torch.sqrt(torch.dot(w, w))
            hv = torch.cat([h1 + h2, hn_t.reshape(1)]).cpu().numpy()
            h = np.zeros(m + 1, dtype=nd)
            h[: j + 1] = hv[: j + 1]
            hn = hv[j + 1]
            if hn > eps:
                V[j + 1] = w / hn_t
                h[j + 1] = hn
            for i in range(j):
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                hip = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i], h[i + 1] = hi, hip
            denom = np.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            if denom > eps:
                c, s = h[j] / denom, h[j + 1] / denom
            else:
                c, s = nd(1), nd(0)
            h[j] = c * h[j] + s * h[j + 1]
            h[j + 1] = 0
            R[:, j] = h[:m]
            gj = g[j]
            g[j] = c * gj
            g[j + 1] = -s * gj
            cs[j], sn[j] = c, s
            done = abs(g[j + 1]) <= tol_abs
            steps += 1
        g_solve = np.where(np.arange(m) < steps, g[:m], 0).astype(nd)
        y = torch.linalg.solve_triangular(
            torch.from_numpy(R), torch.from_numpy(g_solve)[:, None],
            upper=True)[:, 0]
        x = x + y.to(dev) @ V[:m]
        r = b - matvec(x)
        rr = torch.dot(r, r)
        k += steps
    return CgResult(x=x, residual_norm=torch.sqrt(rr), iterations=k)


def _chebyshev_before(matvec, b, lo, hi, tol, max_iterations, check_every):
    nd = _np_type(b.dtype)
    x = torch.zeros_like(b)
    theta, delta = nd((hi + lo) / 2.0), nd((hi - lo) / 2.0)
    tol2 = _tol2(b, tol)
    sigma1 = theta / delta
    r = b - matvec(x)
    p = r / float(theta)
    rho = nd(1) / sigma1
    rr = torch.dot(r, r)
    k = 0
    while bool(rr > tol2) and k < max_iterations:
        for _ in range(check_every):
            x = x + p
            r = r - matvec(p)
            rho_new = nd(1) / (nd(2) * sigma1 - rho)
            p = float(rho_new * rho) * p + float(nd(2) * rho_new / delta) * r
            rho = rho_new
        rr = torch.dot(r, r)
        k += check_every
    return CgResult(x=x, residual_norm=torch.sqrt(rr), iterations=k)


def _lanczos_before(matvec, v0, m):
    V = torch.zeros((m + 1,) + tuple(v0.shape), dtype=v0.dtype)
    V[0] = v0 / torch.sqrt(torch.dot(v0, v0))
    alpha = torch.zeros(m, dtype=v0.dtype)
    beta = torch.zeros(m, dtype=v0.dtype)
    for j in range(m):
        w = matvec(V[j])
        alpha[j] = torch.dot(V[j], w)
        Vj = V[: j + 1]
        w = w - (Vj @ w) @ Vj
        w = w - (Vj @ w) @ Vj
        bnew = torch.sqrt(torch.dot(w, w))
        V[j + 1] = torch.where(bnew > 0, w / torch.where(bnew > 0, bnew, 1.0),
                               0.0)
        beta[j] = bnew
    return alpha, beta[: m - 1]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_krylov_keeps_its_bits_on_1d_vectors(dtype):
    m = CsrMatrix.from_matrix_market(tgen.poisson2d(20, 20))
    A = DeviceCsr.from_host(m, dtype=dtype, device=CPU)

    def mv(v):
        return tops.spmv(A, v)

    b = torch.from_numpy(np.random.default_rng(3).standard_normal(
        m.num_rows)).to(dtype)
    got = tops.gmres(mv, b, tol=1e-6, restart=7, max_iterations=300)
    want = _gmres_before(mv, b, 1e-6, 7, 300)
    assert got.iterations == want.iterations
    assert torch.equal(got.x, want.x)
    lo, hi = tops.lanczos_bounds(mv, m.num_rows, num_steps=20, dtype=dtype,
                                 device=CPU)
    alpha, beta = krylov._lanczos_tridiag(mv, b, 20)
    a0, b0 = _lanczos_before(mv, b, 20)
    assert torch.equal(alpha, a0) and torch.equal(beta, b0)
    got = tops.chebyshev(mv, b, lo, hi, tol=1e-5, max_iterations=2000,
                         check_every=10)
    want = _chebyshev_before(mv, b, lo, hi, 1e-5, 2000, 10)
    assert got.iterations == want.iterations < 2000
    assert torch.equal(got.x, want.x)

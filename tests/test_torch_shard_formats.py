"""The port's second sharded half against the JAX package's: WELL
(all-gather and halo), WELL-CW (halo SpMV and SpMM) and BSR (tile halo).

The port runs on a mesh of P virtual shards of the CPU (each shard's
product the kernels' plain versions), JAX on the first P of its 8
virtual CPU devices, both in float64 on the same host-built matrix and
``default_rng`` inputs, at P = 1, 2 and 8 and with each ``exchange``
branch forced.  Stacked outputs compare element for element at rtol
1e-12; the geometry (bounds, rows a shard, JAX's padded envelopes) and
the exchange metadata (``exchange``, ``max_distance``, ``halo_slots``,
``comm_elements_*`` / ``comm_blocks_exact``, ``send_idx``) are JAX's.
Also: zero-valued cells create no halo need (WELL), the WELL-CW volume
is the analytic model's, the refusals of rectangular matrices, and the
launch structure each product makes (one K5, WELL-CW or K7 call a shard,
the boundary CSR call accumulating where a shard reads a halo), beside
each container's ``launches_a_product``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu import parallel as jpar
from spmv_tpu.errors import MatrixError as JMatrixError
from spmv_tpu.io import generate as jgen
from spmv_tpu.models import CsrMatrix as JCsr
from spmv_tpu.models.bsr import BsrMatrix as JBsr
from spmv_tpu.parallel import bsr_shard as jbsr
from spmv_tpu_torch import parallel as tpar
from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.io import generate as tgen
from spmv_tpu_torch.models import CsrMatrix
from spmv_tpu_torch.models.bsr import BsrMatrix
from spmv_tpu_torch.models.device import DEVICE_ENV
from spmv_tpu_torch.parallel import bsr_shard, well_shard, wellcw_shard

CPU = torch.device("cpu")
SHARDS = (1, 2, 8)
EXCHANGES = ("auto", "neighbor", "all2all")
RTOL = 1e-12
HALO_FIELDS = ("bounds", "rows_per_shard", "exchange", "max_distance",
               "halo_slots", "comm_elements_exact", "comm_elements_padded")


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


MATS = {"poisson32x16": ("poisson2d", (32, 16), {}),
        "random600": ("random_sparse", (600, 600, 5), {"seed": 2}),
        "banded1000": ("banded_random", (1000, 100, 6), {"seed": 3})}


def _mats(name):
    gen, args, kw = MATS[name]
    return (getattr(tgen, gen)(*args, **kw), getattr(jgen, gen)(*args, **kw))


def _csrs(name):
    mm, jmm = _mats(name)
    return CsrMatrix.from_matrix_market(mm), JCsr.from_matrix_market(jmm)


def _jit(product, JA, jmesh):
    """JAX's sharded ``product`` of JA, jitted, on a port's stacked
    tensor."""
    fn = jax.jit(lambda v: product(JA, v, jmesh))
    return lambda v: fn(jnp.asarray(v.numpy()))


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _same_plan(A, JA, fields=HALO_FIELDS):
    for f in fields:
        assert getattr(A, f) == getattr(JA, f), f
    np.testing.assert_array_equal(A.send_idx, np.asarray(JA.send_idx))


@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("name", list(MATS))
def test_well_all_gather_spmv_matches_jax(P, name):
    m, jm = _csrs(name)
    mesh, jmesh = _meshes(P)
    A = tpar.shard_well(m, P, window_rows=2, mesh=mesh)
    JA = jpar.shard_well(jm, P, window_rows=2, mesh=jmesh)
    for f in ("bounds", "rows_per_shard", "chunks_per_shard",
              "spill_per_shard", "window_rows"):
        assert getattr(A, f) == getattr(JA, f), f
    assert all(b.num_columns == P * A.rows_per_shard for b in A.blocks)
    x = np.random.default_rng(3).standard_normal(m.num_rows)
    xs = tpar.stack_vector(x, A, mesh)
    _close(xs, jpar.stack_vector(x, JA, jmesh), 0)
    y = tpar.sharded_well_spmv(A, xs, mesh)
    _close(y, _jit(jpar.sharded_well_spmv, JA, jmesh)(xs))
    assert (y[:, -1] == 0).all()                        # the overflow slot
    np.testing.assert_allclose(tpar.unstack_vector(y, A), m.spmv(x),
                               rtol=1e-12)


@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("name", list(MATS))
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_well_halo_spmv_matches_jax(P, name, exchange):
    m, jm = _csrs(name)
    mesh, jmesh = _meshes(P)
    A = tpar.shard_well_halo(m, P, window_rows=2, mesh=mesh,
                             exchange=exchange)
    JA = jpar.shard_well_halo(jm, P, window_rows=2, mesh=jmesh,
                              exchange=exchange)
    _same_plan(A, JA)
    if P > 1 and exchange != "auto":
        assert A.exchange == exchange
    x = np.random.default_rng(4).standard_normal(m.num_rows)
    xs = tpar.stack_vector(x, A)
    y = tpar.sharded_well_halo_spmv(A, xs, mesh)
    _close(y, _jit(jpar.sharded_well_halo_spmv, JA, jmesh)(xs))
    assert (y[:, -1] == 0).all()
    np.testing.assert_allclose(tpar.unstack_vector(y, A), m.spmv(x),
                               rtol=1e-12)


def test_well_zero_cells_make_no_halo_need():
    """Stored zeros in other shards' columns (and the packer's padded
    cells) create no need, as JAX's redirect to a local element: the
    needs are those of the matrix without the zeros, and the product
    matches JAX's."""
    mm, jmm = _mats("poisson32x16")
    rng = np.random.default_rng(5)
    extra_r = rng.integers(0, mm.num_rows, 40)
    extra_c = (extra_r + mm.num_rows // 2) % mm.num_rows
    rows = np.concatenate([mm.rows_1based - 1, extra_r])
    cols = np.concatenate([mm.cols_1based - 1, extra_c])
    vals = np.concatenate([mm.values, np.zeros(40)])
    m = CsrMatrix.from_matrix_market(tgen.from_coo_arrays(
        mm.num_rows, mm.num_columns, rows, cols, vals))
    jm = JCsr.from_matrix_market(jgen.from_coo_arrays(
        mm.num_rows, mm.num_columns, rows, cols, vals))
    assert m.num_entries == mm.num_entries + 40
    mesh, jmesh = _meshes(2)
    A = tpar.shard_well_halo(m, 2, window_rows=2, mesh=mesh)
    JA = jpar.shard_well_halo(jm, 2, window_rows=2, mesh=jmesh)
    _same_plan(A, JA)
    plain = tpar.shard_well_halo(CsrMatrix.from_matrix_market(mm), 2,
                                 window_rows=2, mesh=mesh)
    assert A.comm_elements_exact == plain.comm_elements_exact
    np.testing.assert_array_equal(A.send_idx, plain.send_idx)
    x = np.random.default_rng(6).standard_normal(m.num_rows)
    xs = tpar.stack_vector(x, A)
    _close(tpar.sharded_well_halo_spmv(A, xs, mesh),
           _jit(jpar.sharded_well_halo_spmv, JA, jmesh)(xs))


WELLCW_MATS = {**MATS,
               "banded4000": ("banded_random", (4000, 300, 8), {"seed": 3})}


@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("name", list(WELLCW_MATS))
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_wellcw_halo_spmv_and_spmm_match_jax(P, name, exchange):
    gen, args, kw = WELLCW_MATS[name]
    m = CsrMatrix.from_matrix_market(getattr(tgen, gen)(*args, **kw))
    jm = JCsr.from_matrix_market(getattr(jgen, gen)(*args, **kw))
    mesh, jmesh = _meshes(P)
    A = tpar.shard_wellcw_halo(m, P, mesh=mesh, exchange=exchange)
    JA = jpar.shard_wellcw_halo(jm, P, mesh=jmesh, exchange=exchange)
    _same_plan(A, JA)
    vol = tpar.communication_volume(m, np.asarray(A.bounds))
    assert A.comm_elements_exact == vol["halo_elements"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal(m.num_rows)
    xs = tpar.stack_vector(x, A)
    y = tpar.sharded_wellcw_halo_spmv(A, xs, mesh)
    _close(y, _jit(jpar.sharded_wellcw_halo_spmv, JA, jmesh)(xs))
    np.testing.assert_allclose(tpar.unstack_vector(y, A), m.spmv(x),
                               rtol=1e-12)
    X = rng.standard_normal((m.num_rows, 3))
    Xs = tpar.stack_block(X, A)
    Y = tpar.sharded_wellcw_halo_spmm(A, Xs, mesh)
    _close(Y, _jit(jpar.sharded_wellcw_halo_spmm, JA, jmesh)(Xs))
    assert (Y[:, -1] == 0).all()
    # one exchange moves all k columns: the SpMM's columns are the SpMV's
    # products on each column (within rounding of the kernels' order)
    for j in range(3):
        _close(Y[..., j], tpar.sharded_wellcw_halo_spmv(
            A, Xs[..., j].contiguous(), mesh))


def test_wellcw_halo_interior_is_a_merged_grid():
    """A shard whose interior fills the dense level slots packs as the
    merged grid (K3c / K4a), as an unsharded WELL-CW of its size does,
    and still matches JAX's product."""
    m, jm = (CsrMatrix.from_matrix_market(tgen.banded_random(
        120000, 256, 8, seed=1)), JCsr.from_matrix_market(
            jgen.banded_random(120000, 256, 8, seed=1)))
    mesh, jmesh = _meshes(2)
    A = tpar.shard_wellcw_halo(m, 2, mesh=mesh)
    JA = jpar.shard_wellcw_halo(jm, 2, mesh=jmesh)
    _same_plan(A, JA)
    assert all(a.merged is not None for a in A.interior)
    n = A.launches_a_product()
    assert n["wellcw_merged_core"] == 2 and n["csr_spmv_core"] >= 2
    assert "wellcw_level_core" not in n
    x = np.random.default_rng(8).standard_normal(m.num_rows)
    xs = tpar.stack_vector(x, A)
    _close(tpar.sharded_wellcw_halo_spmv(A, xs, mesh),
           _jit(jpar.sharded_wellcw_halo_spmv, JA, jmesh)(xs))


BSR_MATS = {"poisson32x16_b8": ("poisson2d", (32, 16), {}, 8),
            "poisson24x24_b16": ("poisson2d", (24, 24), {}, 16),
            "random600_b8": ("random_sparse", (600, 600, 5), {"seed": 2}, 8),
            "blocks1024_b128": ("block_random", (1024, 1024, 3),
                                {"seed": 2}, 128)}


@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("name", list(BSR_MATS))
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_bsr_halo_spmm_and_spmv_match_jax(P, name, exchange):
    gen, args, kw, bh = BSR_MATS[name]
    m = BsrMatrix.from_matrix_market(getattr(tgen, gen)(*args, **kw),
                                     block_rows=bh)
    jm = JBsr.from_matrix_market(getattr(jgen, gen)(*args, **kw),
                                 block_rows=bh)
    mesh, jmesh = _meshes(P)
    A = tpar.shard_bsr_halo(m, P, mesh=mesh, exchange=exchange)
    JA = jbsr.shard_bsr_halo(jm, P, mesh=jmesh, exchange=exchange)
    _same_plan(A, JA, ("bounds", "rows_per_shard", "block_rows_per_shard",
                       "col_blocks_per_shard", "interior_per_shard",
                       "boundary_per_shard", "exchange", "max_distance",
                       "halo_slots", "comm_blocks_exact",
                       "comm_elements_exact", "comm_elements_padded"))
    X = np.random.default_rng(9).standard_normal((m.num_columns, 3))
    Xs = bsr_shard.stack_columns(X, A)
    _close(Xs, jbsr.stack_columns(X, JA, jmesh), 0)
    Y = tpar.sharded_bsr_spmm(A, Xs, mesh)
    _close(Y, _jit(jbsr.sharded_bsr_spmm, JA, jmesh)(Xs))
    want = np.stack([m.spmv(c) for c in X.T], axis=1)
    np.testing.assert_allclose(bsr_shard.unstack_rows(Y, A), want,
                               rtol=1e-12, atol=1e-12 * np.abs(want).max())
    x = Xs[..., 0].contiguous()
    _close(tpar.sharded_bsr_spmv(A, x, mesh),
           _jit(jbsr.sharded_bsr_spmv, JA, jmesh)(x))


def test_bsr_extended_x_is_own_tiles_then_halo():
    """Shard q's extended X is its own S rows, then its received halo
    tiles (zeros where no shard sends), and its blocks' columns index
    it: interior blocks their own tile, boundary blocks past it."""
    m = BsrMatrix.from_matrix_market(tgen.poisson2d(32, 16), block_rows=8)
    mesh, _ = _meshes(4)
    A = tpar.shard_bsr_halo(m, 4, mesh=mesh)
    assert A.exchange == "neighbor"
    CB, S = A.col_blocks_per_shard, A.rows_per_shard
    X = np.arange(m.num_columns, dtype=np.float64)[:, None] + 1.0
    Xs = bsr_shard.stack_columns(X, A)
    ext = bsr_shard.extend_columns(A, Xs)
    slots = A.ext_index.shape[1] - CB
    assert ext.shape == (4, (CB + slots) * 128, 1)
    for q in range(4):
        assert torch.equal(ext[q, :S], Xs[q])
        halo = ext[q, S:, 0].reshape(slots, 128)
        for s in range(slots):
            if A.ext_missing is not None and A.ext_missing[q, CB + s]:
                assert (halo[s] == 0).all()
            else:
                t = int(A.ext_index[q, CB + s])
                assert torch.equal(halo[s], Xs.reshape(-1, 128)[t])
        assert A.blocks[q].num_columns == (CB + slots) * 128


@pytest.mark.parametrize("build", ["well", "well_halo", "wellcw", "bsr"])
def test_rectangular_matrices_refused_as_jax(build):
    mm = tgen.random_sparse(300, 200, 4, seed=1)
    jmm = jgen.random_sparse(300, 200, 4, seed=1)
    if build == "bsr":
        m = BsrMatrix.from_matrix_market(mm, block_rows=8)
        jm = JBsr.from_matrix_market(jmm, block_rows=8)
        port, jax_ = tpar.shard_bsr_halo, jbsr.shard_bsr_halo
    else:
        m, jm = (CsrMatrix.from_matrix_market(mm),
                 JCsr.from_matrix_market(jmm))
        port, jax_ = {"well": (tpar.shard_well, jpar.shard_well),
                      "well_halo": (tpar.shard_well_halo,
                                    jpar.shard_well_halo),
                      "wellcw": (tpar.shard_wellcw_halo,
                                 jpar.shard_wellcw_halo)}[build]
    with pytest.raises(JMatrixError, match="square"):
        jax_(jm, 2)
    with pytest.raises(MatrixError, match="square"):
        port(m, 2, mesh=_meshes(2)[0])


def test_padded_csr_refused_as_jax():
    """WELL and WELL-CW shards take an unpadded CSR, as JAX's."""
    mm = tgen.poisson2d(16, 16)
    m = CsrMatrix.from_matrix_market(mm, row_alignment=8)
    jm = JCsr.from_matrix_market(jgen.poisson2d(16, 16), row_alignment=8)
    assert int(m.row_ptr[-1]) != m.num_entries
    for port, jax_ in ((tpar.shard_well, jpar.shard_well),
                       (tpar.shard_well_halo, jpar.shard_well_halo),
                       (tpar.shard_wellcw_halo, jpar.shard_wellcw_halo)):
        with pytest.raises(JMatrixError, match="unpadded"):
            jax_(jm, 2)
        with pytest.raises(MatrixError, match="unpadded"):
            port(m, 2, mesh=_meshes(2)[0])


def test_each_product_is_its_kernels_a_shard(monkeypatch):
    """The launch structure the card runs, counted on the CPU through the
    wrappers: one K5 call a shard on the flat stacked x (all-gather) or
    on the shard's own x (halo), then the boundary CSR SpMV accumulating;
    one WELL-CW product a shard and the boundary CSR; one K7 call a
    shard on its extended X; each the container's
    ``launches_a_product``."""
    calls = []

    def spy(name, fn):
        def wrapped(A, x, *args, **kw):
            calls.append((name, A.num_rows, A.num_columns,
                          kw.get("accumulate", False)))
            return fn(A, x, *args, **kw)
        return wrapped

    for mod, name in ((well_shard, "well_spmv_core"),
                      (well_shard, "csr_spmv_core"),
                      (wellcw_shard, "wellcw_spmv_core"),
                      (wellcw_shard, "wellcw_spmm_core"),
                      (wellcw_shard, "csr_spmv_core"),
                      (wellcw_shard, "csr_spmm_core"),
                      (bsr_shard, "bsr_spmm_core")):
        monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    m = CsrMatrix.from_matrix_market(tgen.banded_random(2048, 200, 6,
                                                        seed=4))
    mesh = tpar.make_mesh(4, devices=[CPU] * 4)
    x = np.ones(m.num_rows)
    W = tpar.shard_well(m, 4, mesh=mesh)
    R = W.rows_per_shard
    tpar.sharded_well_spmv(W, tpar.stack_vector(x, W), mesh)
    assert calls == [("well_spmv_core", R, 4 * R, False)] * 4
    assert W.launches_a_product() == {"well_whole_core": 4}
    calls.clear()
    H = tpar.shard_well_halo(m, 4, mesh=mesh)
    slots = H.recv_index.shape[1]
    tpar.sharded_well_halo_spmv(H, tpar.stack_vector(x, H), mesh)
    assert calls == [("well_spmv_core", R, R, False),
                     ("csr_spmv_core", R, slots, True)] * 4
    assert H.launches_a_product() == {"well_whole_core": 4,
                                      "csr_spmv_core": 4}
    calls.clear()
    C = tpar.shard_wellcw_halo(m, 4, mesh=mesh)
    tpar.sharded_wellcw_halo_spmv(C, tpar.stack_vector(x, C), mesh)
    tpar.sharded_wellcw_halo_spmm(
        C, tpar.stack_block(np.ones((m.num_rows, 2)), C), mesh)
    assert calls == ([("wellcw_spmv_core", R, R, False),
                      ("csr_spmv_core", R, slots, True)] * 4
                     + [("wellcw_spmm_core", R, R, False),
                        ("csr_spmm_core", R, slots, True)] * 4)
    n = C.launches_a_product()
    assert n["csr_spmv_core"] >= 4 and sum(n.values()) >= 8
    calls.clear()
    B = tpar.shard_bsr_halo(BsrMatrix.from_matrix_market(
        tgen.poisson2d(32, 32), block_rows=16), 4, mesh=mesh)
    width = B.ext_index.shape[1] * 128
    tpar.sharded_bsr_spmm(B, bsr_shard.stack_columns(np.ones((1024, 2)), B),
                          mesh)
    assert calls == [("bsr_spmm_core", B.rows_per_shard, width, False)] * 4
    assert B.launches_a_product() == {"bsr_spmm_core": 4}

"""One rank of a ``torch.distributed`` job for tests/test_torch_distributed.py
and tests/test_torch_distributed_formats.py.

The port's counterpart of ``tests/_mp_worker.py``, importing no JAX and
nothing of ``spmv_tpu``.  Every rank of a Gloo job on the CPU (float64)
joins through a ``file://`` store, builds the process mesh of ``P``
shards, computes every case of a case list over it and writes, a case,
the stacked rows of its own shards and the whole unstacked vector (the
collective ``unstack``) with ``np.save``, and the iteration counts, the
containers' envelope numbers and its place in the job to
``meta.r<rank>.json``:

    python tests/_torch_mp_worker.py <store file> <world size> <rank> <out dir> [first|formats]

``first`` (the default) runs ``CASES``: the DIA, all-gather CSR and
halo CSR paths with CG, PCG and batched CG.  ``formats`` runs
``FORMAT_CASES``: the WELL, WELL-CW and BSR products, the block-Jacobi
IC(0) apply, block-IC(0) PCG, Chebyshev, ``lanczos_bounds``, GMRES,
BiCGSTAB (plain and with block-IC(0)) and LOBPCG, then
``dryrun_multichip(P)``, whose dict goes to the meta file.  LOBPCG's
random P is ``lobpcg_p0.npy`` of the out dir where the test wrote one
(JAX's draw), each rank passing its rows.

``run_case`` and ``run_format_case`` are the one definition of a case:
the tests run them on a single-process mesh of ``P`` virtual shards for
the rows every rank's must equal.
"""

import json
import os
import sys

import numpy as np

P = 8                    # shards: the JAX mp worker's 2 x 4 devices
K = 3                    # SpMM columns
K_CG = 2                 # batched CG's right-hand sides
TOL = 1e-10
MAX_ITERATIONS = 500

# generator, arguments: the same calls make the JAX package's matrices
MATS = {
    "poisson16": ("poisson2d", (16, 16), {}),     # the JAX mp worker's
    "poisson32": ("poisson2d", (32, 32), {}),     # every shard holds rows
    "random200": ("random_sparse", (200, 200, 6), {"seed": 7}),
    "banded256": ("banded_random", (256, 80, 6), {"seed": 3}),  # D = 3
    # tests/test_torch_shard_formats.py's and test_torch_shard_solvers.py's
    "poisson32x16": ("poisson2d", (32, 16), {}),
    "random600": ("random_sparse", (600, 600, 5), {"seed": 2}),
    "banded1000": ("banded_random", (1000, 100, 6), {"seed": 3}),
    "aniso24": ("anisotropic2d", (24, 24), {"epsilon": 0.01}),
}

PRODUCTS = (
    ("dia_spmv", "poisson16", None), ("dia_spmm", "poisson16", None),
    ("dia_spmv", "poisson32", None), ("dia_spmm", "poisson32", None),
    ("csr_spmv", "random200", None), ("csr_spmv", "poisson32", None),
    ("halo_spmv", "banded256", "neighbor"),
    ("halo_spmm", "banded256", "neighbor"),
    ("halo_spmv", "banded256", "all2all"),
    ("halo_spmm", "banded256", "all2all"),
)
SOLVERS = tuple((kind, "poisson16", None) for kind in (
    "cg_dia", "cg_csr", "cg_halo", "pcg_dia", "pcg_halo", "bcg_dia",
    "bcg_halo"))
# the halo path's receive buffers, against the single-process gather
RECEIVES = (("halo_recv", "banded256", "neighbor"),
            ("halo_recv", "banded256", "all2all"))
CASES = PRODUCTS + SOLVERS + RECEIVES

WINDOW_ROWS = 2          # the WELL paths' window rows
BSR_ROWS = 8             # the BSR block height
SOLVER_TOL = 1e-8        # GMRES, BiCGSTAB, Chebyshev, block-IC(0) PCG
EIG_K = 4
EIG_TOL = 1e-5
EIG_MAX = 400
LANCZOS_STEPS = 30
FORMAT_PRODUCTS = (
    ("well_spmv", "poisson32x16", None), ("well_spmv", "banded1000", None),
    ("wellhalo_spmv", "banded1000", "neighbor"),
    ("wellhalo_spmv", "banded1000", "all2all"),
    ("wellhalo_spmv", "random600", None),
    ("wellcw_spmv", "banded1000", "neighbor"),
    ("wellcw_spmm", "banded1000", "neighbor"),
    ("wellcw_spmv", "banded1000", "all2all"),
    ("wellcw_spmm", "banded1000", "all2all"),
    ("wellcw_spmv", "random600", None), ("wellcw_spmm", "random600", None),
    ("bsr_spmm", "poisson32x16", "neighbor"),
    ("bsr_spmm", "poisson32x16", "all2all"),
    ("bsr_spmm", "random600", None),
    ("ic0_apply", "poisson16", None), ("ic0_apply", "aniso24", None),
)
FORMAT_SOLVERS = (
    ("ic0_pcg", "aniso24", None), ("chebyshev", "poisson16", None),
    ("lanczos", "poisson16", None), ("gmres", "poisson16", None),
    ("bicgstab", "poisson16", None), ("bicgstab_ic0", "aniso24", None),
    ("lobpcg", "poisson16", None),
    # LOBPCG's own draw of P: each rank's rows of the global one
    ("lobpcg_draw", "poisson16", None),
)
FORMAT_CASES = FORMAT_PRODUCTS + FORMAT_SOLVERS


def case_name(case) -> str:
    return "-".join(c for c in case if c)


def host_matrix(name: str):
    from spmv_tpu_torch.io import generate
    from spmv_tpu_torch.models import CsrMatrix, DiaMatrix

    gen, args, kw = MATS[name]
    mm = getattr(generate, gen)(*args, **kw)
    return CsrMatrix.from_matrix_market(mm), DiaMatrix.from_matrix_market(mm)


def _sharded(kind: str, m, d, mesh, exchange):
    """(container, stack, unstack, matvec, matmat) of a path; matmat
    keeps the columns on axis 1, as batched CG reduces them."""
    import spmv_tpu_torch.parallel as par

    if kind == "dia":
        A = par.shard_dia(d, P, mesh=mesh)
        return (A, lambda v: par.stack_dia_vector(v, A),
                lambda v: par.unstack_dia_vector(v, A),
                par.make_sharded_dia_matvec(A, mesh),
                par.make_sharded_dia_matmat(A, mesh))
    if kind == "csr":
        A = par.shard_csr(m, P, mesh=mesh)
        return (A, lambda v: par.stack_vector(v, A, mesh),
                lambda v: par.unstack_vector(v, A),
                par.make_sharded_matvec(A, mesh), None)
    A = par.shard_csr_halo(m, P, mesh=mesh, exchange=exchange)
    mm = par.make_sharded_halo_matmat(A, mesh)

    def matmat(V):                       # (P, k, R) <-> (P, R, k)
        return mm(V.transpose(1, 2).contiguous()).transpose(1, 2)

    matmat.mesh = mm.mesh
    return (A, lambda v: par.stack_vector(v, A, mesh),
            lambda v: par.unstack_vector(v, A),
            par.make_sharded_halo_matvec(A, mesh), matmat)


def inputs(kind: str, m) -> dict:
    """The host inputs of a case of ``kind`` on the host CSR ``m``, drawn
    from ``default_rng(4)``: x (SpMV), X (SpMM), or the solution
    ``x_true`` with b = A x_true (CG, PCG) or the block X with B = A X
    (batched CG)."""
    rng = np.random.default_rng(4)
    n = m.num_rows
    if kind.endswith("spmm"):
        return {"X": rng.standard_normal((n, K))}
    if kind[:3] not in ("cg_", "pcg", "bcg"):
        return {"x": rng.standard_normal(n)}
    x_true = rng.standard_normal(n)
    if kind.startswith("bcg"):
        X = np.stack([x_true, 2.0 * x_true[::-1]], axis=1)[:, :K_CG]
        return {"X": X, "B": np.stack([m.spmv(c) for c in X.T], axis=1)}
    return {"x": x_true, "b": m.spmv(x_true)}


def run_case(case, mesh) -> dict:
    """One case on ``mesh``: {"rows": this process's stacked rows,
    "full": the whole unstacked vector or block, "iterations": None, an
    int or a list}."""
    import spmv_tpu_torch.ops as ops
    import spmv_tpu_torch.parallel as par

    kind, mat, exchange = case
    m, d = host_matrix(mat)
    path = kind.split("_")[-1] if kind[:3] in ("cg_", "pcg", "bcg") \
        else kind.split("_")[0]
    A, stack, unstack, matvec, matmat = _sharded(path, m, d, mesh,
                                                 exchange or "auto")
    got = inputs(kind, m)
    if kind in ("dia_spmv", "csr_spmv", "halo_spmv"):
        y = matvec(stack(got["x"]))
        return {"rows": y.numpy(), "full": unstack(y), "iterations": None}
    if kind in ("dia_spmm", "halo_spmm"):
        X = got["X"]
        if kind == "dia_spmm":
            Y = par.sharded_dia_spmm(A, par.stack_dia_matrix(X, A), mesh)
            return {"rows": Y.numpy(), "full": par.unstack_dia_matrix(Y, A),
                    "iterations": None}
        Y = par.sharded_halo_spmm(A, par.stack_block(X, A, mesh), mesh)
        return {"rows": Y.numpy(), "full": par.unstack_block(Y, A),
                "iterations": None}
    if kind == "halo_recv":
        recv = par.halo_shard.halo_of(A, stack(got["x"]))
        return {"rows": recv.numpy(), "full": None, "iterations": None}
    if kind.startswith("bcg"):
        B = got["B"]
        Bs = (par.stack_dia_matrix(B, A) if path == "dia"
              else stack(B).transpose(1, 2).contiguous())
        res = ops.batched_conjugate_gradient(
            matmat, Bs, tol=TOL, max_iterations=MAX_ITERATIONS)
        full = (par.unstack_dia_matrix(res.x, A) if path == "dia"
                else unstack(res.x.transpose(1, 2)))
        return {"rows": res.x.numpy(), "full": full,
                "iterations": [int(i) for i in res.iterations]}
    bs = stack(got["b"])
    if kind.startswith("pcg"):
        diag = stack(ops.extract_diagonal(m))
        res = ops.preconditioned_conjugate_gradient(
            matvec, bs, ops.jacobi_preconditioner(diag), tol=TOL,
            max_iterations=MAX_ITERATIONS)
    else:
        res = ops.conjugate_gradient(matvec, bs, tol=TOL,
                                     max_iterations=MAX_ITERATIONS)
    return {"rows": res.x.numpy(), "full": unstack(res.x),
            "iterations": int(res.iterations)}


def _format_container(kind, mat, mesh, exchange):
    """The sharded container of a format case and the envelope numbers
    it reports (JAX's on every rank)."""
    import spmv_tpu_torch.parallel as par
    from spmv_tpu_torch.models.bsr import BsrMatrix

    m, _ = host_matrix(mat)
    ex = exchange or "auto"
    halo = ("exchange", "max_distance", "halo_slots", "comm_elements_exact",
            "comm_elements_padded")
    if kind == "well":
        A = par.shard_well(m, P, window_rows=WINDOW_ROWS, mesh=mesh)
        fields = ("rows_per_shard", "chunks_per_shard", "spill_per_shard")
    elif kind == "wellhalo":
        A = par.shard_well_halo(m, P, window_rows=WINDOW_ROWS, mesh=mesh,
                                exchange=ex)
        fields = ("rows_per_shard",) + halo
    elif kind == "wellcw":
        A = par.shard_wellcw_halo(m, P, mesh=mesh, exchange=ex)
        fields = ("rows_per_shard",) + halo
    elif kind == "bsr":
        gen, args, kw = MATS[mat]
        from spmv_tpu_torch.io import generate

        A = par.shard_bsr_halo(BsrMatrix.from_matrix_market(
            getattr(generate, gen)(*args, **kw), block_rows=BSR_ROWS), P,
            mesh=mesh, exchange=ex)
        fields = ("rows_per_shard", "interior_per_shard",
                  "boundary_per_shard", "comm_blocks_exact") + halo
    else:
        A = par.shard_csr_halo(m, P, mesh=mesh, exchange=ex)
        fields = ("rows_per_shard",) + halo
    return m, A, {f: getattr(A, f) for f in fields}


def run_format_case(case, mesh, p0=None) -> dict:
    """One case of ``FORMAT_CASES`` on ``mesh``: {"rows": this process's
    stacked rows, "full": the whole unstacked vector or block (LOBPCG:
    the eigenvalues), "input": the stacked input's rows (b for a
    solver), "iterations": None or an int, "envelope": the container's
    numbers}.  ``p0``: LOBPCG's global random P, or None."""
    import torch

    import spmv_tpu_torch.ops as ops
    import spmv_tpu_torch.parallel as par
    from spmv_tpu_torch.parallel import bsr_shard, halo_shard

    kind, mat, exchange = case
    path = kind.split("_")[0]
    m, A, env = _format_container(
        path if kind.endswith(("spmv", "spmm")) else "csr", mat, mesh,
        exchange)
    rng = np.random.default_rng(4)
    n = m.num_rows
    if path == "bsr":
        Xs = bsr_shard.stack_columns(rng.standard_normal((n, K)), A, mesh)
        Y = par.sharded_bsr_spmm(A, Xs, mesh)
        return {"rows": Y.numpy(), "full": bsr_shard.unstack_rows(Y, A),
                "input": Xs.numpy(), "iterations": None, "envelope": env}
    if kind.endswith("spmm"):
        Xs = par.stack_block(rng.standard_normal((n, K)), A, mesh)
        Y = par.sharded_wellcw_halo_spmm(A, Xs, mesh)
        return {"rows": Y.numpy(), "full": par.unstack_block(Y, A),
                "input": Xs.numpy(), "iterations": None, "envelope": env}
    if kind.endswith("spmv"):
        xs = par.stack_vector(rng.standard_normal(n), A, mesh)
        product = {"well": par.sharded_well_spmv,
                   "wellhalo": par.sharded_well_halo_spmv,
                   "wellcw": par.sharded_wellcw_halo_spmv}[path]
        y = product(A, xs, mesh)
        return {"rows": y.numpy(), "full": par.unstack_vector(y, A),
                "input": xs.numpy(), "iterations": None, "envelope": env}
    if "ic0" in kind:
        M = par.block_jacobi_ic0(m, A.bounds, A.rows_per_shard, mesh=mesh)
        env.update(shift_used=M.shift_used, num_levels=M.num_levels,
                   width=M.width, max_deps=M.max_deps)
    mv = par.make_sharded_halo_matvec(A, mesh)
    if kind == "ic0_apply":
        rs = par.stack_vector(rng.standard_normal(n), A, mesh)
        z = par.sharded_block_ic0_apply(M, rs, mesh)
        return {"rows": z.numpy(), "full": par.unstack_vector(z, A),
                "input": rs.numpy(), "iterations": None, "envelope": env}
    if kind.startswith("lobpcg"):
        k, R, here = EIG_K, A.rows_per_shard, mesh.local_shards
        X0 = par.stack_block(rng.standard_normal((n, k)), A, mesh)
        pk = None
        if kind == "lobpcg" and p0 is not None:
            pk = torch.from_numpy(p0[here.start * R: here.stop * R])
        res = ops.lobpcg(halo_shard.make_sharded_halo_flat_matmat(A, mesh),
                         X0.reshape(-1, k), tol=EIG_TOL,
                         max_iterations=EIG_MAX,
                         mask=halo_shard.stacked_row_mask(A, mesh), P0=pk)
        return {"rows": res.eigenvectors.numpy(),
                "full": res.eigenvalues.numpy(), "input": X0.numpy(),
                "iterations": int(res.iterations), "envelope": env}
    if kind == "lanczos":
        lo, hi = ops.lanczos_bounds(mv, (P, A.rows_per_shard),
                                    num_steps=LANCZOS_STEPS,
                                    dtype=torch.float64)
        env["bounds"] = [lo, hi]
        return {"rows": np.zeros(0), "full": np.array([lo, hi]),
                "input": np.zeros(0), "iterations": None, "envelope": env}
    bs = par.stack_vector(m.spmv(np.ones(n)), A, mesh)
    if kind == "ic0_pcg":
        res = ops.preconditioned_conjugate_gradient(
            mv, bs, par.make_sharded_block_ic0_preconditioner(M, mesh),
            tol=SOLVER_TOL, max_iterations=2000)
    elif kind == "chebyshev":
        v0 = par.stack_vector(rng.standard_normal(n), A, mesh)
        lo, hi = ops.lanczos_bounds(mv, (P, A.rows_per_shard),
                                    num_steps=LANCZOS_STEPS,
                                    dtype=torch.float64, v0=v0)
        env["bounds"] = [lo, hi]
        res = ops.chebyshev(mv, bs, lo, hi, tol=SOLVER_TOL,
                            max_iterations=3000, check_every=10)
    elif kind == "gmres":
        res = ops.gmres(mv, bs, tol=SOLVER_TOL, restart=8,
                        max_iterations=500)
    else:
        pre = (par.make_sharded_block_ic0_preconditioner(M, mesh)
               if kind == "bicgstab_ic0" else None)
        res = ops.bicgstab(mv, bs, pre, tol=SOLVER_TOL, max_iterations=500)
    return {"rows": res.x.numpy(), "full": par.unstack_vector(res.x, A),
            "input": bs.numpy(), "iterations": int(res.iterations),
            "envelope": env}


def main() -> int:
    store, world, rank, out = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    which = sys.argv[5] if len(sys.argv) > 5 else "first"
    os.environ["SPMV_TPU_TORCH_DEVICE"] = "cpu"
    import torch

    torch.set_default_dtype(torch.float64)
    # one thread a rank: ranks spinning on idle intra-op threads of
    # each other's cores took ten times as long
    torch.set_num_threads(1)
    import spmv_tpu_torch.parallel as par

    multi = par.initialize_distributed(f"file://{store}", world, rank)
    assert multi == (world > 1) and par.is_multi_host() == (world > 1)
    assert par.initialize_distributed() == multi       # idempotent
    mesh = par.global_mesh(P)
    meta = {"info": par.host_local_info(),
            "mesh_info": par.mesh_info(mesh),
            "local_shards": [mesh.local_shards.start,
                             mesh.local_shards.stop],
            "iterations": {}, "envelope": {}}
    p0 = os.path.join(out, "lobpcg_p0.npy")
    p0 = np.load(p0) if os.path.exists(p0) else None
    for case in CASES if which == "first" else FORMAT_CASES:
        got = (run_case(case, mesh) if which == "first"
               else run_format_case(case, mesh, p0))
        name = case_name(case)
        np.save(os.path.join(out, f"{name}.r{rank}.npy"), got["rows"])
        if got["full"] is not None:
            np.save(os.path.join(out, f"{name}.full.r{rank}.npy"),
                    got["full"])
        meta["iterations"][name] = got["iterations"]
        meta["envelope"][name] = got.get("envelope")
    if which == "formats":
        from spmv_tpu_torch.parallel.dryrun import dryrun_multichip

        meta["dryrun"] = dryrun_multichip(P)
    with open(os.path.join(out, f"meta.r{rank}.json"), "w") as f:
        json.dump(meta, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

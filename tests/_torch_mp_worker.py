"""One rank of a ``torch.distributed`` job for tests/test_torch_distributed.py.

The port's counterpart of ``tests/_mp_worker.py``, importing no JAX and
nothing of ``spmv_tpu``.  Every rank of a Gloo job on the CPU (float64)
joins through a ``file://`` store, builds the process mesh of ``P``
shards, computes every case of ``CASES`` over it and writes, a case, the
stacked rows of its own shards and the whole unstacked vector (the
collective ``unstack``) with ``np.save``, and the iteration counts and
its place in the job to ``meta.r<rank>.json``:

    python tests/_torch_mp_worker.py <store file> <world size> <rank> <out dir>

``run_case`` is the one definition of a case: the test runs it on a
single-process mesh of ``P`` virtual shards for the rows every rank's
must equal.
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
            matmat, Bs, tol=TOL, max_iterations=MAX_ITERATIONS, mesh=mesh)
        full = (par.unstack_dia_matrix(res.x, A) if path == "dia"
                else unstack(res.x.transpose(1, 2)))
        return {"rows": res.x.numpy(), "full": full,
                "iterations": [int(i) for i in res.iterations]}
    bs = stack(got["b"])
    if kind.startswith("pcg"):
        diag = stack(ops.extract_diagonal(m))
        res = ops.preconditioned_conjugate_gradient(
            matvec, bs, ops.jacobi_preconditioner(diag), tol=TOL,
            max_iterations=MAX_ITERATIONS, mesh=mesh)
    else:
        res = ops.conjugate_gradient(matvec, bs, tol=TOL,
                                     max_iterations=MAX_ITERATIONS,
                                     mesh=mesh)
    return {"rows": res.x.numpy(), "full": unstack(res.x),
            "iterations": int(res.iterations)}


def main() -> int:
    store, world, rank, out = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
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
            "iterations": {}}
    for case in CASES:
        got = run_case(case, mesh)
        name = case_name(case)
        np.save(os.path.join(out, f"{name}.r{rank}.npy"), got["rows"])
        if got["full"] is not None:
            np.save(os.path.join(out, f"{name}.full.r{rank}.npy"),
                    got["full"])
        meta["iterations"][name] = got["iterations"]
    with open(os.path.join(out, f"meta.r{rank}.json"), "w") as f:
        json.dump(meta, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

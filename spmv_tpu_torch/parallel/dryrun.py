"""``dryrun_multichip``: the sharded strategies, end to end.

The port's counterpart of ``dryrun_multichip`` in ``__graft_entry__.py``:
its eleven strategies on the same fixtures, inputs drawn from one
``default_rng(0)`` in the same order, and the same tolerances, on a mesh
of ``n_shards`` virtual shards of one device, or, in a job of several
``torch.distributed`` ranks (``initialize_distributed``), on
``global_mesh(n_shards)``:

- CG over the all-gather CSR matvec (``parallel.shard``), on
  poisson2d(8, 2 P);
- CG over the DIA halo matvec (``parallel.dia_shard``, K1 a shard);
- CG over the ragged-halo CSR matvec (``parallel.halo_shard``);
- the WELL halo SpMV (``parallel.well_shard``) on poisson2d(16 P, 16),
  window rows 2, whose exchange must not be ``none``;
- the WELL-CW halo SpMV (``parallel.wellcw_shard``) on
  random_sparse(256 P, 256 P, 5, seed 2), ``all2all`` forced;
- the BSR halo SpMM (``parallel.bsr_shard``) on the WELL strategy's
  matrix in blocks of 8 rows, k = 2, whose exchange must not be
  ``none``;
- Chebyshev over the halo CSR matvec, its bounds from ``lanczos_bounds``
  (30 steps from a stacked random start);
- Jacobi-PCG over the halo CSR matvec, residual replaced every 25;
- batched CG over the DIA matmat at k = 2 (K2 a shard);
- block-Jacobi IC(0) PCG over the halo CSR matvec
  (``parallel.precond_shard``, ``tri_solve`` a shard);
- LOBPCG at k = 2 over the halo CSR SpMM with the stacked layout's
  padding rows masked, to 1e-4 of the analytic eigenvalues.

Each solve and product must reach a relative error below 1e-3 (float32
too); it prints one line of the JAX function's form and returns the
numbers.  The LOBPCG's random start of P is the port's own draw (JAX
draws it from ``PRNGKey(0)``).  Across ranks every draw is the whole
vector's, each rank stacks its own shards' rows, the solvers sum their
dots over the ranks, and every error is taken on the gathered whole
vector: every rank returns the same numbers, and rank 0 alone prints
the line.

    python -m spmv_tpu_torch.parallel.dryrun [N_SHARDS]
    torchrun --nproc-per-node 2 -m spmv_tpu_torch.parallel.dryrun [N_SHARDS]
"""

from __future__ import annotations

import sys

import numpy as np

from spmv_tpu_torch.errors import SpmvError

__all__ = ["dryrun_multichip"]

TOL = 1e-6
MAX_ITERATIONS = 500
MAX_REL_ERR = 1e-3
MAX_EIG_REL_ERR = 1e-4
RECOMPUTE_EVERY = 25
K_RHS = 2
K_EIG = 2


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _check(what: str, err: float, bound: float = MAX_REL_ERR) -> float:
    if not err < bound:
        raise SpmvError(f"sharded {what} rel err {err}")
    return err


def _poisson_eigs(nx: int, ny: int, k: int) -> np.ndarray:
    i = np.arange(1, nx + 1)
    j = np.arange(1, ny + 1)
    lam = (4.0 - 2.0 * np.cos(i * np.pi / (nx + 1.0))[:, None]
           - 2.0 * np.cos(j * np.pi / (ny + 1.0))[None])
    return np.sort(lam.reshape(-1))[:k]


def dryrun_multichip(n_shards: int, device=None) -> dict:
    """Run the eleven strategies on ``n_shards`` virtual shards of
    ``device`` (default: ``default_device()``), or over the ranks of the
    job where one runs (``device`` is then the rank's own), print one
    line (rank 0) and return {strategy: {"iterations", "rel_err",
    ...}}."""
    from spmv_tpu_torch.io.generate import poisson2d, random_sparse
    from spmv_tpu_torch.models import CsrMatrix, DiaMatrix
    from spmv_tpu_torch.models.bsr import BsrMatrix
    from spmv_tpu_torch.models.device import resolve_device
    from spmv_tpu_torch.ops import (
        batched_conjugate_gradient,
        chebyshev,
        conjugate_gradient,
        extract_diagonal,
        jacobi_preconditioner,
        lanczos_bounds,
        lobpcg,
        preconditioned_conjugate_gradient,
    )
    from spmv_tpu_torch.parallel import (
        block_jacobi_ic0,
        make_mesh,
        make_sharded_block_ic0_preconditioner,
        make_sharded_dia_matmat,
        make_sharded_dia_matvec,
        make_sharded_halo_matvec,
        make_sharded_matvec,
        shard_bsr_halo,
        shard_csr,
        shard_csr_halo,
        shard_dia,
        shard_well_halo,
        shard_wellcw_halo,
        sharded_bsr_spmm,
        sharded_well_halo_spmv,
        sharded_wellcw_halo_spmv,
        stack_block,
        stack_dia_matrix,
        stack_dia_vector,
        stack_vector,
        unstack_dia_matrix,
        unstack_dia_vector,
        unstack_vector,
    )
    from spmv_tpu_torch.parallel.bsr_shard import stack_columns, unstack_rows
    from spmv_tpu_torch.parallel.distributed import global_mesh, is_multi_host
    from spmv_tpu_torch.parallel.halo_shard import (
        make_sharded_halo_flat_matmat,
        stacked_row_mask,
    )

    if is_multi_host():
        mesh = global_mesh(n_shards)
        dev = mesh.device
    else:
        dev = resolve_device(device)
        mesh = make_mesh(n_shards, devices=[dev] * n_shards)
    mm = poisson2d(8, 2 * n_shards)  # tiny, but rows > shards
    host = CsrMatrix.from_matrix_market(mm)
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(mm.num_rows)
    b = host.spmv(x_true)
    out = {}

    def solved(what, res, x):
        return {"iterations": res.iterations,
                "rel_err": _check(what, _rel(x, x_true))}

    # 1: CSR, x all-gathered: one sharded SpMV, then CG
    A = shard_csr(host, n_shards, partition="nnz", mesh=mesh)
    bs = stack_vector(b, A, mesh=mesh)
    matvec = make_sharded_matvec(A, mesh)
    y_err = _check("CSR SpMV", _rel(unstack_vector(matvec(bs), A),
                                    host.spmv(b)))
    res = conjugate_gradient(matvec, bs, tol=TOL,
                             max_iterations=MAX_ITERATIONS)
    out["csr_all_gather"] = {**solved("CG", res, unstack_vector(res.x, A)),
                             "spmv_rel_err": y_err}

    # 2: DIA, nearest-neighbour halos
    dia = DiaMatrix.from_matrix_market(mm)
    Ad = shard_dia(dia, n_shards, mesh=mesh)
    res = conjugate_gradient(make_sharded_dia_matvec(Ad, mesh),
                             stack_dia_vector(b, Ad), tol=TOL,
                             max_iterations=MAX_ITERATIONS)
    out["dia_halo"] = solved("DIA CG", res, unstack_dia_vector(res.x, Ad))

    # 3: CSR, ragged halo exchange
    Ah = shard_csr_halo(host, n_shards, partition="nnz", mesh=mesh)
    matvec_h = make_sharded_halo_matvec(Ah, mesh)
    res = conjugate_gradient(matvec_h, bs, tol=TOL,
                             max_iterations=MAX_ITERATIONS)
    out["csr_halo"] = {**solved("halo-CSR CG", res,
                                unstack_vector(res.x, Ah)),
                       "exchange": Ah.exchange,
                       "comm_elements_padded": Ah.comm_elements_padded}

    # 4: WELL halo SpMV; WELL shards are 128-row groups, so a matrix
    # large enough that the shards exchange halos
    mm_w = poisson2d(16 * n_shards, 16)
    host_w = CsrMatrix.from_matrix_market(mm_w)
    Aw = shard_well_halo(host_w, n_shards, window_rows=2, mesh=mesh)
    b_w = rng.standard_normal(mm_w.num_rows)
    y_w = unstack_vector(sharded_well_halo_spmv(
        Aw, stack_vector(b_w, Aw, mesh=mesh), mesh), Aw)
    if Aw.exchange == "none":
        raise SpmvError("WELL halo dryrun degenerated to no exchange")
    out["well_halo"] = {"exchange": Aw.exchange, "rel_err": _check(
        "halo-WELL SpMV", _rel(y_w, host_w.spmv(b_w)))}

    # 5: WELL-CW halo SpMV, the all2all branch forced
    mm_c = random_sparse(256 * n_shards, 256 * n_shards, 5, seed=2)
    host_c = CsrMatrix.from_matrix_market(mm_c)
    Ac = shard_wellcw_halo(host_c, n_shards, mesh=mesh, exchange="all2all")
    b_c = rng.standard_normal(mm_c.num_rows)
    y_c = unstack_vector(sharded_wellcw_halo_spmv(
        Ac, stack_vector(b_c, Ac, mesh=mesh), mesh), Ac)
    out["wellcw_halo"] = {
        "exchange": Ac.exchange,
        "comm_elements_padded": Ac.comm_elements_padded,
        "rel_err": _check("halo-WELL-CW SpMV", _rel(y_c, host_c.spmv(b_c)))}

    # 6: BSR tile-halo SpMM, k = 2
    host_b = BsrMatrix.from_matrix_market(mm_w, block_rows=8)
    Ab = shard_bsr_halo(host_b, n_shards, mesh=mesh)
    Xb = rng.standard_normal((host_b.num_columns, K_RHS))
    Yb = unstack_rows(sharded_bsr_spmm(Ab, stack_columns(Xb, Ab, mesh),
                                       mesh), Ab)
    if Ab.exchange == "none":
        raise SpmvError("BSR halo dryrun degenerated to no exchange")
    out["bsr_halo"] = {
        "exchange": Ab.exchange, "comm_blocks_exact": Ab.comm_blocks_exact,
        "rel_err": _check("halo-BSR SpMM", _rel(Yb, np.stack(
            [host_w.spmv(Xb[:, j]) for j in range(K_RHS)], axis=1)))}

    # 7: Chebyshev over the halo CSR matvec, no reduction in its loop
    v0 = stack_vector(rng.standard_normal(mm.num_rows), A, mesh=mesh)
    lo, hi = lanczos_bounds(matvec_h, (n_shards,) + tuple(bs.shape[1:]),
                            num_steps=30, dtype=bs.dtype, v0=v0, device=dev)
    res = chebyshev(matvec_h, bs, lo, hi, tol=TOL, max_iterations=2000,
                    check_every=10)
    out["chebyshev"] = solved("Chebyshev", res, unstack_vector(res.x, A))

    # 8: Jacobi-PCG over the halo CSR matvec; the stacked diagonal's
    # zeros on padding rows pass through
    diag_s = stack_vector(extract_diagonal(host), A, mesh=mesh)
    res = preconditioned_conjugate_gradient(
        matvec_h, bs, jacobi_preconditioner(diag_s), tol=TOL,
        max_iterations=MAX_ITERATIONS, recompute_every=RECOMPUTE_EVERY)
    out["jacobi_pcg"] = solved("Jacobi-PCG", res, unstack_vector(res.x, A))

    # 9: batched CG over the DIA matmat, k = 2
    X = np.stack([x_true, 2.0 * x_true[::-1].copy()], axis=1)
    B = np.stack([dia.spmv(X[:, j]) for j in range(K_RHS)], axis=1)
    res = batched_conjugate_gradient(make_sharded_dia_matmat(Ad, mesh),
                                     stack_dia_matrix(B, Ad), tol=TOL,
                                     max_iterations=MAX_ITERATIONS)
    out["batched_dia_halo"] = {
        "iterations": [int(i) for i in res.iterations], "k": K_RHS,
        "rel_err": _check("batched CG", _rel(unstack_dia_matrix(res.x, Ad),
                                             X))}

    # 10: block-Jacobi PCG, local IC(0) solves a shard
    Mb = block_jacobi_ic0(host, Ah.bounds, Ah.rows_per_shard, mesh=mesh)
    res = preconditioned_conjugate_gradient(
        matvec_h, bs, make_sharded_block_ic0_preconditioner(Mb, mesh),
        tol=TOL, max_iterations=MAX_ITERATIONS,
        recompute_every=RECOMPUTE_EVERY)
    out["block_ic0_pcg"] = {**solved("block-Jacobi-IC0 PCG", res,
                                     unstack_vector(res.x, Ah)),
                            "shift_used": Mb.shift_used}

    # 11: LOBPCG over the halo CSR SpMM; the padding rows masked out of
    # the basis, or they alias the operator's null space
    X0 = stack_block(rng.standard_normal((mm.num_rows, K_EIG)), Ah,
                     mesh=mesh)
    res = lobpcg(make_sharded_halo_flat_matmat(Ah, mesh),
                 X0.reshape(-1, K_EIG), tol=TOL, max_iterations=300,
                 mask=stacked_row_mask(Ah, mesh))
    want = _poisson_eigs(8, 2 * n_shards, K_EIG)
    got = res.eigenvalues.double().cpu().numpy()
    out["lobpcg"] = {
        "iterations": int(res.iterations), "k": K_EIG,
        "eigenvalues": got.tolist(),
        "rel_err": _check("LOBPCG eigenvalue", float(np.max(
            np.abs(got - want) / want)), MAX_EIG_REL_ERR)}

    o = out
    if mesh.rank != 0:
        return out
    print(
        f"dryrun_multichip({n_shards}): ok — "
        f"{mm.num_rows} rows, {mm.num_entries} nnz, "
        f"CSR(all-gather) CG iters={o['csr_all_gather']['iterations']} "
        f"rel_err={o['csr_all_gather']['rel_err']:.2e}; DIA(halo-ppermute) "
        f"CG iters={o['dia_halo']['iterations']} "
        f"rel_err={o['dia_halo']['rel_err']:.2e}; "
        f"CSR(halo-{Ah.exchange}, {Ah.comm_elements_padded} elems/step) "
        f"CG iters={o['csr_halo']['iterations']} "
        f"rel_err={o['csr_halo']['rel_err']:.2e}; "
        f"WELL(halo-{Aw.exchange}) SpMV "
        f"rel_err={o['well_halo']['rel_err']:.2e}; "
        f"WELL-CW(halo-{Ac.exchange}, {Ac.comm_elements_padded} elems/step) "
        f"SpMV rel_err={o['wellcw_halo']['rel_err']:.2e}; "
        f"BSR(halo-{Ab.exchange}, {Ab.comm_blocks_exact} blocks/step) "
        f"SpMM rel_err={o['bsr_halo']['rel_err']:.2e}; "
        f"Chebyshev(halo-{Ah.exchange}, no-reduction loop) "
        f"iters={o['chebyshev']['iterations']} "
        f"rel_err={o['chebyshev']['rel_err']:.2e}; "
        f"Jacobi-PCG(halo-{Ah.exchange}, residual replacement every "
        f"{RECOMPUTE_EVERY}) iters={o['jacobi_pcg']['iterations']} "
        f"rel_err={o['jacobi_pcg']['rel_err']:.2e}; "
        f"batched-CG(halo-ppermute, k={K_RHS} RHS) "
        f"iters={o['batched_dia_halo']['iterations']} "
        f"rel_err={o['batched_dia_halo']['rel_err']:.2e}; "
        f"block-Jacobi-IC0 PCG(local tri-solves, shift={Mb.shift_used}) "
        f"iters={o['block_ic0_pcg']['iterations']} "
        f"rel_err={o['block_ic0_pcg']['rel_err']:.2e}; "
        f"LOBPCG(halo-{Ah.exchange} SpMM, k={K_EIG}, masked basis) "
        f"iters={o['lobpcg']['iterations']} "
        f"eig_rel_err={o['lobpcg']['rel_err']:.2e}",
        flush=True)
    return out


if __name__ == "__main__":
    from spmv_tpu_torch.parallel.distributed import initialize_distributed

    initialize_distributed()       # torchrun's ranks; alone, a no-op
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()

"""``dryrun_multichip``: the sharded strategies ported so far, end to end.

The port's counterpart of ``dryrun_multichip`` in ``__graft_entry__.py``:
the same tiny problem (poisson2d(8, 2 P), x from ``default_rng(0)``) and
the first four of its strategies, on a mesh of ``n_shards`` virtual
shards on one device:

- CG over the all-gather CSR matvec (``parallel.shard``);
- CG over the DIA halo matvec (``parallel.dia_shard``, K1 a shard);
- CG over the ragged-halo CSR matvec (``parallel.halo_shard``);
- batched CG over the DIA matmat at k = 2 (K2 a shard).

Each must reach a relative error below 1e-3 (float32 too); it prints one
line of the JAX function's form and returns the numbers.

    python -m spmv_tpu_torch.parallel.dryrun [N_SHARDS]
"""

from __future__ import annotations

import sys

import numpy as np

from spmv_tpu_torch.errors import SpmvError

__all__ = ["dryrun_multichip"]

TOL = 1e-6
MAX_ITERATIONS = 500
MAX_REL_ERR = 1e-3


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check(what: str, err: float) -> float:
    if not err < MAX_REL_ERR:
        raise SpmvError(f"sharded {what} rel err {err}")
    return err


def dryrun_multichip(n_shards: int, device=None) -> dict:
    """Run the four strategies on ``n_shards`` virtual shards of
    ``device`` (default: ``default_device()``), print one line and
    return {strategy: {"iterations", "rel_err", ...}}."""
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import CsrMatrix, DiaMatrix
    from spmv_tpu_torch.models.device import resolve_device
    from spmv_tpu_torch.ops import (
        batched_conjugate_gradient,
        conjugate_gradient,
    )
    from spmv_tpu_torch.parallel import (
        make_mesh,
        make_sharded_dia_matmat,
        make_sharded_dia_matvec,
        make_sharded_halo_matvec,
        make_sharded_matvec,
        shard_csr,
        shard_csr_halo,
        shard_dia,
        stack_dia_matrix,
        stack_dia_vector,
        stack_vector,
        unstack_dia_matrix,
        unstack_dia_vector,
        unstack_vector,
    )

    mesh = make_mesh(n_shards, devices=[resolve_device(device)] * n_shards)
    mm = poisson2d(8, 2 * n_shards)  # tiny, but rows > shards
    host = CsrMatrix.from_matrix_market(mm)
    rng = np.random.default_rng(0)
    x_true = rng.standard_normal(mm.num_rows)
    b = host.spmv(x_true)
    out = {}

    # CSR, x all-gathered: one sharded SpMV, then CG
    A = shard_csr(host, n_shards, partition="nnz", mesh=mesh)
    bs = stack_vector(b, A, mesh=mesh)
    matvec = make_sharded_matvec(A, mesh)
    y_err = _check("CSR SpMV", _rel(unstack_vector(matvec(bs), A),
                                    host.spmv(b)))
    res = conjugate_gradient(matvec, bs, tol=TOL,
                             max_iterations=MAX_ITERATIONS)
    out["csr_all_gather"] = {
        "iterations": res.iterations, "spmv_rel_err": y_err,
        "rel_err": _check("CG", _rel(unstack_vector(res.x, A), x_true))}

    # DIA, nearest-neighbour halos
    dia = DiaMatrix.from_matrix_market(mm)
    Ad = shard_dia(dia, n_shards, mesh=mesh)
    res = conjugate_gradient(make_sharded_dia_matvec(Ad, mesh),
                             stack_dia_vector(b, Ad), tol=TOL,
                             max_iterations=MAX_ITERATIONS)
    out["dia_halo"] = {
        "iterations": res.iterations,
        "rel_err": _check("DIA CG", _rel(unstack_dia_vector(res.x, Ad),
                                         x_true))}

    # CSR, ragged halo exchange
    Ah = shard_csr_halo(host, n_shards, partition="nnz", mesh=mesh)
    res = conjugate_gradient(make_sharded_halo_matvec(Ah, mesh), bs,
                             tol=TOL, max_iterations=MAX_ITERATIONS)
    out["csr_halo"] = {
        "iterations": res.iterations, "exchange": Ah.exchange,
        "comm_elements_padded": Ah.comm_elements_padded,
        "rel_err": _check("halo-CSR CG", _rel(unstack_vector(res.x, Ah),
                                              x_true))}

    # batched CG over the DIA matmat, k = 2
    X = np.stack([x_true, 2.0 * x_true[::-1].copy()], axis=1)
    B = np.stack([dia.spmv(X[:, j]) for j in range(X.shape[1])], axis=1)
    res = batched_conjugate_gradient(make_sharded_dia_matmat(Ad, mesh),
                                     stack_dia_matrix(B, Ad), tol=TOL,
                                     max_iterations=MAX_ITERATIONS)
    out["batched_dia_halo"] = {
        "iterations": [int(i) for i in res.iterations], "k": X.shape[1],
        "rel_err": _check("batched CG", _rel(unstack_dia_matrix(res.x, Ad),
                                             X))}

    c, d, h, m = (out[k] for k in ("csr_all_gather", "dia_halo", "csr_halo",
                                   "batched_dia_halo"))
    print(
        f"dryrun_multichip({n_shards}): ok — "
        f"{mm.num_rows} rows, {mm.num_entries} nnz, "
        f"CSR(all-gather) CG iters={c['iterations']} "
        f"rel_err={c['rel_err']:.2e}; DIA(halo-ppermute) CG "
        f"iters={d['iterations']} rel_err={d['rel_err']:.2e}; "
        f"CSR(halo-{h['exchange']}, {h['comm_elements_padded']} elems/step) "
        f"CG iters={h['iterations']} rel_err={h['rel_err']:.2e}; "
        f"batched-CG(halo-ppermute, k={m['k']} RHS) "
        f"iters={m['iterations']} rel_err={m['rel_err']:.2e}",
        flush=True)
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)

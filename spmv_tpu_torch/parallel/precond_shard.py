"""Sharded block-Jacobi preconditioning with local IC(0) solves.

The counterpart of ``spmv_tpu/parallel/precond_shard.py``: M =
blockdiag(A_pp) over the row partition, each shard factoring and
solving only its own diagonal block, so the apply moves nothing between
shards.  Each block is JAX's ``_diag_block``: the rows and columns of
the shard as an (R, R) CSR, R the stacked layout's rows a shard, the
rows past the shard's own (the overflow slot with them) unit-diagonal
pass-throughs.  The blocks are factored IC(0) on the host
(``ops.incomplete.ic0_factor``) through the Manteuffel ladder
``shifts``, one shift for every block (the smallest that factors them
all, ``shift_used``).

Apply: ``z = L^-T (L^-1 r)`` a shard, each triangle a
``DeviceTriSolve`` solved by the port's ``tri_solve`` kernel
(``ops.tri_kernels.tri_solve_core``) in the mode ``tri_solve_plan``
picks for it: one launch a solve chained, or one a level.  JAX runs
both solves as one ``lax.scan`` inside ``shard_map`` with every shard
padded to the common (levels, width, deps) envelope; the port pads no
shard (each runs its own levels), and keeps the envelope's numbers
(``num_levels``, ``width``, ``max_deps``) for reports.

On a process mesh a rank factors and solves only its own shards'
blocks; the apply still moves nothing.  The shift ladder stays one
decision for the whole job: each rank tries a shift on its own blocks,
the ranks agree on which of them failed (``comm.all_reduce_max`` of a
flag a rank), and all of them move to the next shift together, or all
raise the same ``MatrixError``, so that no rank waits in a collective
for a peer that raised.  The envelope is JAX's over every shard on every
rank (``comm.max_over_ranks``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.models.csr import CsrMatrix
from spmv_tpu_torch.models.device import default_value_dtype
from spmv_tpu_torch.ops.incomplete import (
    DeviceTriSolve,
    _transpose_csr,
    ic0_factor,
)
from spmv_tpu_torch.ops.tri_kernels import tri_solve_core, tri_solve_plan
from spmv_tpu_torch.parallel import comm
from spmv_tpu_torch.parallel.mesh import Mesh
from spmv_tpu_torch.parallel.shard import _device, check_mesh, mesh_shards

__all__ = [
    "ShardedBlockJacobiIC0",
    "block_jacobi_ic0",
    "make_sharded_block_ic0_preconditioner",
    "sharded_block_ic0_apply",
]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedBlockJacobiIC0:
    """Each shard's IC(0) triangular solves: ``lower[i]`` (L) and
    ``upper[i]`` (L^T) of the i-th shard this process holds (all P on a
    single-process mesh), ``DeviceTriSolve``s of R rows.
    ``num_levels``, ``width`` and ``max_deps`` are the JAX container's
    common envelope (the most over every shard's two triangles)."""

    num_shards: int
    rows_per_shard: int     # R: matches the stacked vector layout
    num_levels: int         # NL (max over shards)
    width: int              # W
    max_deps: int           # E
    shift_used: float       # the Manteuffel shift that factored every block
    lower: tuple            # P_local DeviceTriSolve
    upper: tuple            # P_local DeviceTriSolve
    mesh: Mesh = None

    @property
    def device(self) -> torch.device:
        return self.lower[0].dep_vals.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lower[0].dep_vals.dtype

    def launches_an_apply(self) -> dict:
        """The ``tri_solve`` launches of one apply: one a chained solve,
        one a level otherwise."""
        return {"tri_solve_core": sum(
            1 if tri_solve_plan(T) == "chained" else T.num_levels
            for T in self.lower + self.upper)}


def _diag_block(m: CsrMatrix, b0: int, b1: int, R: int) -> CsrMatrix:
    """Rows/cols [b0, b1) of ``m`` as a local (R, R) CSR, padded with
    unit-diagonal rows so every shard block has the same shape."""
    rp = np.asarray(m.row_ptr, np.int64)
    cols = np.asarray(m.column_index, np.int64)
    vals = np.asarray(m.value, np.float64)
    lo, hi = int(rp[b0]), int(rp[b1])
    rows = np.repeat(np.arange(b0, b1, dtype=np.int64),
                     np.diff(rp[b0:b1 + 1])) - b0
    c = cols[lo:hi] - b0
    v = vals[lo:hi]
    keep = (c >= 0) & (c < (b1 - b0))
    rows, c, v = rows[keep], c[keep], v[keep]
    # pad rows [b1-b0, R) with unit diagonal (identity pass-through)
    pad = np.arange(b1 - b0, R, dtype=np.int64)
    rows = np.concatenate([rows, pad])
    c = np.concatenate([c, pad])
    v = np.concatenate([v, np.ones(pad.size)])
    # aggregate duplicates (row-aligned CSRs pad with (col 0, 0.0)
    # entries, csr-matrix.cpp:232-236 — they'd otherwise duplicate
    # block 0's first-column pattern entries)
    key = rows * R + c
    uniq, inv = np.unique(key, return_inverse=True)
    v = np.bincount(inv, weights=v)
    rows, c = uniq // R, uniq % R
    rp_l = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=R), out=rp_l[1:])
    return CsrMatrix(
        num_rows=R, num_columns=R, num_entries=int(rp_l[-1]),
        row_alignment=1, row_ptr=rp_l,
        column_index=c.astype(np.int32), value=v,
    )


def block_jacobi_ic0(
    m: CsrMatrix,
    bounds,
    rows_per_shard: int,
    dtype=None,
    shifts=(0.0, 0.01, 0.1),
    mesh: Mesh = None,
) -> ShardedBlockJacobiIC0:
    """Factor every shard's diagonal block IC(0).

    ``bounds`` / ``rows_per_shard`` must come from the sharded operator
    (``ShardedCsrHalo.bounds`` / ``.rows_per_shard``, say) so that the
    apply lines up with the stacked layout.  A block that is not SPD
    enough escalates through ``shifts``; the same shift factors every
    block (a preconditioner is one fixed operator), on every rank of a
    process mesh.  The solves go to ``mesh``'s device, or to
    ``default_device()`` without a mesh; on a process mesh a rank
    factors only its own shards' blocks.
    """
    dtype = dtype or default_value_dtype()
    device = _device(mesh)
    bounds = np.asarray(bounds, dtype=np.int64)
    R = int(rows_per_shard)
    blocks = [_diag_block(m, int(bounds[p]), int(bounds[p + 1]), R)
              for p in mesh_shards(mesh, bounds.size - 1)]
    factors, shift_used, last_err, failed = None, 0.0, None, ()
    for shift in shifts:
        try:
            factors = [ic0_factor(blk, shift=shift) for blk in blocks]
        except MatrixError as e:
            factors, last_err = None, e
        failed = _failed_ranks(factors is None, mesh)
        if not failed:
            shift_used = shift
            break
        factors = None
    if factors is None:
        if mesh is None or mesh.group is None:
            raise MatrixError(
                f"block_jacobi_ic0: no shift in {shifts} factored every "
                f"diagonal block ({last_err})")
        raise MatrixError(
            f"block_jacobi_ic0: no shift in {shifts} factored every "
            f"diagonal block (at shift {shifts[-1]} a block of rank(s) "
            f"{list(failed)} broke down)")
    lower = tuple(DeviceTriSolve.from_host(L, lower=True, dtype=dtype,
                                           device=device) for L in factors)
    upper = tuple(DeviceTriSolve.from_host(_transpose_csr(L), lower=False,
                                           dtype=dtype, device=device)
                  for L in factors)
    both = lower + upper
    levels, width, deps = comm.max_over_ranks(
        (max(t.num_levels for t in both), max(t.width for t in both),
         max(t.max_deps for t in both)), mesh)
    return ShardedBlockJacobiIC0(
        num_shards=bounds.size - 1, rows_per_shard=R, num_levels=levels,
        width=width, max_deps=deps, shift_used=shift_used, lower=lower,
        upper=upper, mesh=mesh)


def _failed_ranks(failed: bool, mesh: Mesh) -> tuple:
    """The ranks whose blocks failed the shift just tried, the same on
    every rank: each sets its own entry of a flag a rank, and the ranks
    take the maximum."""
    if mesh is None or mesh.group is None:
        return (0,) if failed else ()
    flags = [0] * mesh.world_size
    flags[mesh.rank] = int(failed)
    got = comm.max_over_ranks(flags, mesh)
    return tuple(r for r, f in enumerate(got) if f)


def sharded_block_ic0_apply(M: ShardedBlockJacobiIC0,
                            r_stacked: torch.Tensor,
                            mesh: Mesh = None) -> torch.Tensor:
    """z = M^-1 r on stacked (P, R) vectors: a shard, the forward and
    the backward ``tri_solve`` on its own row; no exchange."""
    check_mesh(M, mesh)
    r = r_stacked.to(M.dtype)
    z = torch.empty_like(r)
    w = torch.empty_like(r[0])
    for q in range(len(M.lower)):
        tri_solve_core(M.lower[q], r[q].contiguous(), out=w)
        tri_solve_core(M.upper[q], w, out=z[q])
    return z.to(r_stacked.dtype)


def make_sharded_block_ic0_preconditioner(M: ShardedBlockJacobiIC0,
                                          mesh: Mesh = None):
    """Preconditioner closure for the stacked-layout PCG."""

    def apply(r_stacked):
        return sharded_block_ic0_apply(M, r_stacked, mesh)

    return apply

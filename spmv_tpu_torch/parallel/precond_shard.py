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
from spmv_tpu_torch.parallel.mesh import Mesh, refuse_process_mesh
from spmv_tpu_torch.parallel.shard import _device, check_mesh

__all__ = [
    "ShardedBlockJacobiIC0",
    "block_jacobi_ic0",
    "make_sharded_block_ic0_preconditioner",
    "sharded_block_ic0_apply",
]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedBlockJacobiIC0:
    """Each shard's IC(0) triangular solves: ``lower[p]`` (L) and
    ``upper[p]`` (L^T), ``DeviceTriSolve``s of R rows.  ``num_levels``,
    ``width`` and ``max_deps`` are the JAX container's common envelope
    (the most over every shard's two triangles)."""

    num_shards: int
    rows_per_shard: int     # R: matches the stacked vector layout
    num_levels: int         # NL (max over shards)
    width: int              # W
    max_deps: int           # E
    shift_used: float       # the Manteuffel shift that factored every block
    lower: tuple            # P DeviceTriSolve
    upper: tuple            # P DeviceTriSolve

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
    block (a preconditioner is one fixed operator).  The solves go to
    ``mesh``'s device, or to ``default_device()`` without a mesh.
    """
    refuse_process_mesh(mesh, "block_jacobi_ic0")
    dtype = dtype or default_value_dtype()
    device = _device(mesh)
    bounds = np.asarray(bounds, dtype=np.int64)
    R = int(rows_per_shard)
    blocks = [_diag_block(m, int(bounds[p]), int(bounds[p + 1]), R)
              for p in range(bounds.size - 1)]
    factors, shift_used, last_err = None, 0.0, None
    for shift in shifts:
        try:
            factors = [ic0_factor(blk, shift=shift) for blk in blocks]
            shift_used = shift
            break
        except MatrixError as e:
            last_err = e
    if factors is None:
        raise MatrixError(
            f"block_jacobi_ic0: no shift in {shifts} factored every "
            f"diagonal block ({last_err})")
    lower = tuple(DeviceTriSolve.from_host(L, lower=True, dtype=dtype,
                                           device=device) for L in factors)
    upper = tuple(DeviceTriSolve.from_host(_transpose_csr(L), lower=False,
                                           dtype=dtype, device=device)
                  for L in factors)
    both = lower + upper
    return ShardedBlockJacobiIC0(
        num_shards=len(factors), rows_per_shard=R,
        num_levels=max(t.num_levels for t in both),
        width=max(t.width for t in both),
        max_deps=max(t.max_deps for t in both),
        shift_used=shift_used, lower=lower, upper=upper)


def sharded_block_ic0_apply(M: ShardedBlockJacobiIC0,
                            r_stacked: torch.Tensor,
                            mesh: Mesh = None) -> torch.Tensor:
    """z = M^-1 r on stacked (P, R) vectors: a shard, the forward and
    the backward ``tri_solve`` on its own row; no exchange."""
    check_mesh(M, mesh)
    r = r_stacked.to(M.dtype)
    z = torch.empty_like(r)
    w = torch.empty_like(r[0])
    for q in range(M.num_shards):
        tri_solve_core(M.lower[q], r[q].contiguous(), out=w)
        tri_solve_core(M.upper[q], w, out=z[q])
    return z.to(r_stacked.dtype)


def make_sharded_block_ic0_preconditioner(M: ShardedBlockJacobiIC0,
                                          mesh: Mesh = None):
    """Preconditioner closure for the stacked-layout PCG."""

    def apply(r_stacked):
        return sharded_block_ic0_apply(M, r_stacked, mesh)

    return apply

"""Halo-exchange sharded BSR: block-granular halos for the SpMM format.

The counterpart of ``spmv_tpu/parallel/bsr_shard.py``.  The geometry is
JAX's: block rows split equally in groups that keep each shard's row
count a multiple of 128 (``lcm(block_rows, 128)`` granularity), ``RB``
block rows and ``S = RB * block_rows`` rows a shard, so x and y share
one element partition and each 128-column X tile belongs to one shard.
Blocks (P, S, k) hold X and Y with shard p's rows at ``[p, :]``: the
flat stacked block is X itself, zeros past ``num_rows`` (no overflow
slot).  Needs are tile indices, and ``halo_shard``'s schedule runs on
them unchanged, so a halo unit is a whole X tile (128 rows of k
columns) and ``comm_blocks_exact`` counts tiles.

The local product is K7 (``ops.bsr_kernels.bsr_spmm_core``: the tensor
cores for bfloat16 blocks of 64 or 128 rows at k % 8 == 0, the SIMT
kernel otherwise).  K7 takes no ``accumulate``, so each shard's blocks
form one ``DeviceBsr`` whose block columns index an **extended** X,
``[own tiles (S / 128) | received halo tiles]``: interior blocks keep
their own tile, boundary blocks point past it at their halo slot.  The
exchange is one ``index_select`` of X's tiles by a host-built table
that lists each shard's own tiles and then its halo slots (-1 where no
shard sends, which receives 0), and a product is one K7 launch a shard
on its row of that extended X.  Adding a second boundary launch's Y to
the first would write, read and add a (S, k) Y again a shard; the one
launch pays a copy of the shard's own X tiles instead, and keeps each
block row's blocks in the host matrix's order.  The JAX package sums
the interior and the boundary as two segment sums and adds them, so
the two agree within rounding.

On a process mesh a rank builds only its own shards' ``DeviceBsr``s and
holds its own rows of X.  Its extended X is the same table's rows for
its shards: the tiles it holds itself are one local gather, those of
other ranks arrive by the plan ``comm.exchange_plan`` makes over tile
positions (``halo_shard.receive_halos``: ``comm.exchange_strips`` or
``comm.all_to_all_strips`` with a trailing (128, k)), so each K7 launch
reads the extended X it reads on one device and each rank's rows of Y
are bitwise the single-process product's.

Storage is unpadded (JAX pads every shard to a common count of interior
and boundary blocks; ``interior_per_shard`` / ``boundary_per_shard``
keep those numbers).  bfloat16 blocks give float32 Y, K7's contract,
where JAX returns bfloat16.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.models.bsr import BLOCK, BsrMatrix
from spmv_tpu_torch.models.device import (
    DeviceBsr,
    default_value_dtype,
    round_up,
)
from spmv_tpu_torch.ops.bsr_kernels import bsr_spmm_core
from spmv_tpu_torch.ops.spmv import accumulate_dtype
from spmv_tpu_torch.parallel.comm import ExchangePlan, all_gather_rows
from spmv_tpu_torch.parallel.halo_shard import (
    SLOT_PAD,
    build_exchange_schedule,
    receive_halos,
    receive_index,
    receiving_side,
)
from spmv_tpu_torch.parallel.mesh import Mesh
from spmv_tpu_torch.parallel.shard import (
    _device,
    check_mesh,
    local_shards,
    mesh_shards,
)

__all__ = [
    "ShardedBsrHalo",
    "shard_bsr_halo",
    "sharded_bsr_spmm",
    "sharded_bsr_spmv",
    "make_sharded_bsr_matvec",
    "stack_columns",
    "unstack_rows",
    "extend_columns",
]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedBsrHalo:
    """BSR split into P block-row bands with a static tile-halo plan.

    ``blocks[i]`` is the ``DeviceBsr`` of the i-th shard this process
    holds (all P on a single-process mesh): S rows, ``(CB + slots) *
    128`` columns of its extended X.  ``ext_index`` (P_local, CB +
    slots) is the tile of the process's flat (P_local * CB, 128, k) X
    each extended tile takes (0 for a tile another rank sends, which
    ``plan`` fills), ``ext_missing`` where no shard sends (or None).
    """

    num_rows: int
    num_columns: int
    num_entries: int
    num_shards: int
    block_rows: int            # bh: block height
    block_rows_per_shard: int  # RB
    rows_per_shard: int        # S = RB * bh (multiple of 128)
    col_blocks_per_shard: int  # CB = S // 128
    interior_per_shard: int    # JAX's envelope
    boundary_per_shard: int    # JAX's envelope
    halo_slots: int            # H, in tiles
    exchange: str
    max_distance: int
    comm_blocks_exact: int
    comm_elements_exact: int   # tiles * 128
    comm_elements_padded: int
    send_idx: np.ndarray       # (P, strips, H) int32, tile units
    ext_index: torch.Tensor
    ext_missing: torch.Tensor
    blocks: tuple              # P_local DeviceBsr
    mesh: Mesh = None
    plan: ExchangePlan = None

    @property
    def bounds(self):
        S = self.rows_per_shard
        return tuple(q * S for q in range(self.num_shards + 1))

    @property
    def device(self) -> torch.device:
        return self.ext_index.device

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].blocks.dtype

    def launches_a_product(self) -> dict:
        """The kernel launches of one product, by wrapper name."""
        return {"bsr_spmm_core": len(self.blocks)}


def shard_bsr_halo(
    m: BsrMatrix,
    num_shards: int,
    dtype=None,
    mesh: Mesh = None,
    exchange: str = "auto",
    neighbor_max_distance: int = 3,
) -> ShardedBsrHalo:
    """Build the tile-halo sharding of a square host BSR matrix
    (``exchange`` as ``shard_csr_halo``'s).  The blocks go to ``mesh``'s
    device, or to ``default_device()`` without a mesh; on a process mesh
    a rank builds only its own shards'."""
    if m.num_rows != m.num_columns:
        raise MatrixError(
            "halo-sharded BSR requires a square matrix (x and y share "
            "the row partition)")
    dtype = dtype or default_value_dtype()
    device = _device(mesh)
    p = int(num_shards)
    shards = mesh_shards(mesh, p)
    bh = int(m.block_rows)
    nbr = int(m.num_block_rows)
    g = math.lcm(bh, BLOCK) // bh
    RB = round_up(max(-(-nbr // p), 1), g)
    S = RB * bh
    CB = S // BLOCK

    rowptr = np.asarray(m.block_rowptr, np.int64)
    brow_all = np.repeat(np.arange(nbr, dtype=np.int64), np.diff(rowptr))
    bcol_all = np.asarray(m.block_col, dtype=np.int64)
    owner = bcol_all // CB
    spans, needs = [], []
    for q in range(p):
        lo = int(rowptr[min(q * RB, nbr)])
        hi = int(rowptr[min((q + 1) * RB, nbr)])
        local = owner[lo:hi] == q
        spans.append((lo, hi, local))
        needs.append(np.unique(bcol_all[lo:hi][~local]))
    sched = build_exchange_schedule(
        needs, np.arange(p + 1, dtype=np.int64) * CB, exchange=exchange,
        neighbor_max_distance=neighbor_max_distance)
    slots = sched.num_strips * sched.halo_slots
    width = (CB + slots) * BLOCK

    blocks = []
    for q in shards:
        lo, hi, local = spans[q]
        col = bcol_all[lo:hi] - q * CB
        if not local.all():
            col[~local] = CB + sched.remap(q, bcol_all[lo:hi][~local])
        host = np.asarray(m.blocks[lo:hi])
        blocks.append(DeviceBsr(
            S, width, int(np.count_nonzero(host)), RB, 1,
            torch.from_numpy(host).to(device=device, dtype=dtype),
            col, brow_all[lo:hi] - q * RB, device=device))

    halo = receive_index(sched.send_idx, CB, sched.exchange,
                         sched.max_distance)
    own = np.arange(p * CB, dtype=np.int64).reshape(p, CB)
    ext_index, ext_missing, plan = receiving_side(
        np.concatenate([own, halo], axis=1), CB, mesh, device)
    NI = max(round_up(max(int(s[2].sum()) for s in spans), SLOT_PAD),
             SLOT_PAD)
    NB = max(round_up(max(int((~s[2]).sum()) for s in spans), SLOT_PAD),
             SLOT_PAD)
    return ShardedBsrHalo(
        num_rows=m.num_rows,
        num_columns=m.num_columns,
        num_entries=m.num_entries,
        num_shards=p,
        block_rows=bh,
        block_rows_per_shard=RB,
        rows_per_shard=S,
        col_blocks_per_shard=CB,
        interior_per_shard=NI,
        boundary_per_shard=NB,
        halo_slots=sched.halo_slots,
        exchange=sched.exchange,
        max_distance=sched.max_distance,
        comm_blocks_exact=sched.comm_elements_exact,
        comm_elements_exact=sched.comm_elements_exact * BLOCK,
        comm_elements_padded=sched.comm_elements_padded * BLOCK,
        send_idx=sched.send_idx,
        ext_index=ext_index,
        ext_missing=ext_missing,
        blocks=tuple(blocks),
        mesh=mesh,
        plan=plan,
    )


def stack_columns(X, A: ShardedBsrHalo, mesh: Mesh = None) -> torch.Tensor:
    """(num_columns, k) or (num_columns,), numpy or torch -> stacked
    (P, S, k) on the shards' device, in the blocks' dtype: the rows of
    the shards this process holds."""
    check_mesh(A, mesh)
    X = torch.as_tensor(X)
    if X.dim() == 1:
        X = X[:, None]
    shards, S = local_shards(A), A.rows_per_shard
    lo = shards.start * S
    out = torch.zeros(len(shards) * S, X.shape[1], dtype=A.dtype,
                      device=A.device)
    n = max(min(A.num_columns - lo, out.shape[0]), 0)
    out[:n] = X[lo: lo + n].to(device=A.device, dtype=A.dtype)
    return out.reshape(len(shards), S, X.shape[1])


def unstack_rows(stacked, A: ShardedBsrHalo) -> np.ndarray:
    """Stacked (P, S, k) -> host (num_rows, k), on every rank of a
    process mesh."""
    return all_gather_rows(torch.as_tensor(stacked), A.mesh)[
        : A.num_rows].cpu().numpy()


def extend_columns(A: ShardedBsrHalo, X_stacked: torch.Tensor
                   ) -> torch.Tensor:
    """The exchange: every local shard's extended X, (P_local, (CB +
    slots) * 128, k), its own tiles and then its received halo tiles."""
    P, S, k = X_stacked.shape
    tiles = X_stacked.reshape(1, P * A.col_blocks_per_shard, BLOCK, k)
    ext = receive_halos(tiles, A.ext_index.reshape(1, -1),
                        None if A.ext_missing is None
                        else A.ext_missing.reshape(1, -1), A.plan,
                        A.exchange, A.mesh)
    return ext.reshape(P, -1, k)


def sharded_bsr_spmm(A: ShardedBsrHalo, X_stacked: torch.Tensor,
                     mesh: Mesh = None) -> torch.Tensor:
    """Y = A @ X; stacked (P, S, k) operands, X in the blocks' dtype, Y in
    K7's accumulator type.  One exchange, then one K7 launch a shard on
    its extended X."""
    check_mesh(A, mesh)
    ext = extend_columns(A, X_stacked)
    Y = torch.empty(X_stacked.shape, dtype=accumulate_dtype(A.dtype),
                    device=X_stacked.device)
    for q, block in enumerate(A.blocks):
        bsr_spmm_core(block, ext[q], out=Y[q])
    return Y


def sharded_bsr_spmv(A: ShardedBsrHalo, x_stacked: torch.Tensor,
                     mesh: Mesh = None) -> torch.Tensor:
    """y = A @ x; x stacked as (P, S) or (P, S, 1)."""
    if x_stacked.dim() == 2:
        return sharded_bsr_spmm(A, x_stacked[..., None], mesh)[..., 0]
    return sharded_bsr_spmm(A, x_stacked, mesh)


def make_sharded_bsr_matvec(A: ShardedBsrHalo, mesh: Mesh = None):
    """Stacked-layout matvec closure for iterative solvers (CG)."""

    def matvec(x_stacked):
        return sharded_bsr_spmv(A, x_stacked, mesh)

    matvec.mesh = A.mesh
    return matvec

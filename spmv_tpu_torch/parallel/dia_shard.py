"""Row-block sharded DIA SpMV and SpMM with nearest-neighbour halos.

The counterpart of ``spmv_tpu/parallel/dia_shard.py``.  A banded matrix
only reads x within ``h = max|offset|`` of its own rows, so shard p
needs two halo strips of its neighbours' x besides its own block:

    shard p:  [left halo from p-1 | own x block | right halo from p+1]

The geometry is JAX's: ``Rb = round_up(ceil(n / P), 128)`` rows a shard,
vectors in the stacked layout ``(P, Rb)`` (zeros past ``num_rows``), and
a matrix whose halo exceeds ``Rb`` is refused.

On a mesh of shards on one device the halo-extended x of shard p is a
window of the flat stacked x, ``[p Rb - h, (p + 1) Rb + h)``, cut at its
ends for the outer shards: JAX's ``ppermute`` of the halo strips is a
view, with no copy.  On a process mesh a rank holds its own shards'
rows (P_local, Rb) and receives h elements from each neighbour rank
(``comm.exchange_strips``, JAX's two ``ppermute``s; none past either end
of the matrix), so that its local x extended by them is the flat stacked
x's rows ``[lo Rb - h, hi Rb + h)`` for its shards lo..hi-1, cut at the
ends: every window holds the values it holds on one device, and each
rank's rows are bitwise the single-process product's.  Each shard's
product is one launch of K1
(``ops.dia_kernels.dia_spmv_core``) on that window, through a
``DeviceDia`` of Rb rows whose data is a view of the shard's slice of
``data`` (P, D, Rb) and whose offsets are shifted by the window's left
halo width.  The outer shards read no halo beyond the matrix: their
windows stop at its ends, and K1 reads no column outside [0, window),
where JAX's ``ppermute`` delivers exact zeros.  JAX runs an interior
pass on zero halos and then boundary corrections; one K1 launch sums a
boundary row in one pass, so the two agree within rounding, not in
bits.

The SpMM (K2, ``dia_spmm_core``) keeps JAX's stacked block layout
``(P, k, Rb)``, with the column on axis 1, which batched CG reduces and
broadcasts along.  K2 takes X row-major as (columns, k), so a product
transposes the whole stacked block once into (P Rb, k) (one copy), runs
one K2 launch a shard on its window of rows, and transposes the
(P, Rb, k) result back (a second copy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.models.device import (
    LANE,
    DeviceDia,
    default_device,
    default_value_dtype,
    round_up,
)
from spmv_tpu_torch.models.dia import DiaMatrix
from spmv_tpu_torch.ops.dia_kernels import dia_spmm_core, dia_spmv_core
from spmv_tpu_torch.parallel.comm import (
    ExchangePlan,
    all_gather_rows,
    exchange_plan,
    exchange_strips,
)
from spmv_tpu_torch.parallel.distributed import local_rows
from spmv_tpu_torch.parallel.mesh import Mesh
from spmv_tpu_torch.parallel.shard import check_mesh, local_shards

__all__ = [
    "ShardedDia",
    "shard_dia",
    "sharded_dia_spmv",
    "sharded_dia_spmm",
    "make_sharded_dia_matvec",
    "make_sharded_dia_matmat",
    "stack_dia_vector",
    "unstack_dia_vector",
    "stack_dia_matrix",
    "unstack_dia_matrix",
]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedDia:
    """A square DIA matrix in P row blocks of ``rows_per_shard`` rows.

    ``data`` (P_local, D, Rb) holds the diagonals of the i-th shard this
    process holds at ``data[i]`` (all P on a single-process mesh);
    ``blocks[i]`` is the ``DeviceDia`` K1 and K2 run on for it (its data
    a view of ``data[i]``), and ``windows[i] = (start, stop)`` the rows
    of the extended local x it reads: the flat stacked x itself on one
    process, the received left strip (``left`` rows), the local rows
    and the right strip on a process mesh, where ``exchange`` is the
    strips' plan (None where nothing moves).
    """

    num_rows: int
    num_columns: int
    num_entries: int
    offsets: tuple
    num_shards: int          # P
    rows_per_shard: int      # Rb (a multiple of LANE)
    halo: int                # h = max |offset|, <= Rb
    data: torch.Tensor       # (P_local, D, Rb)
    blocks: tuple            # P_local DeviceDia
    windows: tuple           # P_local (start, stop) into the extended x
    mesh: Mesh = None
    exchange: ExchangePlan = None
    left: int = 0            # rows of the left strip in the extended x

    @property
    def stacked_size(self) -> int:
        return self.num_shards * self.rows_per_shard

    @property
    def device(self) -> torch.device:
        return self.data.device


def shard_dia(A: DiaMatrix, num_shards: int, dtype=None,
              mesh: Mesh = None) -> ShardedDia:
    """Split a square DIA matrix into P contiguous row blocks (equal
    rows are balanced nonzeros in DIA).  The blocks go to ``mesh``'s
    device, or to ``default_device()`` without a mesh; on a process mesh
    a rank keeps its own shards' blocks (``local_rows``)."""
    if A.num_rows != A.num_columns:
        raise MatrixError(
            "sharded DIA requires a square matrix (x and y share the "
            "row partition)"
        )
    dtype = dtype or default_value_dtype()
    device = mesh.device if mesh is not None else default_device()
    p = int(num_shards)
    offsets = tuple(int(o) for o in A.offsets)
    halo = max((abs(o) for o in offsets), default=0)
    rb = round_up(-(-A.num_rows // p), LANE)
    if halo > rb:
        raise MatrixError(
            f"halo {halo} exceeds rows per shard {rb}; use fewer "
            "shards or reorder to reduce bandwidth"
        )
    data = np.zeros((p, len(offsets), rb), dtype=np.float64)
    for q in range(p):
        r0 = q * rb
        r1 = min(r0 + rb, A.num_rows)
        if r1 > r0:
            data[q, :, : r1 - r0] = A.data[:, r0:r1]
    if mesh is not None and mesh.size != p:
        raise ValueError(f"{p} shards on a mesh of {mesh.size}")
    data = (local_rows(data, mesh) if mesh is not None
            else torch.from_numpy(data).to(device)).to(dtype)

    def extended(shards):
        """The rows of the flat stacked x that ``shards``' windows span."""
        return (max(shards.start * rb - halo, 0),
                min(shards.stop * rb + halo, p * rb))

    shards = mesh.local_shards if mesh is not None else range(p)
    first = extended(shards)[0]
    blocks, windows = [], []
    for i, q in enumerate(shards):
        start = max(q * rb - halo, 0)
        stop = min((q + 1) * rb + halo, p * rb)
        shift = q * rb - start
        blocks.append(DeviceDia(rb, stop - start, 0,
                                tuple(o + shift for o in offsets), data[i]))
        windows.append((start - first, stop - first))
    plan = None
    if mesh is not None and mesh.world_size > 1 and halo > 0:
        per_rank = mesh.shards_per_rank
        tables = []
        for r in range(mesh.world_size):
            lo, hi = extended(range(r * per_rank, (r + 1) * per_rank))
            tables.append(np.r_[lo:r * per_rank * rb,
                                (r + 1) * per_rank * rb:hi])
        _, _, plan = exchange_plan(tables, per_rank * rb, mesh)
    return ShardedDia(
        num_rows=A.num_rows,
        num_columns=A.num_columns,
        num_entries=A.num_entries,
        offsets=offsets,
        num_shards=p,
        rows_per_shard=rb,
        halo=halo,
        data=data,
        blocks=tuple(blocks),
        windows=tuple(windows),
        mesh=mesh,
        exchange=plan,
        left=shards.start * rb - first,
    )


def _stack_rows(X, A: ShardedDia) -> torch.Tensor:
    """Rows (num_rows, ...) -> the local shards' flat rows (P_local Rb,
    ...), zeros past ``num_rows``, on the shards' device and dtype."""
    X = torch.as_tensor(X).to(device=A.device, dtype=A.data.dtype)
    shards = local_shards(A)
    lo = shards.start * A.rows_per_shard
    out = torch.zeros((len(shards) * A.rows_per_shard,) + tuple(X.shape[1:]),
                      dtype=X.dtype, device=X.device)
    seg = X[lo: lo + out.shape[0]]
    out[: seg.shape[0]] = seg
    return out


def stack_dia_vector(x, A: ShardedDia) -> torch.Tensor:
    """Vector (num_rows,), numpy or torch -> stacked (P, Rb) layout on
    the shards' device, in their value dtype: the rows of the shards this
    process holds."""
    return _stack_rows(x, A).reshape(-1, A.rows_per_shard)


def unstack_dia_vector(stacked, A: ShardedDia) -> np.ndarray:
    """Stacked (P, Rb) -> host vector (num_rows,), on every rank of a
    process mesh."""
    return all_gather_rows(torch.as_tensor(stacked), A.mesh)[
        : A.num_rows].cpu().numpy()


def stack_dia_matrix(X, A: ShardedDia) -> torch.Tensor:
    """(num_rows, k) block -> stacked (P, k, Rb) layout."""
    out = _stack_rows(X, A)
    return out.reshape(-1, A.rows_per_shard, out.shape[1]).transpose(
        1, 2).contiguous()


def unstack_dia_matrix(stacked, A: ShardedDia) -> np.ndarray:
    s = torch.as_tensor(stacked).transpose(1, 2)      # (P, Rb, k)
    return all_gather_rows(s, A.mesh)[: A.num_rows].cpu().numpy()


def _extended(A: ShardedDia, x: torch.Tensor) -> torch.Tensor:
    """The local flat x (P_local Rb, ...) extended by the neighbour
    ranks' strips; x itself where nothing moves."""
    if A.exchange is None:
        return x
    recv = x.new_empty((A.exchange.slots,) + tuple(x.shape[1:]))
    exchange_strips(x, recv, A.exchange, A.mesh)
    return torch.cat([recv[: A.left], x, recv[A.left:]])


def sharded_dia_spmv(A: ShardedDia, x_stacked: torch.Tensor,
                     mesh: Mesh = None) -> torch.Tensor:
    """y = A @ x in the stacked (P, Rb) layout: one K1 launch a shard on
    its window of the (extended) flat stacked x."""
    check_mesh(A, mesh)
    x = _extended(A, x_stacked.reshape(-1))
    y = torch.empty_like(x_stacked)
    for q, (start, stop) in enumerate(A.windows):
        dia_spmv_core(A.blocks[q], x[start:stop], out=y[q])
    return y


def sharded_dia_spmm(A: ShardedDia, x_stacked: torch.Tensor,
                     mesh: Mesh = None) -> torch.Tensor:
    """Y = A @ X in the stacked (P, k, Rb) layout: the block transposed
    into K2's (P Rb, k), one K2 launch a shard on its window of rows,
    the result transposed back."""
    check_mesh(A, mesh)
    k = x_stacked.shape[1]
    X = _extended(A, x_stacked.transpose(1, 2).reshape(-1, k).contiguous())
    Y = torch.empty((len(A.blocks), A.rows_per_shard, k),
                    dtype=X.dtype, device=X.device)
    for q, (start, stop) in enumerate(A.windows):
        dia_spmm_core(A.blocks[q], X[start:stop], out=Y[q])
    return Y.transpose(1, 2).contiguous()


def make_sharded_dia_matvec(A: ShardedDia, mesh: Mesh = None):
    """Stacked-layout matvec closure for iterative solvers (CG)."""

    def matvec(x_stacked):
        return sharded_dia_spmv(A, x_stacked, mesh)

    matvec.mesh = A.mesh
    return matvec


def make_sharded_dia_matmat(A: ShardedDia, mesh: Mesh = None):
    """Stacked-layout multi-RHS closure for ``batched_conjugate_gradient``
    (the columns on axis 1 of (P, k, Rb), along which its column
    reductions and per-column scalars run)."""

    def matmat(x_stacked):
        return sharded_dia_spmm(A, x_stacked, mesh)

    matmat.mesh = A.mesh
    return matmat

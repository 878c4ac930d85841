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
view, with no copy.  Each shard's product is one launch of K1
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
from spmv_tpu_torch.parallel.mesh import Mesh
from spmv_tpu_torch.parallel.shard import check_mesh

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

    ``data`` (P, D, Rb) holds shard p's diagonals at ``data[p]``;
    ``blocks[p]`` is the ``DeviceDia`` K1 and K2 run on for shard p (its
    data a view of ``data[p]``), and ``windows[p] = (start, stop)`` the
    rows of the flat stacked x it reads.
    """

    num_rows: int
    num_columns: int
    num_entries: int
    offsets: tuple
    num_shards: int          # P
    rows_per_shard: int      # Rb (a multiple of LANE)
    halo: int                # h = max |offset|, <= Rb
    data: torch.Tensor       # (P, D, Rb)
    blocks: tuple            # P DeviceDia
    windows: tuple           # P (start, stop) into the flat stacked x

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
    device, or to ``default_device()`` without a mesh."""
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
    data = torch.from_numpy(data).to(device=device, dtype=dtype)
    blocks, windows = [], []
    for q in range(p):
        start = max(q * rb - halo, 0)
        stop = min((q + 1) * rb + halo, p * rb)
        shift = q * rb - start
        blocks.append(DeviceDia(rb, stop - start, 0,
                                tuple(o + shift for o in offsets), data[q]))
        windows.append((start, stop))
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
    )


def stack_dia_vector(x, A: ShardedDia) -> torch.Tensor:
    """Vector (num_rows,), numpy or torch -> stacked (P, Rb) layout on
    the shards' device, in their value dtype."""
    x = torch.as_tensor(x).to(device=A.device, dtype=A.data.dtype)
    out = torch.zeros(A.stacked_size, dtype=x.dtype, device=x.device)
    out[: x.shape[0]] = x
    return out.reshape(A.num_shards, A.rows_per_shard)


def unstack_dia_vector(stacked, A: ShardedDia) -> np.ndarray:
    return torch.as_tensor(stacked).reshape(-1)[: A.num_rows].cpu().numpy()


def stack_dia_matrix(X, A: ShardedDia) -> torch.Tensor:
    """(num_rows, k) block -> stacked (P, k, Rb) layout."""
    X = torch.as_tensor(X).to(device=A.device, dtype=A.data.dtype)
    out = torch.zeros((A.stacked_size, X.shape[1]), dtype=X.dtype,
                      device=X.device)
    out[: X.shape[0]] = X
    return out.reshape(A.num_shards, A.rows_per_shard, -1).transpose(
        1, 2).contiguous()


def unstack_dia_matrix(stacked, A: ShardedDia) -> np.ndarray:
    s = torch.as_tensor(stacked)                  # (P, k, Rb)
    return s.transpose(1, 2).reshape(-1, s.shape[1])[: A.num_rows] \
        .cpu().numpy()


def sharded_dia_spmv(A: ShardedDia, x_stacked: torch.Tensor,
                     mesh: Mesh = None) -> torch.Tensor:
    """y = A @ x in the stacked (P, Rb) layout: one K1 launch a shard on
    its window of the flat stacked x."""
    check_mesh(A, mesh)
    x = x_stacked.reshape(-1)
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
    X = x_stacked.transpose(1, 2).reshape(A.stacked_size, k).contiguous()
    Y = torch.empty((A.num_shards, A.rows_per_shard, k),
                    dtype=X.dtype, device=X.device)
    for q, (start, stop) in enumerate(A.windows):
        dia_spmm_core(A.blocks[q], X[start:stop], out=Y[q])
    return Y.transpose(1, 2).contiguous()


def make_sharded_dia_matvec(A: ShardedDia, mesh: Mesh = None):
    """Stacked-layout matvec closure for iterative solvers (CG)."""

    def matvec(x_stacked):
        return sharded_dia_spmv(A, x_stacked, mesh)

    return matvec


def make_sharded_dia_matmat(A: ShardedDia, mesh: Mesh = None):
    """Stacked-layout multi-RHS closure for ``batched_conjugate_gradient``
    (the columns on axis 1 of (P, k, Rb), along which its column
    reductions and per-column scalars run)."""

    def matmat(x_stacked):
        return sharded_dia_spmm(A, x_stacked, mesh)

    return matmat

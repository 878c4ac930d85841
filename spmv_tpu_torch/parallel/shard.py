"""Row-block sharded CSR SpMV, x all-gathered.

The counterpart of ``spmv_tpu/parallel/shard.py``.

Layout
------
Rows are split into P contiguous blocks (nnz-balanced by default;
``models.partition``) exactly as in the JAX package, and vectors live in
its **stacked layout** ``(P, R)``: shard p's rows at ``[p, 0:rows_p]``,
zeros elsewhere, with ``R = round_up(max block rows + 1, 8)`` so that
slot ``R - 1`` is a sacrificial overflow row of no shard (it owns no
entry, so every product leaves it 0).  Column indices are remapped at
build time into the stacked index space (global slot ``q*R + (j -
bounds[q])`` for a column j owned by shard q), so the stacked x is
indexed directly.

Each shard's block is one ``DeviceCsr`` of R rows and P*R columns,
unpadded: the JAX package pads every shard's entries to a multiple of
1024 for its segment sum, a TPU layout the CSR kernel does not need.

Compute
-------
``sharded_spmv`` hands every shard's launch of the CSR SpMV
(``ops.csr_kernels.csr_spmv_core``, the hand-written kernel on a CUDA
tensor, its plain version on the CPU) the flat stacked x, JAX's
``all_gather`` of x (``comm.all_gather_rows``), and each launch writes
its row of the stacked y.  One launch a shard.  On a mesh of shards on
one device the gathered x is the stacked x itself, with no copy; on a
process mesh (``distributed.global_mesh``) a rank holds its own shards'
blocks and rows, and the gather is a real ``all_gather``: every launch
reads the same x values as on one device, so each rank's rows of y are
bitwise those of the single-process product.  CG iterates in the
stacked space (``ops.solvers`` reduces over every axis, and over the
ranks given ``mesh=``).

The stacking helpers work on either mesh: ``stack_vector`` returns the
rows of the shards this process holds, ``unstack_vector`` the whole
vector on every rank (a collective on a process mesh).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.models.csr import CsrMatrix
from spmv_tpu_torch.models.device import (
    DeviceCsr,
    default_device,
    default_value_dtype,
    round_up,
)
from spmv_tpu_torch.models.partition import (
    rows_partition_balanced_nnz,
    rows_partition_equal,
)
from spmv_tpu_torch.ops.csr_kernels import csr_spmv_core
from spmv_tpu_torch.parallel.comm import all_gather_rows
from spmv_tpu_torch.parallel.mesh import Mesh

__all__ = [
    "ShardedCsr",
    "shard_csr",
    "stack_vector",
    "unstack_vector",
    "sharded_spmv",
    "make_sharded_matvec",
]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedCsr:
    """CSR split into P row blocks.

    ``blocks[i]`` is the ``DeviceCsr`` of the i-th shard this process
    holds (all P on a single-process mesh): R local rows (those past the
    shard's own hold no entry), P*R columns in the stacked x index
    space.  ``bounds`` (host tuple) are the global row offsets, ``mesh``
    the mesh it was built on (None: ``default_device()``).
    """

    num_rows: int
    num_columns: int
    num_entries: int
    num_shards: int
    rows_per_shard: int      # R
    bounds: tuple            # (P+1,) python ints
    blocks: tuple            # the local shards' DeviceCsr
    mesh: Mesh = None

    @property
    def stacked_size(self) -> int:
        return self.num_shards * self.rows_per_shard

    @property
    def device(self) -> torch.device:
        return self.blocks[0].value.device

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].value.dtype


def partition_rows(m: CsrMatrix, num_shards: int, partition: str):
    """The row bounds of ``partition`` ("nnz" or "rows") over
    ``num_shards``, for a square matrix (the stacked layout shares x's
    partition with y's)."""
    if m.num_columns != m.num_rows:
        raise MatrixError(
            "sharded CSR supports square matrices only (x and y share the "
            "row partition); run rectangular matrices unsharded (ops.spmv)")
    if partition == "nnz":
        return rows_partition_balanced_nnz(m.row_ptr, num_shards)
    if partition == "rows":
        return rows_partition_equal(m.num_rows, num_shards)
    raise ValueError(f"unknown partition strategy {partition!r}")


def rows_per_shard(bounds) -> int:
    """R: the largest block plus the overflow slot, rounded up to 8."""
    return round_up(int(np.diff(bounds).max(initial=0)) + 1, 8)


def local_csr(row_ptr, cols, vals, num_rows: int, num_columns: int,
              dtype, device) -> DeviceCsr:
    """A shard's ``DeviceCsr`` of ``num_rows`` rows from its own rows'
    ``row_ptr`` (starting anywhere; rows past its end own no entry) and
    their (already remapped) columns and values."""
    ptr = np.full(num_rows + 1, row_ptr[-1], dtype=np.int64)
    ptr[: row_ptr.size] = row_ptr
    ptr -= row_ptr[0]
    t = torch.from_numpy
    return DeviceCsr(
        num_rows, num_columns, int(ptr[-1]),
        t(ptr.astype(np.int32)).to(device),
        t(np.ascontiguousarray(cols, dtype=np.int32)).to(device),
        t(np.ascontiguousarray(vals, dtype=np.float64)).to(device, dtype))


def _device(mesh: Mesh):
    return mesh.device if mesh is not None else default_device()


def mesh_shards(mesh: Mesh, num_shards: int) -> range:
    """The shards of ``num_shards`` a container built on ``mesh`` holds:
    its rank's on a process mesh, every one without a mesh or on one
    process."""
    if mesh is None:
        return range(num_shards)
    if mesh.size != num_shards:
        raise ValueError(f"{num_shards} shards on a mesh of {mesh.size}")
    return mesh.local_shards


def local_shards(sharded) -> range:
    """The shards of ``sharded`` this process holds."""
    mesh = getattr(sharded, "mesh", None)
    return (mesh.local_shards if mesh is not None
            else range(sharded.num_shards))


def check_mesh(sharded, mesh: Mesh) -> None:
    """Raise unless ``mesh`` (where given) is the one ``sharded`` was
    built on: one entry a shard, on the shards' device, in the same
    process group."""
    if mesh is None:
        return
    held = sharded.mesh
    if (mesh.size != sharded.num_shards or mesh.device != sharded.device
            or (held.group if held is not None else None) is not mesh.group):
        raise ValueError(
            f"a mesh of {mesh.size} shards on {mesh.device} does not hold "
            f"this matrix's {sharded.num_shards} shards on "
            f"{sharded.device}")


def shard_csr(
    m: CsrMatrix,
    num_shards: int,
    dtype=None,
    partition: str = "nnz",
    mesh: Mesh = None,
) -> ShardedCsr:
    """Build a ``ShardedCsr`` from a square host CSR matrix.

    ``partition``: "nnz" (balanced nonzeros, default) or "rows" (the
    reference's equal-rows split).  The blocks go to ``mesh``'s device,
    or to ``default_device()`` without a mesh; on a process mesh a rank
    builds only its own shards' blocks.
    """
    dtype = dtype or default_value_dtype()
    device = _device(mesh)
    shards = mesh_shards(mesh, num_shards)
    bounds = partition_rows(m, num_shards, partition)
    R = rows_per_shard(bounds)
    row_ptr = np.asarray(m.row_ptr, dtype=np.int64)
    cols = np.asarray(m.column_index[: row_ptr[-1]], dtype=np.int64)
    # Stacked-space remap of column indices.
    owner = np.searchsorted(bounds, cols, side="right") - 1
    stacked_cols = owner * R + (cols - bounds[owner])
    blocks = tuple(
        local_csr(row_ptr[bounds[p]: bounds[p + 1] + 1],
                  stacked_cols[row_ptr[bounds[p]]: row_ptr[bounds[p + 1]]],
                  m.value[row_ptr[bounds[p]]: row_ptr[bounds[p + 1]]],
                  R, num_shards * R, dtype, device)
        for p in shards)
    return ShardedCsr(
        num_rows=m.num_rows,
        num_columns=m.num_columns,
        num_entries=m.num_entries,
        num_shards=num_shards,
        rows_per_shard=R,
        bounds=tuple(int(b) for b in bounds),
        blocks=blocks,
        mesh=mesh,
    )


def _stack(v, sharded) -> torch.Tensor:
    """Rows of v split at the shards' bounds into a zeroed (P_local,
    R, ...) for the shards this process holds."""
    bounds = sharded.bounds
    v = torch.as_tensor(v).to(device=sharded.device, dtype=sharded.dtype)
    shards = local_shards(sharded)
    out = torch.zeros((len(shards), sharded.rows_per_shard)
                      + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    for i, p in enumerate(shards):
        out[i, : bounds[p + 1] - bounds[p]] = v[bounds[p]: bounds[p + 1]]
    return out


def _unstack(stacked, sharded) -> np.ndarray:
    """The whole host vector (or block) from the stacked rows: on a
    process mesh every rank's rows, gathered on every rank."""
    bounds = sharded.bounds
    s = torch.as_tensor(stacked)
    s = all_gather_rows(s, getattr(sharded, "mesh", None)).reshape(
        (sharded.num_shards,) + tuple(s.shape[1:]))
    return torch.cat([s[p, : bounds[p + 1] - bounds[p]]
                      for p in range(len(bounds) - 1)]).cpu().numpy()


def stack_vector(v, sharded, mesh: Mesh = None) -> torch.Tensor:
    """Vector (num_rows,), numpy or torch -> stacked (P, R) layout on the
    shards' device, in their value dtype: the rows of the shards this
    process holds.  ``mesh`` (optional) must be the shards' mesh."""
    check_mesh(sharded, mesh)
    return _stack(v, sharded)


def unstack_vector(stacked, sharded) -> np.ndarray:
    """Stacked (P, R) layout -> host vector (num_rows,), on every rank of
    a process mesh."""
    return _unstack(stacked, sharded)


def sharded_spmv(A: ShardedCsr, x_stacked: torch.Tensor,
                 mesh: Mesh = None) -> torch.Tensor:
    """y = A @ x; both vectors in stacked (P, R) layout (the local shards'
    rows on a process mesh).  One CSR SpMV launch a shard, each on the
    flat stacked x (the all-gather).  ``mesh`` (optional) must be the
    shards' mesh."""
    check_mesh(A, mesh)
    x = all_gather_rows(x_stacked, A.mesh)
    y = torch.empty_like(x_stacked)
    for p, block in enumerate(A.blocks):
        csr_spmv_core(block, x, out=y[p])
    return y


def make_sharded_matvec(A: ShardedCsr, mesh: Mesh = None):
    """y = A @ x in stacked layout, as a closure (for solvers); its
    ``mesh`` attribute is the shards' mesh, which a solver over a
    process mesh reduces its dots across."""

    def matvec(x_stacked):
        return sharded_spmv(A, x_stacked, mesh)

    matvec.mesh = A.mesh
    return matvec

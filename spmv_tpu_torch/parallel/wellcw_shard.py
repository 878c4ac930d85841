"""Row-block sharded WELL-CW SpMV and SpMM with a ragged halo exchange.

The counterpart of ``spmv_tpu/parallel/wellcw_shard.py``.  The geometry
is ``well_shard``'s (JAX's): 128-aligned nnz-balanced bounds, R rows a
shard with its overflow slot, vectors in the stacked (P, R) layout and
blocks (P, R, k).

JAX collapses each shard's WELL-CW into grouped, pooled and remainder
sets with gather tables into an extended ``[own x | halo]`` vector, an
XLA formulation.  The port packs each shard's **interior** (the entries
of its own columns) as a real ``WellCwMatrix`` of R rows and R columns,
with the same ``levels`` / ``pool_cap`` / ``tail_specs``, moved to a
``DeviceWellCw``.  A product is, a shard, the port's WELL-CW product on
the shard's row of the stacked x, read in place: K3c (merged grid) or
K3a (levels) and K3b (pools), and the CSR kernel on the remainder
(``ops.wellcw_kernels.wellcw_spmv_core``); the SpMM K4a-c and the CSR
SpMM (``wellcw_spmm_core``).  The entries of other shards' columns go to
a **boundary** CSR over the shard's received halo slots, one more CSR
SpMV / SpMM launch ``accumulate=True`` into the same row of y (none
where the shard reads no halo).  The SpMM's one exchange moves all k
columns.

On a process mesh a rank packs only its own shards' interiors and
boundaries, and receives the halo slots other ranks hold by
``halo_shard``'s plan (``well_shard.halo_split``), so its rows of y are
bitwise the single-process product's.  The exchange metadata are JAX's
on every rank: every rank derives the schedule from every shard's
needs.  JAX's padded envelope of the collapsed sets (its
``chunks_per_shard``, ``pool_chunks_per_shard``, ``rem_per_shard``)
describes its own layout; the port keeps none, on one process or many.

Every entry creates its need, so ``comm_elements_exact`` equals
``parallel.halo.communication_volume``'s halo count on the same bounds,
which ``shard_wellcw_halo`` checks (JAX asserts it).  The sums run in
another order than JAX's (its packing holds every entry of a row in one
WELL-CW of stacked columns), so the two agree within rounding.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.models.csr import CsrMatrix
from spmv_tpu_torch.models.device import DeviceWellCw, default_value_dtype
from spmv_tpu_torch.models.wellcw import (
    DEFAULT_LEVELS,
    DEFAULT_TAIL_SPECS,
    POOL_CAP,
    WellCwMatrix,
)
from spmv_tpu_torch.ops.csr_kernels import csr_spmm_core, csr_spmv_core
from spmv_tpu_torch.ops.wellcw_kernels import (
    wellcw_spmm_core,
    wellcw_spmv_core,
)
from spmv_tpu_torch.parallel.halo import communication_volume
from spmv_tpu_torch.parallel.comm import ExchangePlan
from spmv_tpu_torch.parallel.halo_shard import halo_of
from spmv_tpu_torch.parallel.mesh import Mesh
from spmv_tpu_torch.parallel.shard import _device, check_mesh
from spmv_tpu_torch.parallel.well_shard import (
    boundary_launches,
    group_partition,
    halo_split,
)

__all__ = [
    "ShardedWellCwHalo",
    "shard_wellcw_halo",
    "sharded_wellcw_halo_spmv",
    "make_sharded_wellcw_halo_matvec",
    "sharded_wellcw_halo_spmm",
    "make_sharded_wellcw_halo_matmat",
]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedWellCwHalo:
    """WELL-CW split into P 128-aligned row blocks with a halo plan.

    ``interior[i]`` is the ``DeviceWellCw`` of the i-th shard this
    process holds over its own x (R rows, R columns); ``boundary[i]``
    the ``DeviceCsr`` over its received halo (R rows, ``strips * H``
    columns), or None.  ``send_idx``, ``recv_index``, ``recv_missing``,
    ``mesh`` and ``plan`` as in ``ShardedCsrHalo``.
    """

    num_rows: int
    num_columns: int
    num_entries: int
    num_shards: int
    rows_per_shard: int
    bounds: tuple
    exchange: str
    max_distance: int
    halo_slots: int
    comm_elements_exact: int
    comm_elements_padded: int
    send_idx: np.ndarray
    recv_index: torch.Tensor
    recv_missing: torch.Tensor
    interior: tuple            # P_local DeviceWellCw
    boundary: tuple            # P_local DeviceCsr or None
    mesh: Mesh = None
    plan: ExchangePlan = None

    @property
    def stacked_size(self) -> int:
        return self.num_shards * self.rows_per_shard

    @property
    def device(self) -> torch.device:
        return self.recv_index.device

    @property
    def dtype(self) -> torch.dtype:
        return self.interior[0].value_dtype

    def launches_a_product(self, spmm: bool = False) -> dict:
        """The kernel launches of one product (the SpMM's with ``spmm``),
        by wrapper name: a shard's interior parts in ``wellcw_spmv_core``'s
        order (merged grid, levels, pools, remainder), then its boundary."""
        sfx = "_spmm_core" if spmm else "_core"
        csr = "csr_spmm_core" if spmm else "csr_spmv_core"
        n = collections.Counter()
        for A in self.interior:
            n["wellcw_merged" + sfx] += A.merged is not None
            n["wellcw_level" + sfx] += len(A.levels)
            n["wellcw_pool" + sfx] += (A.pool is not None) + len(A.tail_pools)
            n[csr] += A.remainder is not None
        return boundary_launches(self, n, csr)


def shard_wellcw_halo(
    m: CsrMatrix,
    num_shards: int,
    dtype=None,
    mesh: Mesh = None,
    exchange: str = "auto",
    neighbor_max_distance: int = 3,
    levels=DEFAULT_LEVELS,
    pool_cap: int = POOL_CAP,
    tail_specs=DEFAULT_TAIL_SPECS,
) -> ShardedWellCwHalo:
    """Halo-exchange sharding of a square host CSR matrix as local
    WELL-CW packs (``exchange`` as ``shard_csr_halo``'s); on a process
    mesh a rank packs only its own shards."""
    dtype = dtype or default_value_dtype()
    device = _device(mesh)
    bounds, R = group_partition(m, num_shards, "WELL-CW")
    fields, entries = halo_split(m, bounds, R, None, dtype, mesh,
                                 exchange, neighbor_max_distance)
    halo = communication_volume(m, bounds)["halo_elements"]
    if fields["comm_elements_exact"] != halo:
        raise MatrixError(
            f"WELL-CW halo: {fields['comm_elements_exact']} exchanged "
            f"elements, but the matrix reads {halo} across shards")
    interior = tuple(
        DeviceWellCw.from_host(WellCwMatrix._build(
            R, R, np.repeat(np.arange(R), np.diff(rp)), c, v, levels,
            pool_cap=pool_cap, tail_specs=tail_specs),
            dtype=dtype, device=device)
        for rp, c, v in entries)
    return ShardedWellCwHalo(interior=interior, **fields)


def sharded_wellcw_halo_spmv(A: ShardedWellCwHalo, x_stacked: torch.Tensor,
                             mesh: Mesh = None) -> torch.Tensor:
    """y = A @ x; vectors in stacked (P, R) layout.  A shard: the WELL-CW
    product over the interior on its own x, then the boundary CSR launch
    on its received halo, accumulating."""
    check_mesh(A, mesh)
    halo = halo_of(A, x_stacked)
    y = torch.empty_like(x_stacked)
    for q in range(len(A.interior)):
        wellcw_spmv_core(A.interior[q], x_stacked[q], out=y[q])
        if A.boundary[q] is not None:
            csr_spmv_core(A.boundary[q], halo[q], out=y[q], accumulate=True)
    return y


def sharded_wellcw_halo_spmm(A: ShardedWellCwHalo, X_stacked: torch.Tensor,
                             mesh: Mesh = None) -> torch.Tensor:
    """Y = A @ X; X and Y in stacked (P, R, k) layout.  One exchange
    moves every column's halo; a shard makes the WELL-CW SpMM over the
    interior and the boundary CSR SpMM launch, accumulating."""
    check_mesh(A, mesh)
    halo = halo_of(A, X_stacked)
    Y = torch.empty_like(X_stacked)
    for q in range(len(A.interior)):
        wellcw_spmm_core(A.interior[q], X_stacked[q], out=Y[q])
        if A.boundary[q] is not None:
            csr_spmm_core(A.boundary[q], halo[q], out=Y[q], accumulate=True)
    return Y


def make_sharded_wellcw_halo_matvec(A: ShardedWellCwHalo, mesh: Mesh = None):
    """Stacked-layout matvec closure for iterative solvers (CG)."""

    def matvec(x_stacked):
        return sharded_wellcw_halo_spmv(A, x_stacked, mesh)

    matvec.mesh = A.mesh
    return matvec


def make_sharded_wellcw_halo_matmat(A: ShardedWellCwHalo, mesh: Mesh = None):
    """Stacked-layout matmat closure ((P, R, k) -> (P, R, k))."""

    def matmat(X_stacked):
        return sharded_wellcw_halo_spmm(A, X_stacked, mesh)

    matmat.mesh = A.mesh
    return matmat

"""Row-block sharded WELL SpMV: x all-gathered, or a ragged halo exchange.

The counterpart of ``spmv_tpu/parallel/well_shard.py``.  The geometry
is JAX's: nnz-balanced row bounds rounded up to 128-row WELL groups,
``R = max(round_up(max block rows + 1, 128), 128)`` rows a shard, so
slot ``R - 1`` is an overflow row of no shard, and vectors in
``parallel.shard``'s stacked (P, R) layout.

All-gather (``ShardedWell``)
----------------------------
Columns are remapped into the stacked index space (global slot ``q*R +
(j - bounds[q])`` for a column j of shard q) and each shard's rows are
packed by the port's ``WellMatrix._build`` into one ``DeviceWell`` of R
rows and P*R columns, unpadded: the JAX package pads every shard to a
common chunk count and spill length, a TPU layout the kernel does not
need.  ``DeviceWell.from_host`` picks whole-x or segmented mode from
the stacked x's size, as it does for any matrix, so a product is one K5
launch a shard (K5a or K5b, ``ops.well_kernels.well_spmv_core``) on the
flat stacked x, the spill folded in.  On a process mesh a rank packs
only its own shards, and the flat stacked x is ``comm.all_gather_rows``
of every rank's rows (JAX's ``all_gather``): each launch reads the
values it reads on one device, so each rank's rows of y are bitwise the
single-process product's.  The envelope (``chunks_per_shard``,
``spill_per_shard``) is JAX's over every shard on every rank: each rank
takes its own shards' maxima and the ranks agree on the largest
(``comm.max_over_ranks``); packing every shard on every rank only to
count them would repeat the build's main cost.

Halo (``ShardedWellHalo``)
--------------------------
Each shard receives only the x elements its nonzero entries read from
other shards, by ``halo_shard``'s schedule (``neighbor`` / ``all2all``
/ ``none``), with needs equal to JAX's: JAX derives them from the
packed cells and the spill and redirects every zero-valued cell to a
local element, so an entry creates a need when it lies in another
shard's columns and its value, in the value dtype, is not zero.

A shard's entries are split on the host: those of its own columns are
packed as a WELL of R rows and R columns (the **interior**, one K5
launch on the shard's row of the stacked x, read in place), those of
other shards' columns go to a CSR of R rows over its received halo
slots (the **boundary**, one CSR launch ``accumulate=True`` into the
same row of y; none where the shard reads no halo).  The one K5 launch
on an extended ``[own x | halo]`` vector that the JAX layout suggests
would copy the shard's x into that vector every product, and the
windows would spill the far halo columns anyway; the split reads x in
place and is the layout of ``halo_shard``'s CSR.  A remote entry whose
value is zero is dropped (JAX multiplies it by a local element).  The
sums run in another order than JAX's (its packing holds every entry of
a row in one WELL of stacked columns), so the two agree within
rounding.

The exchange is ``halo_shard``'s: one ``index_select`` of the stacked x
by a host-built receive table.  On a process mesh every rank finds every
shard's needs (the schedule is one for the job), packs only its own
shards, and receives the slots other ranks hold by the plan
``comm.exchange_plan`` makes (``halo_shard.receiving_side``), so its
receive buffers, and its rows of y, are bitwise the single-process
ones.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.models.csr import CsrMatrix
from spmv_tpu_torch.models.device import (
    DeviceWell,
    default_value_dtype,
    round_up,
)
from spmv_tpu_torch.models.partition import rows_partition_balanced_nnz
from spmv_tpu_torch.models.well import GROUP_ROWS, LANE, WellMatrix
from spmv_tpu_torch.ops.csr_kernels import csr_spmv_core
from spmv_tpu_torch.ops.solvers import _np_type
from spmv_tpu_torch.ops.well_kernels import well_spmv_core
from spmv_tpu_torch.parallel.comm import (
    ExchangePlan,
    all_gather_rows,
    max_over_ranks,
)
from spmv_tpu_torch.parallel.halo_shard import (
    build_exchange_schedule,
    halo_of,
    receive_index,
    receiving_side,
)
from spmv_tpu_torch.parallel.mesh import Mesh
from spmv_tpu_torch.parallel.shard import (
    _device,
    check_mesh,
    local_csr,
    mesh_shards,
)

__all__ = [
    "ShardedWell",
    "shard_well",
    "sharded_well_spmv",
    "make_sharded_well_matvec",
    "ShardedWellHalo",
    "shard_well_halo",
    "sharded_well_halo_spmv",
    "make_sharded_well_halo_matvec",
]


def k5_name(A: DeviceWell) -> str:
    """The wrapper that launches A's product: K5a or K5b by its mode."""
    return "well_whole_core" if A.segment_of_step is None else "well_seg_core"


def group_partition(m: CsrMatrix, num_shards: int, what: str):
    """JAX's 128-aligned nnz-balanced bounds of a square unpadded CSR and
    R, the rows a shard: ``(bounds, R)``."""
    if m.num_rows != m.num_columns:
        raise MatrixError(
            f"sharded {what} requires a square matrix (x and y share the "
            "row partition)")
    if int(m.row_ptr[-1]) != m.num_entries:
        raise MatrixError(f"sharded {what} requires an unpadded CSR")
    bounds = rows_partition_balanced_nnz(m.row_ptr, int(num_shards))
    bounds = np.minimum(round_up(bounds, GROUP_ROWS), m.num_rows)
    bounds[0] = 0
    bounds[-1] = m.num_rows
    R = max(round_up(int(np.diff(bounds).max(initial=0)) + 1, GROUP_ROWS),
            GROUP_ROWS)
    return bounds.astype(np.int64), R


def stacked_columns(m: CsrMatrix, bounds, R: int) -> np.ndarray:
    """Each entry's column in the stacked index space."""
    cols = np.asarray(m.column_index[: m.num_entries], dtype=np.int64)
    owner = np.searchsorted(bounds, cols, side="right") - 1
    return owner * R + (cols - bounds[owner])


def _local_row_ptr(m: CsrMatrix, bounds, q: int, num_rows: int, keep=None):
    """Row pointer over ``num_rows`` local rows of shard q's entries (all
    of them, or those where ``keep`` over them is set)."""
    ptr = np.asarray(m.row_ptr[bounds[q]: bounds[q + 1] + 1], np.int64)
    lengths = np.diff(ptr)
    if keep is not None:
        rows = np.repeat(np.arange(lengths.size), lengths)
        lengths = np.bincount(rows[keep], minlength=lengths.size)
    rp = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(lengths, out=rp[1: lengths.size + 1])
    rp[lengths.size + 1:] = rp[lengths.size]
    return rp


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedWell:
    """WELL split into P 128-aligned row blocks, x all-gathered.

    ``blocks[i]`` is the ``DeviceWell`` of the i-th shard this process
    holds (all P on a single-process mesh): R rows, P*R columns in the
    stacked x index space.  ``chunks_per_shard`` and ``spill_per_shard``
    are the JAX container's uniform envelope over every shard (the most
    chunks a shard's WELL holds; the longest spill rounded up to 128),
    kept as numbers: the port stores each shard unpadded.  ``mesh`` is
    the mesh it was built on.
    """

    num_rows: int
    num_columns: int
    num_entries: int
    num_shards: int
    rows_per_shard: int        # R: multiple of 128, > max block rows
    chunks_per_shard: int      # C (JAX's envelope)
    spill_per_shard: int       # E (JAX's envelope)
    window_rows: int
    bounds: tuple              # (P+1,) python ints, 128-aligned
    blocks: tuple              # the local shards' DeviceWell
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

    def launches_a_product(self) -> dict:
        """The kernel launches of one product, by wrapper name."""
        return dict(collections.Counter(k5_name(b) for b in self.blocks))


def _envelope(wells, mesh: Mesh) -> tuple:
    """JAX's (C, E) over every shard: the largest over this process's
    host WELLs and the other ranks'."""
    c, e = max_over_ranks((max(w.num_chunks for w in wells),
                           max(w.num_spilled for w in wells)), mesh)
    return c, max(round_up(e, LANE), LANE)


def shard_well(
    m: CsrMatrix,
    num_shards: int,
    window_rows: int = 4,
    dtype=None,
    mesh: Mesh = None,
) -> ShardedWell:
    """Build a ``ShardedWell`` from a square host CSR matrix.  The blocks
    go to ``mesh``'s device, or to ``default_device()`` without a mesh;
    on a process mesh a rank packs only its own shards."""
    dtype = dtype or default_value_dtype()
    device = _device(mesh)
    p = int(num_shards)
    shards = mesh_shards(mesh, p)
    bounds, R = group_partition(m, p, "WELL")
    scols = stacked_columns(m, bounds, R)
    rp = np.asarray(m.row_ptr, np.int64)
    vals = np.asarray(m.value[: m.num_entries])
    wells = [WellMatrix._build(
        R, p * R, _local_row_ptr(m, bounds, q, R),
        scols[rp[bounds[q]]: rp[bounds[q + 1]]],
        vals[rp[bounds[q]]: rp[bounds[q + 1]]], window_rows)
        for q in shards]
    c, e = _envelope(wells, mesh)
    return ShardedWell(
        num_rows=m.num_rows,
        num_columns=m.num_columns,
        num_entries=m.num_entries,
        num_shards=p,
        rows_per_shard=R,
        chunks_per_shard=c,
        spill_per_shard=e,
        window_rows=int(window_rows),
        bounds=tuple(int(b) for b in bounds),
        blocks=tuple(DeviceWell.from_host(w, dtype=dtype, device=device)
                     for w in wells),
        mesh=mesh,
    )


def sharded_well_spmv(A: ShardedWell, x_stacked: torch.Tensor,
                      mesh: Mesh = None) -> torch.Tensor:
    """y = A @ x; vectors in stacked (P, R) layout (the local shards' rows
    on a process mesh).  One K5 launch a shard on the flat stacked x
    (the all-gather).  ``mesh`` (optional) must be the shards' mesh."""
    check_mesh(A, mesh)
    x = all_gather_rows(x_stacked, A.mesh)
    y = torch.empty_like(x_stacked)
    for q, block in enumerate(A.blocks):
        well_spmv_core(block, x, out=y[q])
    return y


def make_sharded_well_matvec(A: ShardedWell, mesh: Mesh = None):
    """y = A @ x in stacked layout, as a closure (for solvers)."""

    def matvec(x_stacked):
        return sharded_well_spmv(A, x_stacked, mesh)

    matvec.mesh = A.mesh
    return matvec


def halo_split(m: CsrMatrix, bounds, R: int, live, dtype, mesh: Mesh,
               exchange: str, neighbor_max_distance: int) -> tuple:
    """Split ``m``'s entries for a halo path over ``bounds`` / R: an
    entry of another shard's columns creates a need where ``live`` (over
    the entries, or None for every entry) is set, and goes to the
    shard's boundary CSR; a remote entry that is not live is dropped.
    Every shard's needs make the schedule; only the shards this process
    holds (``mesh``'s) are split.  Returns the fields a halo container
    shares (geometry, exchange metadata, the receiving side and its
    plan, ``boundary``, ``mesh``) and each local shard's interior
    entries: (row_ptr over R rows, local columns, values)."""
    device = _device(mesh)
    p = len(bounds) - 1
    scols = stacked_columns(m, bounds, R)
    rp = np.asarray(m.row_ptr, np.int64)
    vals = np.asarray(m.value[: m.num_entries])
    remote, needs = [], []
    for q in range(p):
        lo, hi = int(rp[bounds[q]]), int(rp[bounds[q + 1]])
        c = scols[lo:hi]
        far = (c < q * R) | (c >= (q + 1) * R)
        remote.append(far)
        take = far if live is None else far & live[lo:hi]
        needs.append(np.unique(c[take]))
    sched = build_exchange_schedule(
        needs, np.arange(p + 1, dtype=np.int64) * R, exchange=exchange,
        neighbor_max_distance=neighbor_max_distance)
    slots = sched.num_strips * sched.halo_slots
    slot_of = np.zeros(p * R, dtype=np.int64)
    interior, boundary = [], []
    for q in mesh_shards(mesh, p):
        lo, hi = int(rp[bounds[q]]), int(rp[bounds[q + 1]])
        c, v, far = scols[lo:hi], vals[lo:hi], remote[q]
        interior.append((_local_row_ptr(m, bounds, q, R, ~far),
                         c[~far] - q * R, v[~far]))
        take = far if live is None else far & live[lo:hi]
        if not take.any():
            boundary.append(None)
            continue
        slot_of[sched._needs[q]] = sched._slots[q]
        boundary.append(local_csr(_local_row_ptr(m, bounds, q, R, take),
                                  slot_of[c[take]], v[take], R, slots,
                                  dtype, device))
    recv_index, recv_missing, plan = receiving_side(
        receive_index(sched.send_idx, R, sched.exchange, sched.max_distance),
        R, mesh, device)
    fields = dict(
        num_rows=m.num_rows, num_columns=m.num_columns,
        num_entries=m.num_entries, num_shards=p, rows_per_shard=R,
        bounds=tuple(int(b) for b in bounds), exchange=sched.exchange,
        max_distance=sched.max_distance, halo_slots=sched.halo_slots,
        comm_elements_exact=sched.comm_elements_exact,
        comm_elements_padded=sched.comm_elements_padded,
        send_idx=sched.send_idx, recv_index=recv_index,
        recv_missing=recv_missing, boundary=tuple(boundary), mesh=mesh,
        plan=plan)
    return fields, interior


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedWellHalo:
    """WELL split into P 128-aligned row blocks with a halo-exchange plan.

    ``interior[i]`` is the ``DeviceWell`` of the i-th shard this process
    holds over its own x (R rows, R columns); ``boundary[i]`` the
    ``DeviceCsr`` over its received halo (R rows, ``strips * H``
    columns), or None.  ``send_idx``, ``recv_index``, ``recv_missing``,
    ``mesh`` and ``plan`` as in ``ShardedCsrHalo``.
    """

    num_rows: int
    num_columns: int
    num_entries: int
    num_shards: int
    rows_per_shard: int
    window_rows: int
    bounds: tuple
    exchange: str
    max_distance: int
    halo_slots: int
    comm_elements_exact: int
    comm_elements_padded: int
    send_idx: np.ndarray
    recv_index: torch.Tensor
    recv_missing: torch.Tensor
    interior: tuple            # P_local DeviceWell
    boundary: tuple            # P_local DeviceCsr or None
    mesh: Mesh = None
    plan: ExchangePlan = None

    @property
    def stacked_size(self) -> int:
        return self.num_shards * self.rows_per_shard

    @property
    def device(self) -> torch.device:
        return self.interior[0].value.device

    @property
    def dtype(self) -> torch.dtype:
        return self.interior[0].value.dtype

    def launches_a_product(self) -> dict:
        """The kernel launches of one product, by wrapper name."""
        return boundary_launches(self, collections.Counter(
            k5_name(b) for b in self.interior), "csr_spmv_core")


def boundary_launches(A, counts: collections.Counter, name: str) -> dict:
    """``counts`` with one launch of ``name`` a shard that reads a halo."""
    counts[name] += sum(b is not None for b in A.boundary)
    return {k: v for k, v in counts.items() if v}


def shard_well_halo(
    m: CsrMatrix,
    num_shards: int,
    window_rows: int = 4,
    dtype=None,
    mesh: Mesh = None,
    exchange: str = "auto",
    neighbor_max_distance: int = 3,
) -> ShardedWellHalo:
    """Halo-exchange sharding of a square host CSR matrix as local WELLs
    (``exchange``: "auto", or "neighbor" / "all2all" forced, as
    ``shard_csr_halo``); on a process mesh a rank packs only its own
    shards."""
    dtype = dtype or default_value_dtype()
    device = _device(mesh)
    bounds, R = group_partition(m, num_shards, "WELL")
    live = np.asarray(m.value[: m.num_entries]).astype(_np_type(dtype)) != 0
    fields, entries = halo_split(m, bounds, R, live, dtype, mesh,
                                 exchange, neighbor_max_distance)
    interior = tuple(
        DeviceWell.from_host(WellMatrix._build(R, R, rp, c, v, window_rows),
                             dtype=dtype, device=device)
        for rp, c, v in entries)
    return ShardedWellHalo(window_rows=int(window_rows), interior=interior,
                           **fields)


def sharded_well_halo_spmv(A: ShardedWellHalo, x_stacked: torch.Tensor,
                           mesh: Mesh = None) -> torch.Tensor:
    """y = A @ x; vectors in stacked (P, R) layout.  A shard: one K5
    launch over the interior on its own x, then the boundary CSR launch
    on its received halo, accumulating."""
    check_mesh(A, mesh)
    halo = halo_of(A, x_stacked)
    y = torch.empty_like(x_stacked)
    for q in range(len(A.interior)):
        well_spmv_core(A.interior[q], x_stacked[q], out=y[q])
        if A.boundary[q] is not None:
            csr_spmv_core(A.boundary[q], halo[q], out=y[q], accumulate=True)
    return y


def make_sharded_well_halo_matvec(A: ShardedWellHalo, mesh: Mesh = None):
    """Stacked-layout matvec closure for iterative solvers (CG)."""

    def matvec(x_stacked):
        return sharded_well_halo_spmv(A, x_stacked, mesh)

    matvec.mesh = A.mesh
    return matvec

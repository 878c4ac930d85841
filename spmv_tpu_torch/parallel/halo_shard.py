"""Row-block sharded CSR SpMV and SpMM with a ragged halo exchange.

The counterpart of ``spmv_tpu/parallel/halo_shard.py``.  In place of
the all-gather of x (``parallel.shard``), each shard receives only the x
elements its rows read from other shards, the needs of
``parallel.halo.build_halo_plan`` (found here from each shard's own run
of entries).

Exchange strategies (``build_exchange_schedule``, JAX's numpy code):

- ``neighbor``: every remote element lies within ``D`` shards of its
  reader; 2*D uniformly padded strips a shard, one per (direction,
  distance), JAX's ``ppermute``s;
- ``all2all``: one padded slot of H elements per pair of shards, JAX's
  ``all_to_all``;
- ``none``: no shard reads another's x.

On a mesh of shards on one device a strip is a gather of the sender's x
at ``send_idx``.  ``receive_index`` turns the schedule into one index
table over the flat stacked x, (P, strips * H): entry [p, s] is the
stacked position shard p's halo slot s receives, or -1 where no shard
sends (a neighbour strip past either end), which receives 0 as JAX's
``ppermute`` delivers.  ``exchange_halos`` is then one gather for every
shard at once, with no copy made only to imitate a network.

On a process mesh a rank holds its own shards' rows and the rows of that
table for its shards: the slots whose sender lies on the same rank are
that gather over its local x, and the others arrive from their owners
(``comm.exchange_strips`` for ``neighbor``, ``comm.all_to_all_strips``
for ``all2all``, the plan ``comm.exchange_plan`` makes from every
rank's rows of the table), so each rank's receive buffer is, element
for element, what the single-process gather gives its shards.

Column indices are split on the host into an **interior** list (the
shard's own x) and a **boundary** list (its received halo slots), each
one ``DeviceCsr`` of R rows.  A product is, a shard, one launch of the
CSR kernel (``ops.csr_kernels``) over the interior on the shard's row of
the stacked x, then one over the boundary on its received halo,
``accumulate=True`` into the same row of y; a shard with no boundary
entry makes the first launch only.  JAX sums each row's interior and
boundary parts as two segment sums and adds them, as the two launches
do; the sums in each part run in another order than the JAX package's,
so the two agree within rounding.

Vectors use ``parallel.shard``'s stacked (P, R) layout, blocks (P, R, k)
(the column on axis 2, as in JAX).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spmv_tpu_torch.models.csr import CsrMatrix
from spmv_tpu_torch.models.device import default_value_dtype, round_up
from spmv_tpu_torch.ops.csr_kernels import csr_spmm_core, csr_spmv_core
from spmv_tpu_torch.parallel.comm import (
    ExchangePlan,
    all_to_all_strips,
    exchange_plan,
    exchange_strips,
)
from spmv_tpu_torch.parallel.mesh import Mesh
from spmv_tpu_torch.parallel.shard import (
    _device,
    _stack,
    _unstack,
    check_mesh,
    local_csr,
    mesh_shards,
    partition_rows,
    rows_per_shard,
    stack_vector,
)

__all__ = [
    "ShardedCsrHalo",
    "shard_csr_halo",
    "sharded_halo_spmv",
    "make_sharded_halo_matvec",
    "sharded_halo_spmm",
    "make_sharded_halo_matmat",
    "make_sharded_halo_flat_matmat",
    "stacked_row_mask",
    "stack_block",
    "unstack_block",
    "ExchangeSchedule",
    "build_exchange_schedule",
    "receive_index",
    "exchange_halos",
    "receiving_side",
    "receive_halos",
    "halo_of",
]

SLOT_PAD = 8  # pair/strip slot counts padded to multiples of 8, as in JAX


@dataclasses.dataclass(frozen=True)
class ExchangeSchedule:
    """Static halo-exchange schedule over a 1-D shard axis (JAX's).

    Built from per-shard *need lists* (sorted distinct remote positions
    each shard references) by ``build_exchange_schedule``.
    ``send_idx[p, strip, s]`` is the sender-local position (within p's
    own block) of slot s of that strip; a receiver's flat halo vector
    concatenates its incoming strips in strip order, so ``remap`` maps a
    global position to its receiver-side halo slot.
    """

    num_shards: int
    exchange: str              # "neighbor" | "all2all" | "none"
    max_distance: int          # D (neighbor mode; else 0)
    halo_slots: int            # H per strip
    num_strips: int            # 2*D (neighbor) or P (all2all)
    send_idx: np.ndarray       # (P, max(strips,1), max(H,1)) int32
    comm_elements_exact: int
    comm_elements_padded: int
    # per dst shard: sorted needs + their flat halo slots (same order)
    _needs: tuple              # tuple of np.ndarray (sorted positions)
    _slots: tuple              # tuple of np.ndarray (flat halo index)

    def remap(self, dst: int, pos: np.ndarray) -> np.ndarray:
        """Flat halo slots (on shard dst) of global positions ``pos``
        (every entry must be in dst's need list)."""
        pos = np.asarray(pos, dtype=np.int64)
        needs = self._needs[dst]
        i = np.searchsorted(needs, pos)
        if pos.size and not (
            (i < needs.size) & (needs[np.minimum(i, needs.size - 1)]
                                == pos)
        ).all():
            raise ValueError("position not in the shard's need list")
        return self._slots[dst][i]


def build_exchange_schedule(
    needs: list,
    owner_bounds: np.ndarray,
    exchange: str = "auto",
    neighbor_max_distance: int = 3,
) -> ExchangeSchedule:
    """Build the exchange schedule from per-shard need lists (the JAX
    package's code).

    ``needs[p]``: sorted distinct global positions shard p references
    outside its own ``[owner_bounds[p], owner_bounds[p+1])`` range.
    ``exchange``: "auto" picks "none" where nothing moves, "neighbor"
    where every need lies within ``neighbor_max_distance`` shards, else
    "all2all"; each can be forced.
    """
    owner_bounds = np.asarray(owner_bounds, dtype=np.int64)
    p = owner_bounds.size - 1
    needs = [np.asarray(n, dtype=np.int64) for n in needs]
    sources = [
        np.searchsorted(owner_bounds, n, side="right") - 1 for n in needs
    ]

    pair_sizes = np.zeros((p, p), dtype=np.int64)
    max_dist = 0
    for dst in range(p):
        if sources[dst].size:
            np.add.at(pair_sizes[:, dst], sources[dst], 1)
            max_dist = max(
                max_dist, int(np.abs(sources[dst] - dst).max())
            )
    total = int(sum(n.size for n in needs))

    if exchange == "auto":
        if total == 0 or p == 1:
            exchange = "none"
        elif max_dist <= neighbor_max_distance:
            exchange = "neighbor"
        else:
            exchange = "all2all"

    if exchange == "neighbor" and max_dist > 0:
        D = max_dist
        n_strips = 2 * D
        H = max(
            round_up(int(pair_sizes.max(initial=0)), SLOT_PAD), SLOT_PAD
        )

        # Relative strip index (same from both ends): left halos by
        # ascending distance, then right halos by ascending distance.
        def send_strip(src, dst):
            d = dst - src
            return d - 1 if d > 0 else D + (-d) - 1

        recv_strip = send_strip
    elif exchange == "all2all":
        D = 0
        n_strips = p
        H = max(
            round_up(int(pair_sizes.max(initial=0)), SLOT_PAD), SLOT_PAD
        )

        # Sender's strip q goes TO shard q; the receiver's flat halo
        # vector is indexed by the SOURCE shard.
        def send_strip(src, dst):
            return dst

        def recv_strip(src, dst):
            return src
    else:
        exchange, D, n_strips, H = "none", 0, 0, 0
        send_strip = recv_strip = None

    send_idx = np.zeros((p, max(n_strips, 1), max(H, 1)), dtype=np.int32)
    slots = []
    for dst in range(p):
        slot = np.zeros(needs[dst].size, dtype=np.int64)
        for q in np.unique(sources[dst]):
            sel = sources[dst] == q
            cols_q = needs[dst][sel]       # sorted run (needs sorted,
            #                                owner ranges contiguous)
            send_idx[q, send_strip(int(q), dst), : cols_q.size] = (
                cols_q - owner_bounds[q]
            )
            slot[sel] = (recv_strip(int(q), dst) * H
                         + np.arange(cols_q.size))
        slots.append(slot)

    return ExchangeSchedule(
        num_shards=p,
        exchange=exchange,
        max_distance=D,
        halo_slots=H,
        num_strips=n_strips,
        send_idx=send_idx,
        comm_elements_exact=total,
        comm_elements_padded=int(p * n_strips * H),
        _needs=tuple(needs),
        _slots=tuple(slots),
    )


def receive_index(send_idx: np.ndarray, rows_per_shard: int,
                  exchange: str, max_distance: int) -> np.ndarray:
    """(P, strips * H) int64: the position in the flat stacked x
    (``p * rows_per_shard + local``) that slot s of shard p's received
    halo vector holds, -1 where no shard sends (JAX's ``ppermute`` to a
    shard with no source delivers 0).  Empty for ``"none"``."""
    P, S, H = send_idx.shape
    if exchange == "none":
        return np.zeros((P, 0), dtype=np.int64)
    src = np.empty((P, S), dtype=np.int64)
    q = np.arange(P)
    if exchange == "all2all":
        # slot strip s of shard q comes from shard s, its strip q
        src[:] = q[None, :]
        strip = np.broadcast_to(q[:, None], (P, S))
    elif exchange == "neighbor":
        D = max_distance
        # strip d < D from shard q-1-d, strip D+d from shard q+1+d, each
        # sent with its own strip index
        for d in range(D):
            src[:, d] = q - 1 - d
            src[:, D + d] = q + 1 + d
        strip = np.broadcast_to(np.arange(S)[None, :], (P, S))
    else:
        raise ValueError(f"unknown exchange {exchange!r}")
    ok = (src >= 0) & (src < P)
    s_ = np.where(ok, src, 0)
    idx = s_[:, :, None] * rows_per_shard + send_idx[s_, strip]
    return np.where(ok[:, :, None], idx, -1).reshape(P, S * H)


def exchange_halos(x_stacked: torch.Tensor, index: torch.Tensor,
                   missing: torch.Tensor = None) -> torch.Tensor:
    """Every shard's received halo vector, (P, slots, *trailing): rows
    of the stacked ``x_stacked`` (P, R, *trailing) at ``index`` (P,
    slots) into its flat row axis, and 0 where ``missing`` (P, slots) is
    set.  Trailing axes ride along (the SpMM's k columns)."""
    P, R = x_stacked.shape[:2]
    trailing = tuple(x_stacked.shape[2:])
    flat = x_stacked.reshape((P * R,) + trailing)
    recv = flat.index_select(0, index.reshape(-1)).reshape(
        tuple(index.shape) + trailing)
    if missing is not None:
        recv.masked_fill_(missing.reshape(
            tuple(missing.shape) + (1,) * len(trailing)), 0)
    return recv


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedCsrHalo:
    """CSR split into P row blocks with a static halo-exchange plan.

    ``interior[i]`` is the ``DeviceCsr`` of the i-th shard this process
    holds (all P on a single-process mesh) over its own x (R rows, R
    columns); ``boundary[i]`` the one over its received halo (R rows,
    ``strips * H`` columns), or None where the shard reads no other
    shard's x.  ``send_idx`` is the schedule's table (JAX's layout:
    (P, P, H) for all2all, (P, 2*D, H) for neighbor); ``recv_index``
    and ``recv_missing`` its receiving side for the local shards on
    their device (``receive_index``, as positions in the local flat x;
    ``recv_missing`` None where every slot has a sender), and ``plan``
    the slots other ranks send (None on one process).
    """

    num_rows: int
    num_columns: int
    num_entries: int
    num_shards: int
    rows_per_shard: int        # R
    halo_slots: int            # H (per pair / per strip)
    bounds: tuple              # (P+1,) python ints
    exchange: str              # "neighbor" | "all2all" | "none"
    max_distance: int          # D (neighbor mode; else 0)
    comm_elements_exact: int   # sum of true pairwise halo sizes
    comm_elements_padded: int  # elements moved per step (all shards)
    send_idx: np.ndarray
    recv_index: torch.Tensor
    recv_missing: torch.Tensor
    interior: tuple            # P_local DeviceCsr
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


def shard_csr_halo(
    m: CsrMatrix,
    num_shards: int,
    dtype=None,
    partition: str = "nnz",
    mesh: Mesh = None,
    exchange: str = "auto",
    neighbor_max_distance: int = 3,
) -> ShardedCsrHalo:
    """Build the halo-exchange sharding of a square host CSR matrix.

    ``exchange``: "auto" picks "neighbor" when the halo plan's largest
    source distance is at most ``neighbor_max_distance``, else
    "all2all"; either can be forced.  The blocks go to ``mesh``'s
    device, or to ``default_device()`` without a mesh; on a process mesh
    a rank builds only its own shards' blocks.
    """
    dtype = dtype or default_value_dtype()
    device = _device(mesh)
    p = int(num_shards)
    shards = mesh_shards(mesh, p)
    bounds = np.asarray(partition_rows(m, p, partition), dtype=np.int64)
    R = rows_per_shard(bounds)
    row_ptr = np.asarray(m.row_ptr, dtype=np.int64)
    cols = np.asarray(m.column_index[: row_ptr[-1]], dtype=np.int64)
    # each shard's needs from its own run of entries: build_halo_plan's
    # halo_indices, without its masks over every entry
    needs = []
    for q in range(p):
        c = cols[row_ptr[bounds[q]]: row_ptr[bounds[q + 1]]]
        needs.append(np.unique(c[(c < bounds[q]) | (c >= bounds[q + 1])]))
    sched = build_exchange_schedule(
        needs, bounds,
        exchange=exchange,
        neighbor_max_distance=neighbor_max_distance,
    )
    slots = sched.num_strips * sched.halo_slots

    interior, boundary = [], []
    # each shard's halo slot of a remote column: a table over the columns
    # (``sched.remap``'s binary search over the need list, at every entry,
    # took most of a 4M-row build)
    slot_of = np.zeros(m.num_columns, dtype=np.int64)
    for q in shards:
        lo, hi = int(row_ptr[bounds[q]]), int(row_ptr[bounds[q + 1]])
        ptr = row_ptr[bounds[q]: bounds[q + 1] + 1]
        rows_q = np.repeat(np.arange(ptr.size - 1), np.diff(ptr))
        cols_q = cols[lo:hi]
        vals_q = np.asarray(m.value[lo:hi])
        local = (cols_q >= bounds[q]) & (cols_q < bounds[q + 1])
        # each row's entries keep their order within either list
        i_ptr = np.zeros(ptr.size, dtype=np.int64)
        np.cumsum(np.bincount(rows_q[local], minlength=ptr.size - 1),
                  out=i_ptr[1:])
        interior.append(local_csr(i_ptr, cols_q[local] - bounds[q],
                                  vals_q[local], R, R, dtype, device))
        if local.all():
            boundary.append(None)
            continue
        b_ptr = np.zeros(ptr.size, dtype=np.int64)
        np.cumsum(np.bincount(rows_q[~local], minlength=ptr.size - 1),
                  out=b_ptr[1:])
        slot_of[sched._needs[q]] = sched._slots[q]
        boundary.append(local_csr(b_ptr, slot_of[cols_q[~local]],
                                  vals_q[~local], R, slots, dtype, device))

    recv_index, recv_missing, plan = receiving_side(
        receive_index(sched.send_idx, R, sched.exchange, sched.max_distance),
        R, mesh, device)
    return ShardedCsrHalo(
        num_rows=m.num_rows,
        num_columns=m.num_columns,
        num_entries=m.num_entries,
        num_shards=p,
        rows_per_shard=R,
        halo_slots=sched.halo_slots,
        bounds=tuple(int(b) for b in bounds),
        exchange=sched.exchange,
        max_distance=sched.max_distance,
        comm_elements_exact=sched.comm_elements_exact,
        comm_elements_padded=sched.comm_elements_padded,
        send_idx=sched.send_idx,
        recv_index=recv_index,
        recv_missing=recv_missing,
        interior=tuple(interior),
        boundary=tuple(boundary),
        mesh=mesh,
        plan=plan,
    )


def receiving_side(recv: np.ndarray, rows_per_shard: int, mesh: Mesh,
                   device):
    """The receiving side of the table ``recv`` (P, slots) of flat stacked
    positions (``rows_per_shard`` rows a shard, -1 where no shard sends)
    for the shards this process holds: ``(recv_index, recv_missing,
    plan)``, the positions of its local flat x each slot gathers, the
    mask of the slots that receive 0 (None where every slot has a
    sender) and, on a mesh of several ranks, the ``ExchangePlan`` of the
    slots other ranks send (else None)."""
    plan = None
    if mesh is not None and mesh.world_size > 1 and recv.size:
        per_rank = mesh.shards_per_rank
        index, missing, plan = exchange_plan(
            [recv[r * per_rank:(r + 1) * per_rank].reshape(-1)
             for r in range(mesh.world_size)], per_rank * rows_per_shard,
            mesh)
        index, missing = (a.reshape(per_rank, -1) for a in (index, missing))
    else:
        if mesh is not None:
            recv = recv[mesh.local_shards.start: mesh.local_shards.stop]
        index, missing = np.maximum(recv, 0), recv < 0
    return (torch.from_numpy(index).to(device),
            torch.from_numpy(missing).to(device) if missing.any() else None,
            plan)


def receive_halos(x_stacked: torch.Tensor, index: torch.Tensor,
                  missing: torch.Tensor, plan: ExchangePlan, exchange: str,
                  mesh: Mesh) -> torch.Tensor:
    """The local shards' receive buffers (P_local, slots, *trailing) of
    the stacked x: the slots this process holds gathered from its x
    (``exchange_halos``), those of other ranks received by ``plan``
    (``all2all``: one ``all_to_all_single``; else point to point)."""
    recv = exchange_halos(x_stacked, index, missing)
    if plan is not None:
        trailing = tuple(x_stacked.shape[2:])
        move = all_to_all_strips if exchange == "all2all" else exchange_strips
        move(x_stacked.reshape((-1,) + trailing),
             recv.view((-1,) + trailing), plan, mesh)
    return recv


def halo_of(A, x_stacked: torch.Tensor):
    """Every local shard's received halo of the stacked x (or X) for a
    halo container, or None for ``exchange == "none"``: the slots this
    process holds gathered from its x, those of other ranks received."""
    if A.exchange == "none":
        return None
    return receive_halos(x_stacked, A.recv_index, A.recv_missing, A.plan,
                         A.exchange, A.mesh)


def sharded_halo_spmv(A: ShardedCsrHalo, x_stacked: torch.Tensor,
                      mesh: Mesh = None) -> torch.Tensor:
    """y = A @ x; vectors in stacked (P, R) layout.  A shard: the
    interior launch on its own x, then the boundary launch on its
    received halo, accumulating."""
    check_mesh(A, mesh)
    halo = halo_of(A, x_stacked)
    y = torch.empty_like(x_stacked)
    for q in range(len(A.interior)):
        csr_spmv_core(A.interior[q], x_stacked[q], out=y[q])
        if A.boundary[q] is not None:
            csr_spmv_core(A.boundary[q], halo[q], out=y[q], accumulate=True)
    return y


def sharded_halo_spmm(A: ShardedCsrHalo, X_stacked: torch.Tensor,
                      mesh: Mesh = None) -> torch.Tensor:
    """Y = A @ X; X and Y in stacked (P, R, k) layout.  One exchange
    moves every column's halo; a shard makes the interior and boundary
    launches of the CSR SpMM."""
    check_mesh(A, mesh)
    halo = halo_of(A, X_stacked)
    Y = torch.empty_like(X_stacked)
    for q in range(len(A.interior)):
        csr_spmm_core(A.interior[q], X_stacked[q], out=Y[q])
        if A.boundary[q] is not None:
            csr_spmm_core(A.boundary[q], halo[q], out=Y[q], accumulate=True)
    return Y


def make_sharded_halo_matvec(A: ShardedCsrHalo, mesh: Mesh = None):
    """Stacked-layout matvec closure for iterative solvers (CG)."""

    def matvec(x_stacked):
        return sharded_halo_spmv(A, x_stacked, mesh)

    matvec.mesh = A.mesh
    return matvec


def make_sharded_halo_matmat(A: ShardedCsrHalo, mesh: Mesh = None):
    """Stacked-layout matmat closure, (P, R, k) -> (P, R, k).

    Its block has the column on axis 2, as JAX's; ``ops.
    batched_conjugate_gradient`` reduces and broadcasts along axis 1,
    so it does not take this block as it stands (neither does JAX's:
    there axis 1 is the rows, ROADMAP.md Queue 3).
    """

    def matmat(X_stacked):
        return sharded_halo_spmm(A, X_stacked, mesh)

    matmat.mesh = A.mesh
    return matmat


def make_sharded_halo_flat_matmat(A: ShardedCsrHalo, mesh: Mesh = None):
    """Matmat closure over the stacked block flattened, (P_local * R, k)
    -> (P_local * R, k), as ``ops.lobpcg`` holds its basis; it carries
    ``.mesh``."""
    mm = make_sharded_halo_matmat(A, mesh)

    def matmat(V):
        n, k = V.shape
        return mm(V.reshape(-1, A.rows_per_shard, k)).reshape(n, k)

    matmat.mesh = A.mesh
    return matmat


def stacked_row_mask(sharded, mesh: Mesh = None) -> torch.Tensor:
    """The flat (P_local * R,) mask of the stacked layout over the shards
    this process holds: 1 on a row of the matrix, 0 on a padding row or
    an overflow slot.  ``ops.lobpcg``'s ``mask=`` over a sharded matmat:
    a padding row left in the basis aliases the operator's null space."""
    return stack_vector(np.ones(sharded.bounds[-1]), sharded,
                        mesh).reshape(-1)


def stack_block(V, sharded, mesh: Mesh = None) -> torch.Tensor:
    """Block (num_rows, k), numpy or torch -> stacked (P, R, k) layout on
    the shards' device, in their value dtype: the rows of the shards this
    process holds."""
    check_mesh(sharded, mesh)
    return _stack(V, sharded)


def unstack_block(stacked, sharded) -> np.ndarray:
    """Stacked (P, R, k) -> host (num_rows, k), on every rank of a
    process mesh."""
    return _unstack(stacked, sharded)

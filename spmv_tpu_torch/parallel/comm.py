"""The collectives of a mesh: the port's stand-in for ``shard_map``'s.

The sharded paths call five operations, each the counterpart of one
JAX collective:

- ``all_gather_rows``: ``lax.all_gather`` of x (the all-gather CSR);
- ``exchange_strips``: the ``lax.ppermute``s of halo strips (the DIA
  halo, the ragged halo's ``neighbor`` schedule), one
  ``batch_isend_irecv`` with each peer rank;
- ``all_to_all_strips``: the ``lax.all_to_all`` of the ragged halo's
  ``all2all`` schedule, one ``all_to_all_single`` with the schedule's
  padded equal slots a pair of shards;
- ``all_reduce_sum``: the ``psum`` of a solver's dots;
- ``all_reduce_max``: what the ranks agree on while building a
  container (JAX's one controller sees every shard): the envelope
  numbers over every rank's shards, and the flags of block-Jacobi
  IC(0)'s shift ladder.

On a single-process mesh (``mesh.group`` None) each is today's view,
gather or nothing: every shard lies in the one stacked tensor.  On a
process mesh they run over the group, even at one rank.  A rank's part
of a halo exchange is an ``ExchangePlan`` built on the host from what
every rank's receive buffer holds (``exchange_plan``): positions it
holds itself are gathered locally (the caller's ``index_select``), the
others arrive from their owners in the receiver's slot order.

Gloo moves no CUDA tensor point to point or all to all, so where a
process mesh on a card runs on Gloo (two ranks sharing one card), the
tensors each operation moves are staged through pinned host buffers,
here and nowhere else; on NCCL device tensors pass as they are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from spmv_tpu_torch.parallel.mesh import Mesh

__all__ = ["ExchangePlan", "exchange_plan", "all_gather_rows",
           "exchange_strips", "all_to_all_strips", "all_reduce_sum",
           "all_reduce_max", "max_over_ranks"]


def _staged(t: torch.Tensor, mesh: Mesh) -> bool:
    """Whether ``t`` goes through host memory on ``mesh``'s group."""
    return t.is_cuda and dist.get_backend(mesh.group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _buffer(shape, like: torch.Tensor, staged: bool) -> torch.Tensor:
    if staged:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def all_gather_rows(x_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rank's stacked rows (P_local, R, *trailing) in, every shard's
    flat (P R, *trailing) out, in shard order."""
    trailing = tuple(x_local.shape[2:])
    if mesh is None or mesh.group is None:
        return x_local.reshape((-1,) + trailing)
    staged = _staged(x_local, mesh)
    src = _to_host(x_local) if staged else x_local.contiguous()
    out = _buffer((mesh.world_size,) + tuple(x_local.shape), x_local, staged)
    dist.all_gather(list(out.unbind(0)), src, group=mesh.group)
    return out.to(x_local.device).reshape((-1,) + trailing)


def _all_reduce(t: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    if mesh is None or mesh.group is None:
        return t
    if _staged(t, mesh):
        h = _to_host(t)
        dist.all_reduce(h, op=op, group=mesh.group)
        return t.copy_(h)
    dist.all_reduce(t, op=op, group=mesh.group)
    return t


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the mesh's ranks, in place; ``t`` as it is on
    a single-process mesh."""
    return _all_reduce(t, mesh, dist.ReduceOp.SUM)


def all_reduce_max(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the mesh's ranks, in place;
    ``t`` as it is on a single-process mesh."""
    return _all_reduce(t, mesh, dist.ReduceOp.MAX)


def max_over_ranks(values, mesh: Mesh) -> tuple:
    """Host ints, each the largest any rank of ``mesh`` passes: one
    ``all_reduce_max`` on the mesh's device (every rank must call it)."""
    if mesh is None or mesh.group is None:
        return tuple(int(v) for v in values)
    t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                     device=mesh.device)
    return tuple(int(v) for v in all_reduce_max(t, mesh).tolist())


@dataclasses.dataclass(frozen=True, eq=False)
class ExchangePlan:
    """One rank's side of a halo exchange over its flat x (rows of its
    own shards) into its flat receive buffer (``slots`` rows).

    ``send_index`` lists the rows of the flat x it sends, peer after
    peer in rank order, ``send_splits[q]`` of them to rank q;
    ``recv_slots`` the receive rows that what arrives fills, in the same
    order, ``recv_splits[q]`` of them from rank q.  Its own rank's
    splits are 0: the caller gathers those rows itself.
    """

    slots: int
    send_index: torch.Tensor      # (sum(send_splits),) int64
    send_splits: tuple
    recv_slots: torch.Tensor      # (sum(recv_splits),) int64
    recv_splits: tuple


def exchange_plan(tables, rows_per_rank: int, mesh: Mesh):
    """Plan rank ``mesh.rank``'s exchange from ``tables[r]``, rank r's
    receive buffer as global flat positions (rank q owning
    ``[q rows_per_rank, (q + 1) rows_per_rank)``), -1 for a slot that no
    shard sends (it receives 0).  Every rank passes the same tables.

    Returns (``index``, ``missing``, plan): the local flat position of
    each slot this rank holds itself (0 for the others) and the mask of
    the slots that receive 0, both numpy, and the ``ExchangePlan`` on
    the mesh's device.
    """
    r = mesh.rank
    own = np.asarray(tables[r], dtype=np.int64)
    owner = np.where(own >= 0, own // rows_per_rank, -1)
    local = owner == r
    index = np.where(local, own - r * rows_per_rank, 0)
    send, send_splits, recv, recv_splits = [], [], [], []
    for q in range(mesh.world_size):
        t = np.asarray(tables[q], dtype=np.int64)
        mine = (t >= 0) & (t // rows_per_rank == r) if q != r else \
            np.zeros(t.shape, dtype=bool)
        send.append(t[mine] - r * rows_per_rank)
        send_splits.append(int(mine.sum()))
        theirs = np.nonzero(owner == q)[0] if q != r else np.zeros(0, int)
        recv.append(theirs)
        recv_splits.append(int(theirs.size))

    def dev(parts):
        return torch.from_numpy(np.concatenate(parts).astype(np.int64)).to(
            mesh.device)

    plan = ExchangePlan(int(own.size), dev(send), tuple(send_splits),
                        dev(recv), tuple(recv_splits))
    return index, own < 0, plan


def exchange_strips(x_flat: torch.Tensor, recv: torch.Tensor,
                    plan: ExchangePlan, mesh: Mesh) -> torch.Tensor:
    """Fill the rows of ``recv`` (slots, *trailing) that other ranks hold
    from their flat x: one send and one receive with each peer rank that
    has rows for the other, all in one ``batch_isend_irecv``."""
    staged = _staged(x_flat, mesh)
    trailing = tuple(x_flat.shape[1:])
    sends = x_flat.index_select(0, plan.send_index).split(plan.send_splits)
    ops, arrived = [], []
    for q in range(mesh.world_size):
        if plan.send_splits[q]:
            s = _to_host(sends[q]) if staged else sends[q]
            ops.append(dist.P2POp(dist.isend, s, q, group=mesh.group))
        if plan.recv_splits[q]:
            b = _buffer((plan.recv_splits[q],) + trailing, x_flat, staged)
            ops.append(dist.P2POp(dist.irecv, b, q, group=mesh.group))
            arrived.append(b)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if arrived:
        recv.index_copy_(0, plan.recv_slots,
                         torch.cat(arrived).to(recv.device))
    return recv


def all_to_all_strips(x_flat: torch.Tensor, recv: torch.Tensor,
                      plan: ExchangePlan, mesh: Mesh) -> torch.Tensor:
    """Fill the rows of ``recv`` that other ranks hold, as
    ``exchange_strips``, in one ``all_to_all_single``: the all2all
    schedule gives every pair of ranks the same padded count."""
    staged = _staged(x_flat, mesh)
    trailing = tuple(x_flat.shape[1:])
    send = x_flat.index_select(0, plan.send_index)
    if staged:
        send = _to_host(send)
    out = _buffer((sum(plan.recv_splits),) + trailing, x_flat, staged)
    dist.all_to_all_single(out, send, list(plan.recv_splits),
                           list(plan.send_splits), group=mesh.group)
    recv.index_copy_(0, plan.recv_slots, out.to(recv.device))
    return recv

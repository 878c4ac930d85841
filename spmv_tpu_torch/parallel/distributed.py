"""The multi-process bootstrap and the process mesh.

The counterpart of ``spmv_tpu/parallel/distributed.py``.  There every
host runs the same program, calls ``initialize_distributed`` once, and
``jax.devices()`` then lists the global devices; a mesh over them routes
``shard_map``'s collectives between processes.  Here the processes are
``torch.distributed`` ranks, one a GPU:

- every rank runs the same program and calls ``initialize_distributed``
  once, before it builds a mesh;
- ``global_mesh(P)`` spreads P shards over the ranks, rank r holding the
  contiguous block of P / world_size shards, process 0's first;
- each rank keeps only its own shards' rows (``local_rows``, the
  counterpart of ``global_device_put``): every rank builds the same host
  matrix, and the mesh partitions the work.

The arguments default to torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), the
counterpart of ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``; nothing on a machine names a cluster, so the caller
(or torchrun) gives the address.  Without any of them the call is the
same single-process no-op, returning False.

Rank r runs on ``cuda:LOCAL_RANK`` unless the caller passes ``device``,
or on the CPU where ``SPMV_TPU_TORCH_DEVICE=cpu`` asks for it.  The
backend is NCCL on a card and Gloo on the CPU; Gloo on a card is taken
only when asked for (``backend="gloo"``: then ``parallel.comm`` stages
the card's tensors through host memory), which is how two ranks share
one card.  No backend or device is swapped silently: a failed init
raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from spmv_tpu_torch.models.device import DEVICE_ENV, default_device
from spmv_tpu_torch.parallel.mesh import AXIS_SHARDS, Mesh, make_mesh

__all__ = [
    "initialize_distributed",
    "is_multi_host",
    "global_mesh",
    "local_rows",
    "host_local_info",
]

# every collective of a group fails after this long rather than wait
# forever on a rank that raised before reaching it
TIMEOUT = datetime.timedelta(seconds=60)
# the device ``initialize_distributed`` chose for this process's rank
_device: Optional[torch.device] = None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def _rank_device(device, rank: int) -> torch.device:
    """The device rank ``rank`` runs on (see the module docstring)."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if os.environ.get(DEVICE_ENV, "").strip().lower() == "cpu":
        return torch.device("cpu")
    local = _env_int("LOCAL_RANK")
    local = rank if local is None else local
    visible = torch.cuda.device_count()
    if local >= visible:
        raise RuntimeError(
            f"local rank {local} has no card of its own ({visible} visible);"
            f" pass device= to share one, or set {DEVICE_ENV}=cpu to run on "
            "the CPU")
    return torch.device("cuda", local)


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> bool:
    """Join the ``torch.distributed`` job of ``world_size`` ranks as
    ``rank``, at ``init_method`` (``tcp://host:port`` or ``file://path``;
    default ``env://`` from ``MASTER_ADDR`` / ``MASTER_PORT``).

    Returns True when more than one process runs, False in a single
    process (also the no-op without arguments or environment).
    Idempotent.  The group's collectives time out after ``TIMEOUT``.
    """
    global _device
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = "env://"
    if init_method is None and world_size is None and rank is None:
        return False
    if init_method is None or world_size is None or rank is None:
        raise ValueError(
            "initialize_distributed needs an address, a world size and a "
            f"rank; got init_method={init_method!r}, world_size="
            f"{world_size}, rank={rank}")
    dev = _rank_device(device, rank)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device; the CPU "
                         "runs on gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)
    _device = dev
    return world_size > 1


def is_multi_host() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(num_shards: Optional[int] = None) -> Mesh:
    """A 1-D mesh of ``num_shards`` shards (default one a rank) over every
    rank of the job, rank r holding shards [r s, (r + 1) s) on its
    device, s = num_shards / world_size.  Without an initialized job, a
    single-process mesh of virtual shards on ``default_device()``."""
    if not dist.is_initialized():
        return make_mesh(num_shards or 1,
                         devices=[default_device()] * (num_shards or 1))
    world, rank = dist.get_world_size(), dist.get_rank()
    num_shards = world if num_shards is None else int(num_shards)
    here = _device if _device is not None else _rank_device(None, rank)
    names = [None] * world
    dist.all_gather_object(names, str(here))
    # shard p lies on rank p * world // P (Mesh refuses an uneven split)
    devices = tuple(torch.device(names[p * world // num_shards])
                    for p in range(num_shards))
    return Mesh(devices, AXIS_SHARDS, world_size=world, rank=rank,
                group=dist.group.WORLD)


def local_rows(arr, mesh: Mesh) -> torch.Tensor:
    """This rank's shards' rows of a host array stacked over the mesh's
    shards (axis 0 of length P), on its device: every rank passes the
    same array.  On a single-process mesh, every row."""
    arr = np.asarray(arr)
    if arr.shape[0] != mesh.size:
        raise ValueError(f"{arr.shape[0]} rows for a mesh of {mesh.size} "
                         "shards")
    lo, hi = mesh.local_shards.start, mesh.local_shards.stop
    return torch.from_numpy(np.ascontiguousarray(arr[lo:hi])).to(mesh.device)


def host_local_info() -> dict:
    """JSON-able description of this process's place in the job (JAX's
    keys; a rank holds one device)."""
    if not dist.is_initialized():
        local = (torch.cuda.device_count()
                 if default_device().type == "cuda" else 1)
        return {"process_index": 0, "process_count": 1,
                "local_device_count": local, "global_device_count": local}
    world = dist.get_world_size()
    return {"process_index": dist.get_rank(), "process_count": world,
            "local_device_count": 1, "global_device_count": world}

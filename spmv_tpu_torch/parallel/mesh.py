"""The mesh of shards.

The counterpart of ``spmv_tpu/parallel/mesh.py``.  The JAX package runs
one ``shard_map`` over a 1-D ``Mesh`` of devices: its tests make it out
of 8 virtual CPU devices in one process, and after
``initialize_distributed`` the same mesh spans processes.  A port
``Mesh`` is the tuple of ``torch.device``s the P shards run on, one
entry a shard, and the processes that hold them:

- a single-process mesh (``make_mesh``, ``group`` None): every entry is
  one device, and the P shards are virtual, as the JAX tests' CPU
  devices are.  The sharded paths keep every shard's arrays on that
  device and launch one kernel a shard; their collectives are views and
  gathers of one stacked tensor;
- a process mesh (``distributed.global_mesh``): ``world_size``
  ``torch.distributed`` ranks of the group ``group``, rank r holding the
  contiguous block of ``shards_per_rank`` shards ``local_shards`` on its
  own device, process 0's first, as a JAX global mesh lists process 0's
  devices first.  Its exchanges are real collectives (``parallel.comm``).

A single-process mesh over distinct devices is refused (``MeshError``):
the port places several GPUs through one process a GPU
(``global_mesh``), not through one controller, a stated deviation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from spmv_tpu_torch.errors import SpmvError

__all__ = ["Mesh", "MeshError", "make_mesh", "mesh_info", "AXIS_SHARDS"]

AXIS_SHARDS = "shards"


class MeshError(SpmvError):
    """A mesh the port cannot run yet."""


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: ``devices[p]`` holds shard p's arrays; rank ``rank`` of
    ``world_size`` in ``group`` (None in one process) holds shards
    ``local_shards``."""

    devices: tuple
    axis_name: str = AXIS_SHARDS
    world_size: int = 1
    rank: int = 0
    group: object = None

    def __post_init__(self):
        if self.world_size < 1 or not 0 <= self.rank < self.world_size:
            raise MeshError(f"rank {self.rank} of world size "
                            f"{self.world_size}")
        if self.size % self.world_size:
            raise MeshError(
                f"{self.size} shards do not split evenly over "
                f"{self.world_size} processes")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shards_per_rank(self) -> int:
        return self.size // self.world_size

    @property
    def local_shards(self) -> range:
        """The shards this process holds."""
        s = self.shards_per_rank
        return range(self.rank * s, (self.rank + 1) * s)

    @property
    def device(self) -> torch.device:
        """The device this process's shards lie on."""
        return self.devices[self.local_shards.start]


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as the tensors made on it name it: ``cuda:<current>``."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(
    num_shards: Optional[int] = None,
    devices: Optional[Sequence] = None,
    axis_name: str = AXIS_SHARDS,
) -> Mesh:
    """A single-process 1-D mesh over ``num_shards`` devices (default:
    every visible CUDA device).  ``devices=[dev] * P`` makes P virtual
    shards on one device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    if num_shards is None:
        num_shards = len(devices)
    if num_shards > len(devices):
        raise ValueError(
            f"requested {num_shards} shards but only "
            f"{len(devices)} devices are available"
        )
    devices = tuple(devices[:num_shards])
    if len(set(devices)) > 1:
        raise MeshError(
            f"a single-process mesh over distinct devices "
            f"({sorted(map(str, set(devices)))}) is not supported by "
            "spmv_tpu_torch: run one process a GPU and build the mesh with "
            "parallel.global_mesh, or pass one device for every shard "
            "(virtual shards); see ROADMAP.md, Queue 3")
    return Mesh(devices, axis_name)


def mesh_info(mesh: Mesh) -> dict:
    """JSON-able description of the mesh (for reports)."""
    kinds = {torch.cuda.get_device_name(d) if d.type == "cuda" else d.type
             for d in mesh.devices}
    return {
        "axis_names": [mesh.axis_name],
        "shape": {mesh.axis_name: mesh.size},
        "num_devices": mesh.size,
        "device_kinds": sorted(kinds),
        "num_processes": mesh.world_size,
    }

"""The mesh of shards.

The counterpart of ``spmv_tpu/parallel/mesh.py``.  The JAX package is
single-controller: one ``shard_map`` over a 1-D ``Mesh`` of devices,
which its tests make out of 8 virtual CPU devices in one process.  The
port keeps that shape.  A ``Mesh`` is the tuple of ``torch.device``s the
shards run on, one entry a shard; the entries may repeat one device, and
then the P shards are virtual, as the JAX tests' CPU devices are.  The
sharded paths (``parallel.shard``, ``dia_shard``, ``halo_shard``) keep
every shard's arrays on its device and launch one kernel a shard.

A mesh over distinct devices is refused (``MeshError``): placing shards
on several GPUs, and the multi-process ``torch.distributed`` bootstrap,
are still to port (ROADMAP.md, Queue 1).
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
    """A 1-D mesh: ``devices[p]`` holds shard p's arrays."""

    devices: tuple
    axis_name: str = AXIS_SHARDS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every shard lies on."""
        return self.devices[0]


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
    """A 1-D mesh over ``num_shards`` devices (default: every visible
    CUDA device).  ``devices=[dev] * P`` makes P virtual shards on one
    device."""
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
            f"a mesh over distinct devices ({sorted(map(str, set(devices)))})"
            " is not yet ported to spmv_tpu_torch; pass one device for every"
            " shard (virtual shards), see ROADMAP.md")
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
        "num_processes": 1,
    }

"""Analytic scaling model for the sharded SpMV over several H100s.

The counterpart of ``spmv_tpu/perfmodel/scaling.py``, priced for the
card.  Only one card is reachable where the port is measured, so
multi-card behaviour is (a) checked functionally on a mesh of virtual
shards on one device (``parallel``) and (b) predicted by this model.  It
prices one sharded SpMV step a shard:

- local time: the shard's share of matrix and vector bytes at the triad
  rate measured on the device (``perfmodel.machine.measured_machine``),
  which already is what device memory delivers to a streaming kernel,
  so no efficiency factor is applied on top;
- communication time over NVLink 4: the H100 SXM data sheet's 900 GB/s
  counts both directions of a card's links, so a shard's received halo
  is priced at half of it, 450 GB/s, times an ASSUMED efficiency
  (``INTERCONNECT_EFFICIENCY``): no second card is reachable, so it
  cannot be measured.  The report prints the efficiency at which the
  weak-scaling claim would fail (``interconnect_efficiency_breakeven``)
  beside the assumption, as the JAX report does for ICI;
  * DIA halo exchange: 2 * halo elements to the nearest neighbours;
  * ragged halo (the CSR halo path): the exchanged element count;
  * all-gather: (P-1)/P of the global x a shard;
- overlap: the halo paths may compute their interior while the halos
  travel, so their step is max(local, comm); the all-gather path
  gathers before it computes (sum).

Weak scaling holds rows a shard fixed as P grows; the efficiency is
t(1 shard) / t(P shards) for the same work a shard.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from spmv_tpu_torch.perfmodel.machine import GpuMachineModel, measured_machine

__all__ = ["SpmvScalingModel", "spmv_scaling_model", "NVLINK"]

# NVIDIA H100 SXM data sheet: NVLink 4, 18 links, 900 GB/s a card, the
# sum of both directions.  A halo a shard receives uses one direction.
NVLINK = {
    "name": "NVLink 4 (H100 SXM data sheet)",
    "gbps_both_directions": 900.0,
    "gbps_per_direction": 450.0,
}
# The fraction of the NVLink rate small halo messages reach.  ASSUMED,
# not measured (one card): the same figure the JAX model assumes for ICI.
INTERCONNECT_EFFICIENCY = 0.70
# BASELINE.json's north star: >= 80% weak-scaling nnz/s efficiency.
WEAK_SCALING_TARGET = 0.80


@dataclasses.dataclass(frozen=True)
class SpmvScalingModel:
    num_shards: int
    rows_per_shard: int
    comm_bytes_per_shard: int
    t_local_s: float
    t_comm_s: float
    t_step_s: float
    weak_efficiency: float     # vs the 1-shard step on the same block
    # Smallest interconnect efficiency at which weak_efficiency still
    # meets WEAK_SCALING_TARGET; 0.0 when there is no communication.
    interconnect_efficiency_breakeven: float = 0.0
    # the measured triad rate over the data sheet's HBM rate (None where
    # the machine has no data sheet: a CPU run)
    hbm_efficiency_measured: Optional[float] = None
    interconnect: dict = dataclasses.field(
        default_factory=lambda: dict(NVLINK))

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["interconnect_efficiency_assumed"] = INTERCONNECT_EFFICIENCY
        d["weak_scaling_target"] = WEAK_SCALING_TARGET
        return d


def spmv_scaling_model(
    num_shards: int,
    rows_per_shard: int,
    num_diagonals: int = 5,
    halo: int = 4096,
    value_bytes: int = 4,
    scheme: str = "dia-halo",
    machine: Optional[GpuMachineModel] = None,
    overlap: bool = True,
) -> SpmvScalingModel:
    """Model one sharded SpMV step.

    scheme: "dia-halo" (two halo strips of ``halo`` elements),
    "ragged-halo" (the CSR halo path: pass the exchanged element count a
    shard as ``halo``) or "all-gather" (the stacked x gathered from every
    shard).  ``machine`` defaults to the triad measured on the default
    device.
    """
    if machine is None:
        from spmv_tpu_torch.models.device import default_device

        machine = measured_machine(default_device())
    hbm = machine.hbm_gbps * 1e9
    link_peak = NVLINK["gbps_per_direction"] * 1e9
    link = link_peak * INTERCONNECT_EFFICIENCY

    local_bytes = (num_diagonals + 2) * value_bytes * rows_per_shard
    t_local = local_bytes / hbm

    if scheme == "dia-halo":
        comm_bytes = 2 * halo * value_bytes if num_shards > 1 else 0
    elif scheme == "ragged-halo":
        comm_bytes = halo * value_bytes if num_shards > 1 else 0
    elif scheme == "all-gather":
        comm_bytes = (
            (num_shards - 1) * rows_per_shard * value_bytes
            if num_shards > 1 else 0
        )
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    t_comm = comm_bytes / link

    overlapped = overlap and scheme in ("dia-halo", "ragged-halo")
    t_step = max(t_local, t_comm) if overlapped else t_local + t_comm

    # Sensitivity of the weak-scaling claim to the unmeasured efficiency
    # e, with t_comm(e) = comm / (link_peak * e):
    #   overlapped:  eff = t_local / max(t_local, t_comm(e)) >= target
    #                 <=> e >= target * comm / (link_peak * t_local)
    #   serialized:  eff = t_local / (t_local + t_comm(e)) >= target
    #                 <=> e >= target * comm
    #                          / (link_peak * t_local * (1 - target))
    if comm_bytes == 0 or t_local == 0:
        breakeven = 0.0
    elif overlapped:
        breakeven = WEAK_SCALING_TARGET * comm_bytes / (link_peak * t_local)
    else:
        breakeven = (WEAK_SCALING_TARGET * comm_bytes
                     / (link_peak * t_local * (1.0 - WEAK_SCALING_TARGET)))

    sheet = machine.datasheet_hbm_gbps
    return SpmvScalingModel(
        num_shards=num_shards,
        rows_per_shard=rows_per_shard,
        comm_bytes_per_shard=comm_bytes,
        t_local_s=t_local,
        t_comm_s=t_comm,
        t_step_s=t_step,
        weak_efficiency=t_local / t_step if t_step else 1.0,
        interconnect_efficiency_breakeven=breakeven,
        hbm_efficiency_measured=machine.hbm_gbps / sheet if sheet else None,
    )

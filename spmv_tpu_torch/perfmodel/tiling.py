"""TPU HBM<->VMEM tiling and roofline model.

The TPU-native replacement for LRU cache simulation (SURVEY.md section
7, step 4): on TPU there is no transparent cache to simulate — data
movement is explicit, deterministic DMA between HBM and VMEM.  For a
given (matrix, format, tiling, machine model) this module computes
*analytically*:

- the HBM traffic lower bound (matrix streamed once, x gathered with
  whatever block reuse the VMEM budget allows, y written once),
- the achieved-traffic estimate for a concrete tiling (row tiles x
  column blocks: every column block resident while a row tile is
  processed must be re-fetched per row tile unless it fits VMEM),
- the roofline (speed-of-light) time = max(bytes / HBM bandwidth,
  flops / peak flops) — SpMV is always bandwidth-bound, and
- per-shard local vs remote (ICI) bytes under a row partition — the
  TPU analogue of the reference's per-thread x per-NUMA-domain miss
  matrices.

Everything is a pure host-side function, unit-tested with
hand-computable cases, exactly like the reference's simulator tests
(test_replacement.cpp).

The port's copy of ``spmv_tpu/perfmodel/tiling.py``: the same code,
importing the port's copies instead of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from spmv_tpu_torch.models.csr import CsrMatrix

__all__ = [
    "TpuMachineModel",
    "spmv_traffic_model",
    "roofline_time",
    "TPU_V5E",
    "TPU_V5P",
]


@dataclasses.dataclass(frozen=True)
class TpuMachineModel:
    """Per-chip machine model — the TPU analogue of the reference's
    JSON trace config {caches, numa domains, threads}
    (SURVEY.md section 5 "Config").
    """

    name: str
    hbm_bytes: int
    hbm_gbps: float            # HBM bandwidth, GB/s
    vmem_bytes: int
    peak_flops_f32: float      # per chip
    peak_flops_bf16: float
    ici_gbps_per_link: float   # per direction per link
    ici_links: int
    lane: int = 128
    sublane: int = 8
    # Fast-buffer residency (measured, probe 33): buffers whose total
    # footprint stays under this budget can be kept entirely on-chip
    # across chained kernel invocations (XLA places small donated
    # HLO buffers in VMEM), so they never cross the HBM pins.  An
    # in-place r+w sweep over a resident buffer sustains
    # ``resident_gbps`` aggregate (~8x HBM); the cliff to HBM speed
    # sits between 96 and 128 MB on the measured chip — 96 MB is the
    # conservative budget.  0 = no residency modeling.
    resident_bytes: int = 0
    resident_gbps: float = 0.0
    # Measured same-buffer read+write aggregate (probe 31b): streams
    # that read and write the same HBM buffer (in-place chained
    # kernels) move at this rate, not at the read-only pin rate;
    # cross-buffer r+w is slower still (~330 GB/s measured).  0 =
    # price r+w streams at hbm_gbps.
    hbm_rw_gbps: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# Public specs (cloud.google.com/tpu/docs/system-architecture);
# residency numbers measured on the target chip (probes 30-33 in
# experiments/RESULTS.md): working sets <= 96 MB sustain ~6.4 TB/s
# r+w and never touch HBM, the cliff to ~640 GB/s sits by 128 MB.
TPU_V5E = TpuMachineModel(
    name="tpu-v5e",
    hbm_bytes=16 * 1024**3,
    hbm_gbps=819.0,
    vmem_bytes=128 * 1024**2,
    peak_flops_f32=98.3e12 / 2,  # bf16 peak halved for fp32 inputs
    peak_flops_bf16=197e12,
    ici_gbps_per_link=400.0,
    ici_links=4,
    resident_bytes=96 * 1024**2,
    resident_gbps=6400.0,
    hbm_rw_gbps=650.0,
)

TPU_V5P = TpuMachineModel(
    name="tpu-v5p",
    hbm_bytes=95 * 1024**3,
    hbm_gbps=2765.0,
    vmem_bytes=128 * 1024**2,
    peak_flops_f32=459e12 / 2,
    peak_flops_bf16=459e12,
    ici_gbps_per_link=600.0,
    ici_links=6,
)


@dataclasses.dataclass(frozen=True)
class SpmvTraffic:
    """Byte accounting for one SpMV on one chip."""

    matrix_bytes: int          # indices + values streamed once
    x_bytes_lower_bound: int   # every referenced x element once
    x_bytes_tiled: int         # under the concrete tiling
    y_bytes: int
    total_lower_bound: int
    total_tiled: int
    flops: int
    reuse_factor: float        # x_lower / x_tiled

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def spmv_traffic_model(
    m: CsrMatrix,
    value_bytes: int = 4,
    index_bytes: int = 4,
    row_tile: int = 512,
    machine: Optional[TpuMachineModel] = None,
) -> SpmvTraffic:
    """Traffic model for a row-tiled CSR/ELL-style SpMV.

    Lower bound: A streamed once (stored entries x (index+value) bytes,
    plus row structure), each *distinct referenced* x element fetched
    once, y written once.

    Tiled estimate: x is fetched at cache-line-free granularity but a
    column is re-fetched once per row tile that references it; if ALL
    of x fits in the VMEM budget (minus double-buffered tile space),
    it is fetched exactly once.
    """
    machine = machine or TPU_V5E
    stored = int(m.row_ptr[-1])
    matrix_bytes = stored * (value_bytes + index_bytes) + (
        m.num_rows + 1
    ) * index_bytes
    y_bytes = m.num_rows * value_bytes

    distinct_cols = np.unique(m.column_index)
    x_lower = int(distinct_cols.size) * value_bytes

    x_size_bytes = m.num_columns * value_bytes
    tile_budget = machine.vmem_bytes // 2  # double-buffered A tiles
    if x_size_bytes <= tile_budget:
        x_tiled = x_lower
    else:
        # Count (row_tile, distinct column) incidences.
        rows = np.repeat(
            np.arange(m.num_rows, dtype=np.int64), np.diff(m.row_ptr)
        )
        tile_of_row = rows // row_tile
        key = tile_of_row * m.num_columns + m.column_index
        x_tiled = int(np.unique(key).size) * value_bytes

    flops = 2 * m.num_entries
    total_lb = matrix_bytes + x_lower + y_bytes
    total_tiled = matrix_bytes + x_tiled + y_bytes
    return SpmvTraffic(
        matrix_bytes=matrix_bytes,
        x_bytes_lower_bound=x_lower,
        x_bytes_tiled=x_tiled,
        y_bytes=y_bytes,
        total_lower_bound=total_lb,
        total_tiled=total_tiled,
        flops=flops,
        reuse_factor=(x_lower / x_tiled) if x_tiled else 1.0,
    )


def roofline_time(
    bytes_moved: int,
    flops: int,
    machine: Optional[TpuMachineModel] = None,
    dtype: str = "float32",
    resident_rw_bytes: int = 0,
    rw_bytes: int = 0,
) -> dict:
    """Speed-of-light time and the binding resource.

    ``bytes_moved`` is the HBM-streaming traffic (arrays touched once
    per pass whose footprint exceeds the residency budget).
    ``resident_rw_bytes`` is the read+write volume over buffers small
    enough to stay on-chip across chained invocations (see
    ``TpuMachineModel.resident_bytes``); it is priced at the measured
    resident bandwidth instead of HBM.  If the machine has no
    residency model — or the resident working set exceeds the budget —
    those bytes are folded into ``rw_bytes``: r+w traffic over one
    too-large buffer, priced at the measured same-buffer rate
    (``hbm_rw_gbps``) — the physically attainable rate for in-place
    streams, which the single pin-rate constant overstates.
    """
    machine = machine or TPU_V5E
    peak = (
        machine.peak_flops_bf16 if dtype == "bfloat16"
        else machine.peak_flops_f32
    )
    resident_ok = (
        machine.resident_bytes > 0
        and machine.resident_gbps > 0
        # r+w volume counts each pass over the buffer; the footprint
        # bound is conservative: half the r+w volume must fit.
        and resident_rw_bytes // 2 <= machine.resident_bytes
    )
    if resident_rw_bytes and not resident_ok:
        rw_bytes = rw_bytes + resident_rw_bytes
        resident_rw_bytes = 0
    rw_rate = machine.hbm_rw_gbps or machine.hbm_gbps
    t_mem = bytes_moved / (machine.hbm_gbps * 1e9)
    if rw_bytes:
        t_mem += rw_bytes / (rw_rate * 1e9)
    if resident_rw_bytes:
        t_mem += resident_rw_bytes / (machine.resident_gbps * 1e9)
    t_cmp = flops / peak
    total_bytes = bytes_moved + rw_bytes + resident_rw_bytes
    return {
        "machine": machine.name,
        "bytes": bytes_moved,
        "rw_bytes": rw_bytes,
        "resident_rw_bytes": resident_rw_bytes,
        "flops": flops,
        "time_memory_bound_s": t_mem,
        "time_compute_bound_s": t_cmp,
        "time_roofline_s": max(t_mem, t_cmp),
        "bound": "memory" if t_mem >= t_cmp else "compute",
        "arithmetic_intensity": flops / total_bytes if total_bytes
        else 0.0,
    }

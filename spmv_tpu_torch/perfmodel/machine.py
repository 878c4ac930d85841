"""Machine model of the card the port runs on.

The counterpart of ``spmv_tpu.perfmodel.tiling.TpuMachineModel``, with
the fields ``spmv_tpu.perfmodel.tiling.roofline_time`` reads.  The
memory bandwidth is not taken from a data sheet: ``measured_machine``
times the port's triad (``a = b + q c``, two reads and one write per
element) over buffers far larger than the card's 50 MB L2, so the rate
is what device memory delivers to a streaming kernel.  SpMV is
memory-bound, so that rate prices the roofline; the flop peaks are
NVIDIA's data-sheet figures for the H100 SXM and only decide which
bound is reported.  No TPU figure appears here.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import torch

from spmv_tpu_torch.ops.triad import triad

__all__ = ["GpuMachineModel", "H100_SXM_DATASHEET", "measured_machine"]


@dataclasses.dataclass(frozen=True)
class GpuMachineModel:
    name: str                  # torch.cuda.get_device_name(), or "cpu"
    hbm_gbps: float            # measured triad rate, GB/s
    hbm_rw_gbps: float         # read+write streams: the same triad rate
    peak_flops_f32: float      # data sheet (inf on the CPU: not modeled)
    peak_flops_bf16: float
    resident_bytes: int = 0    # no on-chip residency model on the GPU
    resident_gbps: float = 0.0
    bandwidth_source: str = ""
    datasheet_hbm_gbps: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


# NVIDIA H100 SXM5 data sheet: 3.35 TB/s HBM3, 67 TFLOP/s fp32 (non
# tensor core), 989 TFLOP/s dense bf16 tensor core, at 700 W.
H100_SXM_DATASHEET = {
    "hbm_gbps": 3350.0,
    "peak_flops_f32": 67e12,
    "peak_flops_bf16": 989e12,
}

# Buffer lengths of the bandwidth probe.  On CUDA: three float32 buffers
# of 256 MiB each.  On the CPU (tests only) a small probe keeps the
# report's shape without a meaningful roofline.
_CUDA_ELEMENTS = 64 * 1024 * 1024
_CPU_ELEMENTS = 1 << 20


def _triad_seconds(n: int, device: torch.device, reps: int = 10,
                   runs: int = 5) -> float:
    b = torch.ones(n, dtype=torch.float32, device=device)
    c = torch.full((n,), 2.0, dtype=torch.float32, device=device)
    a = torch.empty_like(b)
    best = float("inf")
    for run in range(runs + 1):          # run 0 warms up
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                triad(b, c, 3.0, out=a)
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) * 1e-3 / reps
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                triad(b, c, 3.0, out=a)
            t = (time.perf_counter() - t0) / reps
        if run:
            best = min(best, t)
    return best


@functools.lru_cache(maxsize=None)
def _measure(device_str: str) -> GpuMachineModel:
    device = torch.device(device_str)
    cuda = device.type == "cuda"
    n = _CUDA_ELEMENTS if cuda else _CPU_ELEMENTS
    gbps = 3 * 4 * n / _triad_seconds(n, device) / 1e9
    if cuda:
        return GpuMachineModel(
            name=torch.cuda.get_device_name(device),
            hbm_gbps=gbps,
            hbm_rw_gbps=gbps,
            peak_flops_f32=H100_SXM_DATASHEET["peak_flops_f32"],
            peak_flops_bf16=H100_SXM_DATASHEET["peak_flops_bf16"],
            bandwidth_source=(
                f"triad over 3 x {4 * n >> 20} MiB float32 buffers, "
                "measured on this device; flop peaks: H100 SXM data "
                "sheet"),
            datasheet_hbm_gbps=H100_SXM_DATASHEET["hbm_gbps"],
        )
    return GpuMachineModel(
        name="cpu",
        hbm_gbps=gbps,
        hbm_rw_gbps=gbps,
        peak_flops_f32=float("inf"),
        peak_flops_bf16=float("inf"),
        bandwidth_source=(
            f"triad over 3 x {4 * n >> 20} MiB float32 buffers on the "
            "host (a CPU run: not a device figure)"),
    )


def measured_machine(device) -> GpuMachineModel:
    """The machine model of ``device``, measured once per process."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _measure(str(device))

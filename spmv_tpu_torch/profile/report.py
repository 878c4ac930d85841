"""Profiling report: the same JSON document as
``spmv_tpu/profile/report.py``, priced on the port's machine model.
"""

from __future__ import annotations

from typing import Optional

import torch

from spmv_tpu_torch.perfmodel.tiling import roofline_time
from spmv_tpu_torch.profile.capture import profiling_events_section
from spmv_tpu_torch.utils.sample import Sample, compute_sample

__all__ = ["profiling_report", "device_info"]


def device_info(device) -> dict:
    """``{"platform": "gpu" | "cpu", "device_kind": name}``."""
    device = torch.device(device)
    if device.type == "cuda":
        return {"platform": "gpu",
                "device_kind": torch.cuda.get_device_name(device)}
    return {"platform": device.type, "device_kind": device.type}


def profiling_report(
    kernel,
    runs_sample: Sample,
    seconds_per_iteration: float,
    num_runs: int,
    warmup: bool,
    machine,
    device,
    flush_caches: bool = False,
    trace_config=None,
    jax_profile_dir: Optional[str] = None,
    op_info: Optional[dict] = None,
    flops_per_run: Optional[int] = None,
    bytes_per_run: Optional[int] = None,
) -> dict:
    """Assemble the profiling JSON document.

    ``kernel`` is a ``spmv_tpu_torch.kernels`` kernel; ``machine`` the
    port's machine model (``spmv_tpu_torch.perfmodel.measured_machine``)
    and is required: no TPU model stands in for it.  ``jax_profile_dir``
    is the directory of a ``profile.capture.trace`` of the runs, whose
    summary fills ``profiling_events``.
    """
    flops = (flops_per_run if flops_per_run is not None
             else kernel.flops_per_run())
    if bytes_per_run is not None:
        nbytes = bytes_per_run
        stream, resident = nbytes, 0
    else:
        nbytes = kernel.bytes_per_run()
        stream, resident = kernel.traffic_split()
    dtype = ("bfloat16" if getattr(kernel, "dtype", None) == torch.bfloat16
             else "float32")
    roof = roofline_time(stream, flops, machine=machine, dtype=dtype,
                         resident_rw_bytes=resident)
    t = seconds_per_iteration
    return {
        "op": op_info or {"kind": "spmv"},
        "trace_config": (
            trace_config.to_json() if trace_config is not None else None
        ),
        "kernel": kernel.describe(),
        "warmup": bool(warmup),
        "flush_caches": bool(flush_caches),
        "runs": num_runs,
        "device": device_info(device),
        "jax_profile_dir": jax_profile_dir,
        # the device's events from the capture: the reference's
        # profiling_events section (profile-kernel.cpp:376-391) with
        # kernels in place of perf counter groups; None without one
        "profiling_events": profiling_events_section(jax_profile_dir),
        # wall times of the N whole runs in nanoseconds, the reference
        # tool's unit; the chained estimate below is the device time
        "execution_time": compute_sample(
            [s * 1e9 for s in runs_sample.values], unit="ns"
        ).to_json(),
        "device_seconds_per_iteration": t,
        "roofline": roof,
        "achieved": {
            "gflop_per_s": flops / t / 1e9,
            "gb_per_s_modeled": nbytes / t / 1e9,
            "fraction_of_roofline": roof["time_roofline_s"] / t,
        },
    }

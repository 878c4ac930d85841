"""Measured profiling: chained-step timing, the profiling report and the
traffic-split measurement (``measure_traffic_split``)."""

from spmv_tpu_torch.profile.harness import (
    KernelTiming,
    profile_kernel_fn,
    time_kernel,
)
from spmv_tpu_torch.profile.report import device_info, profiling_report
from spmv_tpu_torch.profile.traffic import measure_traffic_split

__all__ = ["KernelTiming", "time_kernel", "profile_kernel_fn",
           "profiling_report", "device_info", "measure_traffic_split"]

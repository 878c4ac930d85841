"""Measured profiling: chained-step timing and the profiling report."""

from spmv_tpu_torch.profile.harness import (
    KernelTiming,
    profile_kernel_fn,
    time_kernel,
)
from spmv_tpu_torch.profile.report import device_info, profiling_report

__all__ = ["KernelTiming", "time_kernel", "profile_kernel_fn",
           "profiling_report", "device_info"]

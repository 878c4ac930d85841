"""Measured profiling: chained-step timing, the profiler capture and its
summary, the profiling report and the traffic-split measurement
(``measure_traffic_split``)."""

from spmv_tpu_torch.profile.capture import (
    list_profile_events,
    op_bytes_accessed,
    profiling_events_section,
    summarize_capture,
)
from spmv_tpu_torch.profile.harness import (
    KernelTiming,
    cache_flusher,
    profile_kernel_fn,
    time_kernel,
)
from spmv_tpu_torch.profile.report import device_info, profiling_report
from spmv_tpu_torch.profile.traffic import measure_traffic_split

__all__ = ["KernelTiming", "time_kernel", "profile_kernel_fn",
           "cache_flusher", "profiling_report", "device_info",
           "measure_traffic_split", "summarize_capture",
           "profiling_events_section", "list_profile_events",
           "op_bytes_accessed"]

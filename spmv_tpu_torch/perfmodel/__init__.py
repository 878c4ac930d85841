"""The port's performance model: the card's machine model (its bandwidth
measured by the triad), and the port's copies of the JAX package's
roofline (``tiling.roofline_time``) and machine-config reader
(``trace_config.read_trace_config``)."""

from spmv_tpu_torch.perfmodel.machine import (
    H100_SXM_DATASHEET,
    GpuMachineModel,
    measured_machine,
)
from spmv_tpu_torch.perfmodel.tiling import roofline_time
from spmv_tpu_torch.perfmodel.trace_config import (
    TraceConfig,
    read_trace_config,
)

__all__ = ["GpuMachineModel", "H100_SXM_DATASHEET", "measured_machine",
           "roofline_time", "TraceConfig", "read_trace_config"]

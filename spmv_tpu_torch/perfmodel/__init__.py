"""The port's machine model.  Traffic accounting and the roofline itself
are shared: ``spmv_tpu.perfmodel.tiling.roofline_time``."""

from spmv_tpu_torch.perfmodel.machine import (
    H100_SXM_DATASHEET,
    GpuMachineModel,
    measured_machine,
)

__all__ = ["GpuMachineModel", "H100_SXM_DATASHEET", "measured_machine"]

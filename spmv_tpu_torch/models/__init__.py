"""Device containers of the port (the host formats stay in
``spmv_tpu.models``)."""

from spmv_tpu_torch.models.convert import (
    csr_from_spmv_tpu,
    dia_from_spmv_tpu,
    wellcw_from_spmv_tpu,
)
from spmv_tpu_torch.models.device import (
    DeviceCsr,
    DeviceCwLevel,
    DeviceCwMerged,
    DeviceCwPool,
    DeviceDia,
    DeviceWellCw,
    default_value_dtype,
)

__all__ = ["DeviceDia", "DeviceCsr", "DeviceWellCw", "DeviceCwLevel",
           "DeviceCwPool", "DeviceCwMerged", "default_value_dtype",
           "dia_from_spmv_tpu", "csr_from_spmv_tpu", "wellcw_from_spmv_tpu"]

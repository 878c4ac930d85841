"""Device containers of the port (the host formats stay in
``spmv_tpu.models``)."""

from spmv_tpu_torch.models.convert import dia_from_spmv_tpu
from spmv_tpu_torch.models.device import DeviceDia, default_value_dtype

__all__ = ["DeviceDia", "default_value_dtype", "dia_from_spmv_tpu"]

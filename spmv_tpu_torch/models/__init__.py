"""Matrix formats of the port.

- Host formats (numpy), the port's copies of the JAX package's:
  ``CsrMatrix``, ``DiaMatrix``, ``WellCwMatrix``, ``WellMatrix`` and
  ``BsrMatrix``, with their packers, the ``reorder`` orders that
  ``load_matrix``'s ``__RCM`` / ``__GP<n>`` suffixes apply, and
  ``auto_format``, the format selection.
- Device containers (``nn.Module`` with buffers): ``DeviceDia``,
  ``DeviceCsr``, ``DeviceWellCw``, ``DeviceWell`` and ``DeviceBsr``, and
  the converters from the JAX package's containers.
"""

from spmv_tpu_torch.models.bsr import BsrMatrix
from spmv_tpu_torch.models.convert import (
    bsr_from_spmv_tpu,
    csr_from_spmv_tpu,
    dia_from_spmv_tpu,
    well_from_spmv_tpu,
    wellcw_from_spmv_tpu,
)
from spmv_tpu_torch.models.csr import CsrMatrix
from spmv_tpu_torch.models.device import (
    DeviceBsr,
    DeviceCsr,
    DeviceCwLevel,
    DeviceCwMerged,
    DeviceCwPool,
    DeviceDia,
    DeviceWell,
    DeviceWellCw,
    default_value_dtype,
)
from spmv_tpu_torch.models.dia import DiaMatrix
from spmv_tpu_torch.models.select import auto_format
from spmv_tpu_torch.models.well import WellMatrix
from spmv_tpu_torch.models.wellcw import WellCwMatrix

__all__ = ["CsrMatrix", "DiaMatrix", "WellCwMatrix", "WellMatrix",
           "BsrMatrix", "auto_format", "DeviceDia", "DeviceCsr",
           "DeviceWellCw", "DeviceWell", "DeviceBsr", "DeviceCwLevel",
           "DeviceCwPool", "DeviceCwMerged", "default_value_dtype",
           "dia_from_spmv_tpu", "csr_from_spmv_tpu", "wellcw_from_spmv_tpu",
           "well_from_spmv_tpu", "bsr_from_spmv_tpu"]

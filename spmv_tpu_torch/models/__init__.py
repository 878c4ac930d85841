"""Matrix formats of the port.

- Host formats (numpy), the port's copies of the JAX package's:
  ``CsrMatrix``, ``DiaMatrix``, ``WellCwMatrix`` and ``WellMatrix``, with
  their packers, and the ``reorder`` orders that ``load_matrix``'s
  ``__RCM`` / ``__GP<n>`` suffixes apply.
- Device containers (``nn.Module`` with buffers): ``DeviceDia``,
  ``DeviceCsr``, ``DeviceWellCw`` and ``DeviceWell``, and the converters
  from the JAX package's containers.
"""

from spmv_tpu_torch.models.convert import (
    csr_from_spmv_tpu,
    dia_from_spmv_tpu,
    well_from_spmv_tpu,
    wellcw_from_spmv_tpu,
)
from spmv_tpu_torch.models.csr import CsrMatrix
from spmv_tpu_torch.models.device import (
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
from spmv_tpu_torch.models.well import WellMatrix
from spmv_tpu_torch.models.wellcw import WellCwMatrix

__all__ = ["CsrMatrix", "DiaMatrix", "WellCwMatrix", "WellMatrix",
           "DeviceDia", "DeviceCsr", "DeviceWellCw", "DeviceWell",
           "DeviceCwLevel", "DeviceCwPool", "DeviceCwMerged",
           "default_value_dtype", "dia_from_spmv_tpu", "csr_from_spmv_tpu",
           "wellcw_from_spmv_tpu", "well_from_spmv_tpu"]

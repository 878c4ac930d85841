"""Matrix formats of the port.

- Host formats (numpy), the port's copies of the JAX package's:
  ``CooMatrix``, ``CsrMatrix``, ``EllMatrix`` (and ``ELL_PAD_SENTINEL``),
  ``HybridMatrix``, ``DiaMatrix``, ``WellCwMatrix``, ``WellMatrix`` and
  ``BsrMatrix``, with their packers, the ``reorder`` orders that
  ``load_matrix``'s ``__RCM`` / ``__GP<n>`` suffixes apply, and
  ``auto_format``, the format selection, and the row partitioners of
  the sharded paths (``partition``).
- Device containers (``nn.Module`` with buffers): ``DeviceDia``,
  ``DeviceCsr``, ``DeviceEll``, ``DeviceHybrid``, ``DeviceSparseCsr``,
  ``DeviceWellCw``, ``DeviceWell`` and ``DeviceBsr``,
  ``device_put_matrix``, and the converters from the JAX package's
  containers.
"""

from spmv_tpu_torch.models.bsr import BsrMatrix
from spmv_tpu_torch.models.convert import (
    bsr_from_spmv_tpu,
    csr_from_spmv_tpu,
    dia_from_spmv_tpu,
    ell_from_spmv_tpu,
    hybrid_from_spmv_tpu,
    well_from_spmv_tpu,
    wellcw_from_spmv_tpu,
)
from spmv_tpu_torch.models.coo import CooMatrix
from spmv_tpu_torch.models.csr import CsrMatrix
from spmv_tpu_torch.models.device import (
    DeviceBsr,
    DeviceCsr,
    DeviceCwLevel,
    DeviceCwMerged,
    DeviceCwPool,
    DeviceDia,
    DeviceEll,
    DeviceHybrid,
    DeviceSparseCsr,
    DeviceWell,
    DeviceWellCw,
    default_value_dtype,
    device_put_matrix,
)
from spmv_tpu_torch.models.dia import DiaMatrix
from spmv_tpu_torch.models.ell import ELL_PAD_SENTINEL, EllMatrix
from spmv_tpu_torch.models.hybrid import HybridMatrix
from spmv_tpu_torch.models.partition import (
    nnz_per_part,
    partition_bounds_to_sizes,
    rows_partition_balanced_nnz,
    rows_partition_equal,
)
from spmv_tpu_torch.models.select import auto_format
from spmv_tpu_torch.models.well import WellMatrix
from spmv_tpu_torch.models.wellcw import WellCwMatrix

__all__ = ["CooMatrix", "CsrMatrix", "EllMatrix", "HybridMatrix",
           "ELL_PAD_SENTINEL", "DiaMatrix", "WellCwMatrix", "WellMatrix",
           "BsrMatrix", "auto_format", "DeviceDia", "DeviceCsr", "DeviceEll",
           "DeviceHybrid", "DeviceSparseCsr", "DeviceWellCw", "DeviceWell",
           "DeviceBsr", "DeviceCwLevel", "DeviceCwPool", "DeviceCwMerged",
           "default_value_dtype", "device_put_matrix", "dia_from_spmv_tpu",
           "csr_from_spmv_tpu", "ell_from_spmv_tpu", "hybrid_from_spmv_tpu",
           "wellcw_from_spmv_tpu", "well_from_spmv_tpu", "bsr_from_spmv_tpu",
           "rows_partition_equal", "rows_partition_balanced_nnz",
           "partition_bounds_to_sizes", "nnz_per_part"]

"""Compute layer of the port: DIA, WELL-CW and CSR SpMV and SpMM, WELL
SpMV (plain versions and CUDA kernel wrappers), the triad, and conjugate
gradient (single and batched multi-RHS)."""

from spmv_tpu_torch.ops.csr_kernels import (
    csr_spmm,
    csr_spmm_core,
    csr_spmv,
    csr_spmv_core,
)
from spmv_tpu_torch.ops.dia_kernels import (
    dia_spmm,
    dia_spmm_core,
    dia_spmv,
    dia_spmv_core,
)
from spmv_tpu_torch.ops.solvers import (
    BatchedCgResult,
    CgResult,
    batched_conjugate_gradient,
    conjugate_gradient,
    dia_batched_conjugate_gradient,
    dia_conjugate_gradient,
    extract_diagonal,
    jacobi_preconditioner,
    preconditioned_conjugate_gradient,
)
from spmv_tpu_torch.ops.spmv import (
    csr_spmv_reference,
    cw_level_reference,
    cw_merged_reference,
    cw_pool_reference,
    dia_spmm_reference,
    dia_spmv_reference,
    well_chunks_reference,
    well_spmv_reference,
    wellcw_spmv_reference,
)
from spmv_tpu_torch.ops.well_kernels import (
    well_seg_core,
    well_spmv,
    well_spmv_core,
    well_whole_core,
)
from spmv_tpu_torch.ops.wellcw_kernels import (
    wellcw_level_core,
    wellcw_level_spmm_core,
    wellcw_merged_core,
    wellcw_merged_spmm_core,
    wellcw_pool_core,
    wellcw_pool_spmm_core,
    wellcw_spmm,
    wellcw_spmm_core,
    wellcw_spmv,
    wellcw_spmv_core,
)
# after the ``ops.spmv`` submodule import, so that ``ops.spmv`` names the
# function, as in ``spmv_tpu.ops``
from spmv_tpu_torch.ops.dispatch import spmm, spmv
from spmv_tpu_torch.ops.triad import triad

__all__ = [
    "spmv",
    "spmm",
    "dia_spmv",
    "dia_spmv_core",
    "dia_spmm",
    "dia_spmm_core",
    "dia_spmv_reference",
    "dia_spmm_reference",
    "wellcw_spmv",
    "wellcw_spmv_core",
    "wellcw_merged_core",
    "wellcw_level_core",
    "wellcw_pool_core",
    "wellcw_spmm",
    "wellcw_spmm_core",
    "wellcw_merged_spmm_core",
    "wellcw_level_spmm_core",
    "wellcw_pool_spmm_core",
    "wellcw_spmv_reference",
    "cw_merged_reference",
    "cw_level_reference",
    "cw_pool_reference",
    "well_spmv",
    "well_spmv_core",
    "well_whole_core",
    "well_seg_core",
    "well_chunks_reference",
    "well_spmv_reference",
    "csr_spmv",
    "csr_spmv_core",
    "csr_spmv_reference",
    "csr_spmm",
    "csr_spmm_core",
    "triad",
    "CgResult",
    "BatchedCgResult",
    "conjugate_gradient",
    "batched_conjugate_gradient",
    "dia_batched_conjugate_gradient",
    "preconditioned_conjugate_gradient",
    "dia_conjugate_gradient",
    "jacobi_preconditioner",
    "extract_diagonal",
]

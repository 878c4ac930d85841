"""Compute layer of the port: DIA, WELL-CW and CSR SpMV, DIA SpMM (plain
versions and CUDA kernel wrappers), the triad, and conjugate gradient."""

from spmv_tpu_torch.ops.csr_kernels import csr_spmv, csr_spmv_core
from spmv_tpu_torch.ops.dia_kernels import (
    dia_spmm,
    dia_spmm_core,
    dia_spmv,
    dia_spmv_core,
)
from spmv_tpu_torch.ops.solvers import (
    CgResult,
    conjugate_gradient,
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
    wellcw_spmv_reference,
)
from spmv_tpu_torch.ops.wellcw_kernels import (
    wellcw_level_core,
    wellcw_merged_core,
    wellcw_pool_core,
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
    "wellcw_spmv_reference",
    "cw_merged_reference",
    "cw_level_reference",
    "cw_pool_reference",
    "csr_spmv",
    "csr_spmv_core",
    "csr_spmv_reference",
    "triad",
    "CgResult",
    "conjugate_gradient",
    "preconditioned_conjugate_gradient",
    "dia_conjugate_gradient",
    "jacobi_preconditioner",
    "extract_diagonal",
]

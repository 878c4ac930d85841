"""Compute layer of the port: DIA SpMV / SpMM (plain versions and CUDA
kernel wrappers), the triad, and conjugate gradient."""

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
from spmv_tpu_torch.ops.spmv import dia_spmm_reference, dia_spmv_reference
# after the ``ops.spmv`` submodule import, so that ``ops.spmv`` names the
# function, as in ``spmv_tpu.ops``
from spmv_tpu_torch.ops.dia_kernels import spmm, spmv
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
    "triad",
    "CgResult",
    "conjugate_gradient",
    "preconditioned_conjugate_gradient",
    "dia_conjugate_gradient",
    "jacobi_preconditioner",
    "extract_diagonal",
]

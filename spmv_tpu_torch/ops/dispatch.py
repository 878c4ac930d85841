"""The port's one-shot ``spmv`` and ``spmm``, named as in
``spmv_tpu.ops``: they pick the wrapper by container type, and the
wrapper picks the kernel (CUDA tensor) or its plain version (CPU
tensor).  A ``DeviceSparseCsr`` (``-s xla-csr``) takes the vendor
library's product through ``sparse_csr_core``, on either device."""

from __future__ import annotations

import torch

from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.models.device import (
    DeviceBsr,
    DeviceCsr,
    DeviceDia,
    DeviceEll,
    DeviceHybrid,
    DeviceSparseCsr,
    DeviceWell,
    DeviceWellCw,
)
from spmv_tpu_torch.ops.bsr_kernels import bsr_spmm, bsr_spmv
from spmv_tpu_torch.ops.csr_kernels import csr_spmm, csr_spmv
from spmv_tpu_torch.ops.dia_kernels import dia_spmm, dia_spmv
from spmv_tpu_torch.ops.ell_kernels import (
    ell_spmm,
    ell_spmv,
    hybrid_spmm,
    hybrid_spmv,
)
from spmv_tpu_torch.ops.well_kernels import well_spmm, well_spmv
from spmv_tpu_torch.ops.wellcw_kernels import wellcw_spmm, wellcw_spmv

__all__ = ["spmv", "spmm", "sparse_csr_core"]


def sparse_csr_core(A: DeviceSparseCsr, v: torch.Tensor,
                    out: torch.Tensor = None) -> torch.Tensor:
    """A @ v through ``torch.sparse`` (cuSPARSE on the card) for v of
    shape (m,) or (m, k), into ``out`` where given: the comparison
    kernel of ``-s xla-csr``, which no other path calls."""
    v = v.to(A.matrix.dtype)
    if v.dim() == 1:
        return torch.mv(A.matrix, v, out=out)
    return torch.mm(A.matrix, v, out=out)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a ``DeviceDia`` (K1), ``DeviceWellCw`` (K3a-c and
    the CSR remainder), ``DeviceWell`` (K5a or K5b and the CSR spill: the
    JAX package's ``fast_spmv`` for WELL), ``DeviceBsr`` (K7 on one
    column, as JAX's ``spmv`` on BSR), ``DeviceCsr`` (COO too),
    ``DeviceEll``, ``DeviceHybrid`` (the ELL kernel, then the CSR kernel
    on the COO part) or ``DeviceSparseCsr`` (``torch.sparse``)."""
    if isinstance(A, DeviceDia):
        return dia_spmv(A, x)
    if isinstance(A, DeviceWellCw):
        return wellcw_spmv(A, x)
    if isinstance(A, DeviceWell):
        return well_spmv(A, x)
    if isinstance(A, DeviceBsr):
        return bsr_spmv(A, x)
    if isinstance(A, DeviceCsr):
        return csr_spmv(A, x)
    if isinstance(A, DeviceEll):
        return ell_spmv(A, x)
    if isinstance(A, DeviceHybrid):
        return hybrid_spmv(A, x)
    if isinstance(A, DeviceSparseCsr):
        return sparse_csr_core(A, x)
    raise KernelError(f"spmv: no port for {type(A).__name__}")


def spmm(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for X of shape (num_columns, k): a ``DeviceDia`` (K2),
    ``DeviceWellCw`` (K4a-c and the CSR SpMM remainder), ``DeviceWell``
    (K6a or K6b and the CSR SpMM spill), ``DeviceBsr`` (K7; bf16 blocks
    give float32 Y), ``DeviceCsr``, ``DeviceEll``, ``DeviceHybrid`` or
    ``DeviceSparseCsr``."""
    if isinstance(A, DeviceDia):
        return dia_spmm(A, X)
    if isinstance(A, DeviceWellCw):
        return wellcw_spmm(A, X)
    if isinstance(A, DeviceWell):
        return well_spmm(A, X)
    if isinstance(A, DeviceBsr):
        return bsr_spmm(A, X)
    if isinstance(A, DeviceCsr):
        return csr_spmm(A, X)
    if isinstance(A, DeviceEll):
        return ell_spmm(A, X)
    if isinstance(A, DeviceHybrid):
        return hybrid_spmm(A, X)
    if isinstance(A, DeviceSparseCsr):
        return sparse_csr_core(A, X)
    raise KernelError(f"spmm: no port for {type(A).__name__}")

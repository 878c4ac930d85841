"""The port's one-shot ``spmv`` and ``spmm``, named as in
``spmv_tpu.ops``: they pick the wrapper by container type, and the
wrapper picks the kernel (CUDA tensor) or its plain version (CPU
tensor)."""

from __future__ import annotations

import torch

from spmv_tpu.errors import KernelError
from spmv_tpu_torch.models.device import DeviceCsr, DeviceDia, DeviceWellCw
from spmv_tpu_torch.ops.csr_kernels import csr_spmv
from spmv_tpu_torch.ops.dia_kernels import dia_spmm, dia_spmv
from spmv_tpu_torch.ops.wellcw_kernels import wellcw_spmv

__all__ = ["spmv", "spmm"]


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a ``DeviceDia`` (K1), ``DeviceWellCw`` (K3a-c and
    the CSR remainder) or ``DeviceCsr``."""
    if isinstance(A, DeviceDia):
        return dia_spmv(A, x)
    if isinstance(A, DeviceWellCw):
        return wellcw_spmv(A, x)
    if isinstance(A, DeviceCsr):
        return csr_spmv(A, x)
    raise KernelError(f"spmv: no port for {type(A).__name__}")


def spmm(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a ``DeviceDia`` (K2); the WELL-CW SpMM (K4) and the
    other formats are not ported yet."""
    if isinstance(A, DeviceDia):
        return dia_spmm(A, X)
    if isinstance(A, DeviceWellCw):
        raise KernelError(
            "spmm on WELL-CW is not yet ported to spmv_tpu_torch (kernels "
            "K4); see ROADMAP.md")
    raise KernelError(f"spmm: no port for {type(A).__name__}")

"""CSR kernel wrapper.

``csr_spmv_core`` (``csrc/csr_spmv.cu``) is not the port of a TPU
kernel: the JAX package sums CSR in XLA (``_csr_padded``,
``spmv_tpu/ops/spmv.py:42``).  It is written by hand so that the WELL-CW
remainder adds in a fixed order on the card (``index_add_`` on CUDA adds
with atomics, in no fixed order), and for the CSR format's own path.
It takes its plain version (``csr_spmv_reference``) for CPU tensors,
launches the kernel for CUDA tensors, and raises for anything else, with
the launch discipline of ``ops/_launch.py``.  ``csr_spmv_core.launches``
counts launches.
"""

from __future__ import annotations

import torch

from spmv_tpu.errors import KernelError
from spmv_tpu_torch.ops._launch import (
    check_no_alias,
    check_vector,
    on_cuda,
    raise_on,
    stream_of,
)
from spmv_tpu_torch.ops.spmv import csr_spmv_reference

__all__ = ["csr_spmv_core", "csr_spmv"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _check_matrix(A):
    if A.value.dtype not in _DTYPE_CODE:
        raise KernelError(f"unsupported CSR value dtype {A.value.dtype}")
    for name in ("row_ptr", "column_index"):
        t = getattr(A, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise KernelError(f"CSR {name} must be contiguous int32")
    if not A.value.is_contiguous():
        raise KernelError("CSR value must be contiguous")


def csr_spmv_core(A, x: torch.Tensor, out: torch.Tensor = None,
                  accumulate: bool = False) -> torch.Tensor:
    """y = A @ x for a ``DeviceCsr``, x and y in the value dtype.

    ``out`` (optional, length num_rows, not overlapping x) receives y;
    with ``accumulate=True`` it receives ``out + A @ x`` instead.
    """
    _check_matrix(A)
    dt = A.value.dtype
    check_vector("x", x, (A.num_columns,), dt)
    if out is not None:
        check_vector("out", out, (A.num_rows,), dt)
        check_no_alias(x, out)
    elif accumulate:
        raise KernelError("accumulate=True needs an out buffer")
    tensors = (A.value, A.row_ptr, A.column_index, x) + (
        () if out is None else (out,))
    if not on_cuda("CSR", *tensors):
        y = csr_spmv_reference(A, x)
        if out is None:
            return y
        return out.add_(y) if accumulate else out.copy_(y)

    from spmv_tpu_torch.ops._build import load_library

    n = A.num_rows
    y = out if out is not None else torch.empty(n, dtype=dt, device=x.device)
    if n > 0:
        lib = load_library()
        rc = lib.csr_spmv_launch(
            _DTYPE_CODE[dt], x.device.index, A.row_ptr.data_ptr(),
            A.column_index.data_ptr(), A.value.data_ptr(), n,
            A.num_columns, x.data_ptr(), y.data_ptr(), int(accumulate),
            stream_of(x))
        raise_on(lib, rc, "csr_spmv")
        csr_spmv_core.launches += 1
    return y


csr_spmv_core.launches = 0


def csr_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """One-shot y = A @ x: x is cast to the value dtype first."""
    return csr_spmv_core(A, x.to(A.value.dtype).contiguous())

"""CSR kernel wrappers.

``csr_spmv_core`` (``csrc/csr_spmv.cu``) and ``csr_spmm_core``
(``csrc/csr_spmm.cu``) are not ports of TPU kernels: the JAX package
sums CSR in XLA (``_csr_padded`` and the ``DeviceCsr`` branch of
``spmm``, ``spmv_tpu/ops/spmv.py:42, :266-273``).  They are written by
hand so that the WELL-CW remainder adds in a fixed order on the card
(``index_add_`` on CUDA adds with atomics, in no fixed order), and for
the CSR format's own path.  Each takes its plain version
(``csr_spmv_reference``, which also takes X of shape (m, k)) for CPU
tensors, launches its kernel for CUDA tensors, and raises for anything
else, with the launch discipline of ``ops/_launch.py``.  ``.launches``
on each counts its launches.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.ops._launch import (
    check_no_alias,
    check_vector,
    on_cuda,
    raise_on,
    stream_of,
)
from spmv_tpu_torch.ops.spmv import csr_spmv_reference

__all__ = ["csr_spmv_core", "csr_spmv", "csr_spmm_core", "csr_spmm"]

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


def csr_spmm_core(A, X: torch.Tensor, out: torch.Tensor = None,
                  accumulate: bool = False) -> torch.Tensor:
    """Y = A @ X for a ``DeviceCsr``: X of shape (num_columns, k) and Y
    of shape (num_rows, k), row-major, in the value dtype.

    ``out`` (optional, not overlapping X) receives Y; with
    ``accumulate=True`` it receives ``out + A @ X`` instead.
    """
    _check_matrix(A)
    dt = A.value.dtype
    if X.dim() != 2:
        raise KernelError(f"X must be (num_columns, k); got {tuple(X.shape)}")
    k = X.shape[1]
    check_vector("X", X, (A.num_columns, k), dt)
    if out is not None:
        check_vector("out", out, (A.num_rows, k), dt)
        check_no_alias(X, out)
    elif accumulate:
        raise KernelError("accumulate=True needs an out buffer")
    tensors = (A.value, A.row_ptr, A.column_index, X) + (
        () if out is None else (out,))
    if not on_cuda("CSR", *tensors):
        Y = csr_spmv_reference(A, X)
        if out is None:
            return Y
        return out.add_(Y) if accumulate else out.copy_(Y)

    from spmv_tpu_torch.ops._build import load_library

    n = A.num_rows
    Y = out if out is not None else torch.empty((n, k), dtype=dt,
                                                device=X.device)
    if n > 0 and k > 0:
        lib = load_library()
        rc = lib.csr_spmm_launch(
            _DTYPE_CODE[dt], X.device.index, A.row_ptr.data_ptr(),
            A.column_index.data_ptr(), A.value.data_ptr(), n,
            A.num_columns, k, X.data_ptr(), Y.data_ptr(), int(accumulate),
            stream_of(X))
        raise_on(lib, rc, "csr_spmm")
        csr_spmm_core.launches += 1
    return Y


csr_spmm_core.launches = 0


def csr_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """One-shot Y = A @ X: X is cast to the value dtype first."""
    return csr_spmm_core(A, X.to(A.value.dtype).contiguous())

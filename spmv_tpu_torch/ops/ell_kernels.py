"""ELL and hybrid kernel wrappers.

``ell_spmv_core`` (``csrc/ell_spmv.cu``) and ``ell_spmm_core``
(``csrc/ell_spmm.cu``) are not ports of TPU kernels: the JAX package
sums ELL in XLA (``_ell_padded`` and the ``DeviceEll`` branch of
``spmm``, ``spmv_tpu/ops/spmv.py:52, :274-276``).  They are written by
hand, as the CSR kernels are (``ops/csr_kernels.py``), so that the ELL
format runs a fixed-order kernel on the card: one thread a row adds its
slots 0..L-1 in order.  Each takes its plain version
(``ell_spmv_reference``, which also takes X of shape (m, k)) for CPU
tensors, launches its kernel for CUDA tensors, and raises for anything
else, with the launch discipline of ``ops/_launch.py``.  ``.launches``
on each counts its launches.

A hybrid product (``hybrid_spmv_core``, ``hybrid_spmm_core``) is two
launches, after the hybrid branches of JAX's ``spmv_padded`` and
``spmm``: the ELL kernel writes every row of y (or Y), then the CSR
kernel adds the COO part into it (``accumulate=True``; it leaves a row
with no COO entry alone).  Where the COO part holds no entry no CSR
kernel is launched.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.ops._launch import (
    check_no_alias,
    check_vector,
    ell_spmv_plan,
    on_cuda,
    raise_on,
    spmm_plan,
    stream_of,
)
from spmv_tpu_torch.ops.csr_kernels import csr_spmm_core, csr_spmv_core
from spmv_tpu_torch.ops.spmv import ell_spmv_reference

__all__ = ["ell_spmv_core", "ell_spmv", "ell_spmm_core", "ell_spmm",
           "hybrid_spmv_core", "hybrid_spmv", "hybrid_spmm_core",
           "hybrid_spmm"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _check_matrix(A):
    if A.value.dtype not in _DTYPE_CODE:
        raise KernelError(f"unsupported ELL value dtype {A.value.dtype}")
    if A.column_index.dtype != torch.int32 or \
            not A.column_index.is_contiguous():
        raise KernelError("ELL column_index must be contiguous int32")
    if not A.value.is_contiguous():
        raise KernelError("ELL value must be contiguous")


def _out(A, x, out, accumulate, shape):
    """Check ``out`` against the product's shape and x; None is allowed
    only without ``accumulate``."""
    if out is not None:
        check_vector("out", out, shape, A.value.dtype)
        check_no_alias(x, out)
    elif accumulate:
        raise KernelError("accumulate=True needs an out buffer")


def ell_spmv_core(A, x: torch.Tensor, out: torch.Tensor = None,
                  accumulate: bool = False) -> torch.Tensor:
    """y = A @ x for a ``DeviceEll``, x and y in the value dtype.

    ``out`` (optional, length num_rows, not overlapping x) receives y;
    with ``accumulate=True`` it receives ``out + A @ x`` instead.  The
    kernel runs on ``ell_spmv_plan``'s path: the row length as a template
    argument up to 8 slots, one row a thread.
    """
    _check_matrix(A)
    dt = A.value.dtype
    check_vector("x", x, (A.num_columns,), dt)
    _out(A, x, out, accumulate, (A.num_rows,))
    tensors = (A.value, A.column_index, x) + (() if out is None else (out,))
    if not on_cuda("ELL", *tensors):
        y = ell_spmv_reference(A, x)
        if out is None:
            return y
        return out.add_(y) if accumulate else out.copy_(y)

    from spmv_tpu_torch.ops._build import load_library

    n = A.num_rows
    y = out if out is not None else torch.empty(n, dtype=dt, device=x.device)
    if n > 0:
        lib = load_library()
        rc = lib.ell_spmv_launch(
            _DTYPE_CODE[dt], x.device.index, A.column_index.data_ptr(),
            A.value.data_ptr(), A.padded_row_length,
            ell_spmv_plan(A.padded_row_length)["slots"], n, A.num_columns,
            x.data_ptr(), y.data_ptr(), int(accumulate), stream_of(x))
        raise_on(lib, rc, "ell_spmv")
        ell_spmv_core.launches += 1
    return y


ell_spmv_core.launches = 0


def ell_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """One-shot y = A @ x: x is cast to the value dtype first."""
    return ell_spmv_core(A, x.to(A.value.dtype).contiguous())


def ell_spmm_core(A, X: torch.Tensor, out: torch.Tensor = None,
                  accumulate: bool = False) -> torch.Tensor:
    """Y = A @ X for a ``DeviceEll``: X of shape (num_columns, k) and Y
    of shape (num_rows, k), row-major, in the value dtype.

    ``out`` (optional, not overlapping X) receives Y; with
    ``accumulate=True`` it receives ``out + A @ X`` instead.  The kernel
    runs one thread a (row, column block of ``spmm_plan``'s kb) and
    writes every row.
    """
    _check_matrix(A)
    dt = A.value.dtype
    if X.dim() != 2:
        raise KernelError(f"X must be (num_columns, k); got {tuple(X.shape)}")
    k = X.shape[1]
    check_vector("X", X, (A.num_columns, k), dt)
    _out(A, X, out, accumulate, (A.num_rows, k))
    tensors = (A.value, A.column_index, X) + (() if out is None else (out,))
    if not on_cuda("ELL", *tensors):
        Y = ell_spmv_reference(A, X)
        if out is None:
            return Y
        return out.add_(Y) if accumulate else out.copy_(Y)

    from spmv_tpu_torch.ops._build import load_library

    n = A.num_rows
    Y = out if out is not None else torch.empty((n, k), dtype=dt,
                                                device=X.device)
    if n > 0 and k > 0:
        plan = spmm_plan(k, dt, X.data_ptr(), Y.data_ptr())
        lib = load_library()
        rc = lib.ell_spmm_launch(
            _DTYPE_CODE[dt], X.device.index, A.column_index.data_ptr(),
            A.value.data_ptr(), A.padded_row_length, n, A.num_columns, k,
            plan["kb"], int(plan["vector_x"]), X.data_ptr(), Y.data_ptr(),
            int(accumulate), stream_of(X))
        raise_on(lib, rc, "ell_spmm")
        ell_spmm_core.launches += 1
    return Y


ell_spmm_core.launches = 0


def ell_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """One-shot Y = A @ X: X is cast to the value dtype first."""
    return ell_spmm_core(A, X.to(A.value.dtype).contiguous())


def hybrid_spmv_core(A, x: torch.Tensor,
                     out: torch.Tensor = None) -> torch.Tensor:
    """y = A @ x for a ``DeviceHybrid``: the ELL kernel writes y, then
    the CSR kernel adds the COO part (not launched where it is empty)."""
    y = ell_spmv_core(A.ell, x, out=out)
    if A.coo.value.numel():
        csr_spmv_core(A.coo, x, out=y, accumulate=True)
    return y


def hybrid_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """One-shot y = A @ x: x is cast to the value dtype first."""
    return hybrid_spmv_core(A, x.to(A.ell.value.dtype).contiguous())


def hybrid_spmm_core(A, X: torch.Tensor,
                     out: torch.Tensor = None) -> torch.Tensor:
    """Y = A @ X for a ``DeviceHybrid``: the ELL SpMM writes Y, then the
    CSR SpMM adds the COO part over its row list (not launched where the
    part is empty)."""
    Y = ell_spmm_core(A.ell, X, out=out)
    if A.coo.value.numel():
        csr_spmm_core(A.coo, X, out=Y, accumulate=True)
    return Y


def hybrid_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """One-shot Y = A @ X: X is cast to the value dtype first."""
    return hybrid_spmm_core(A, X.to(A.ell.value.dtype).contiguous())

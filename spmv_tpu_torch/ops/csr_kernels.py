"""CSR kernel wrappers.

``csr_spmv_core`` (``csrc/csr_spmv.cu``) and ``csr_spmm_core``
(``csrc/csr_spmm.cu``) are not ports of TPU kernels: the JAX package
sums CSR in XLA (``_csr_padded`` and the ``DeviceCsr`` branch of
``spmm``, ``spmv_tpu/ops/spmv.py:42, :266-273``).  They are written by
hand so that the WELL-CW remainder adds in a fixed order on the card
(``index_add_`` on CUDA adds with atomics, in no fixed order), and for
the CSR format's own path.  Both sum a short row in one thread and a
row of ``DeviceCsr.long_rows`` in a warp or a block
(``csrc/csr_rows.cuh``).  Each takes its plain version
(``csr_spmv_reference``, which also takes X of shape (m, k)) for CPU
tensors, launches its kernel for CUDA tensors, and raises for anything
else, with the launch discipline of ``ops/_launch.py``.  ``.launches``
on each counts its launches.

``csr_regular_core`` and ``csr_irregular_core`` are the traffic-isolation
variants of the CSR SpMV (``--traffic-split``; the JAX package's
``_csr_regular`` and ``_csr_irregular``, ``spmv_tpu/ops/traffic.py:59,
:69``): the kernel's own walk in its ``REGULAR`` and ``IRREGULAR`` modes,
each row's stored values summed (no index, no x) or x at its columns
summed (no value).  Their plain versions are ``csr_regular_reference``
and ``csr_irregular_reference``; each counts its own launches.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.ops._launch import (
    FULL,
    IRREGULAR,
    REGULAR,
    check_no_alias,
    check_vector,
    on_cuda,
    raise_on,
    spmm_plan,
    stream_of,
)
from spmv_tpu_torch.ops.spmv import (
    csr_irregular_reference,
    csr_regular_reference,
    csr_spmv_reference,
)

__all__ = ["csr_spmv_core", "csr_spmv", "csr_spmm_core", "csr_spmm",
           "csr_regular_core", "csr_irregular_core"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _check_matrix(A):
    if A.value.dtype not in _DTYPE_CODE:
        raise KernelError(f"unsupported CSR value dtype {A.value.dtype}")
    for name in ("row_ptr", "column_index", "row_list", "long_rows"):
        t = getattr(A, name)
        if t is not None and (t.dtype != torch.int32
                              or not t.is_contiguous()):
            raise KernelError(f"CSR {name} must be contiguous int32")
    if not A.value.is_contiguous():
        raise KernelError("CSR value must be contiguous")


def _long_rows(A) -> tuple:
    """The launchers' long-row arguments: (pointer or None, rows, block
    rows, the longest short row)."""
    rows = A.long_rows
    if rows is None:
        return None, 0, 0, A.long_row_entries
    return (rows.data_ptr(), rows.numel(), A.num_block_rows,
            A.long_row_entries)


def _spmv(wrapper, mode, A, x, out, accumulate) -> torch.Tensor:
    """Launch the CSR SpMV in ``mode`` (``FULL``, or a traffic variant: x
    None for ``REGULAR``, which reads none) and count it on ``wrapper``;
    the plain version for CPU tensors."""
    _check_matrix(A)
    dt = A.value.dtype
    if x is not None:
        check_vector("x", x, (A.num_columns,), dt)
    if out is not None:
        check_vector("out", out, (A.num_rows,), dt)
        if x is not None:
            check_no_alias(x, out)
    elif accumulate:
        raise KernelError("accumulate=True needs an out buffer")
    tensors = (A.value, A.row_ptr, A.column_index) + tuple(
        t for t in (x, A.long_rows, out) if t is not None)
    if not on_cuda("CSR", *tensors):
        y = (csr_spmv_reference(A, x) if mode == FULL
             else csr_regular_reference(A) if mode == REGULAR
             else csr_irregular_reference(A, x))
        if out is None:
            return y
        return out.add_(y) if accumulate else out.copy_(y)

    from spmv_tpu_torch.ops._build import load_library

    n = A.num_rows
    dev = A.value.device
    y = out if out is not None else torch.empty(n, dtype=dt, device=dev)
    if n > 0:
        lib = load_library()
        rc = lib.csr_spmv_launch(
            _DTYPE_CODE[dt], dev.index, A.row_ptr.data_ptr(),
            A.column_index.data_ptr(), A.value.data_ptr(), n,
            A.num_columns, *_long_rows(A),
            None if x is None else x.data_ptr(), y.data_ptr(),
            int(accumulate), mode, stream_of(y))
        raise_on(lib, rc, wrapper.__name__.removesuffix("_core"))
        wrapper.launches += 1
    return y


def csr_spmv_core(A, x: torch.Tensor, out: torch.Tensor = None,
                  accumulate: bool = False) -> torch.Tensor:
    """y = A @ x for a ``DeviceCsr``, x and y in the value dtype.

    ``out`` (optional, length num_rows, not overlapping x) receives y;
    with ``accumulate=True`` it receives ``out + A @ x`` instead.
    """
    return _spmv(csr_spmv_core, FULL, A, x, out, accumulate)


csr_spmv_core.launches = 0


def csr_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """One-shot y = A @ x: x is cast to the value dtype first."""
    return csr_spmv_core(A, x.to(A.value.dtype).contiguous())


def csr_spmm_core(A, X: torch.Tensor, out: torch.Tensor = None,
                  accumulate: bool = False) -> torch.Tensor:
    """Y = A @ X for a ``DeviceCsr``: X of shape (num_columns, k) and Y
    of shape (num_rows, k), row-major, in the value dtype.

    ``out`` (optional, not overlapping X) receives Y; with
    ``accumulate=True`` it receives ``out + A @ X`` instead.  The kernel
    runs one thread a row of ``A.row_list`` (every row where it is None)
    and a warp or a block a row of ``A.long_rows``, on the path
    ``spmm_plan`` gives; with a row list and without ``accumulate`` it
    zeroes Y first, with ``accumulate`` a row that owns no entry is not
    written.  A matrix with no entry launches nothing.
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
    rows = A.row_list
    tensors = (A.value, A.row_ptr, A.column_index, X) + tuple(
        t for t in (rows, A.long_rows, out) if t is not None)
    if not on_cuda("CSR", *tensors):
        Y = csr_spmv_reference(A, X)
        if out is None:
            return Y
        return out.add_(Y) if accumulate else out.copy_(Y)

    from spmv_tpu_torch.ops._build import load_library

    n = A.num_rows
    Y = out if out is not None else torch.empty((n, k), dtype=dt,
                                                device=X.device)
    if rows is not None and rows.numel() == 0 and A.long_rows is None:
        # no row owns an entry: Y is the sum of none
        return Y if accumulate else Y.zero_()
    plan = spmm_plan(k, dt, X.data_ptr(), Y.data_ptr())
    if n > 0 and k > 0:
        lib = load_library()
        rc = lib.csr_spmm_launch(
            _DTYPE_CODE[dt], X.device.index, A.row_ptr.data_ptr(),
            None if rows is None or rows.numel() == 0 else rows.data_ptr(),
            A.column_index.data_ptr(), A.value.data_ptr(),
            n if rows is None else rows.numel(), n, A.num_columns,
            *_long_rows(A), k, plan["kb"], int(plan["vector_x"]),
            int(rows is not None and not accumulate), X.data_ptr(),
            Y.data_ptr(), int(accumulate), stream_of(X))
        raise_on(lib, rc, "csr_spmm")
        csr_spmm_core.launches += 1
    return Y


csr_spmm_core.launches = 0


def csr_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """One-shot Y = A @ X: X is cast to the value dtype first."""
    return csr_spmm_core(A, X.to(A.value.dtype).contiguous())


def csr_regular_core(A, out: torch.Tensor = None,
                     accumulate: bool = False) -> torch.Tensor:
    """The stream-only variant of the CSR SpMV for a ``DeviceCsr``: y[i] =
    the sum of row i's stored values, in the value dtype.  ``out`` and
    ``accumulate`` as for ``csr_spmv_core``."""
    return _spmv(csr_regular_core, REGULAR, A, None, out, accumulate)


csr_regular_core.launches = 0


def csr_irregular_core(A, x: torch.Tensor, out: torch.Tensor = None,
                       accumulate: bool = False) -> torch.Tensor:
    """The gather-only variant of the CSR SpMV for a ``DeviceCsr``: y[i] =
    the sum of x at row i's stored columns (0 outside [0, num_columns)),
    x in the value dtype.  ``out`` and ``accumulate`` as for
    ``csr_spmv_core``."""
    return _spmv(csr_irregular_core, IRREGULAR, A, x, out, accumulate)


csr_irregular_core.launches = 0

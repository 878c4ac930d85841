"""DIA kernel wrappers: the counterpart of the DIA section of
``spmv_tpu/ops/pallas_kernels.py``.

Each wrapper takes its kernel's plain version (``spmv_tpu_torch.ops.spmv``)
for a tensor on the CPU, launches its CUDA kernel for a tensor on a CUDA
device, and raises for anything else: nothing falls back.

- K1 ``dia_spmv_core`` (``csrc/dia_spmv.cu``) replaces ``_dia_kernel``
  (pallas_kernels.py:196), including the fused <x, A x> dot.
- K2 ``dia_spmm_core`` (``csrc/dia_spmm.cu``) replaces
  ``_dia_spmm_kernel`` (pallas_kernels.py:710).

Both are bound by device-memory bytes on an H100 (2 flops per diagonal
value read); the simple design, one thread per row with coalesced
diagonal and shifted-x reads, is explained at the top of each ``.cu``
file.

Launch discipline (``ops/_launch.py``): the kernel runs on
``torch.cuda.current_stream()`` without synchronising, outputs and dot
partials come from ``torch.empty`` here, device / dtype / shape /
contiguity are checked before the launch, and the C function's
``cudaGetLastError()`` is checked after it.  ``dia_spmv_core.launches`` and
``dia_spmm_core.launches`` count successful launches.

Not ported: the Pallas ``in_place`` aliasing and its window schedule
(pallas_kernels.py:106-193, :267-272).  They rely on the TPU's grid
steps running in order; CUDA blocks run in no order, so a block could
overwrite rows of x that another block still reads.  The output must
not alias the input: chained callers alternate between two buffers
(``out=``).
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
from spmv_tpu_torch.ops.spmv import (
    accumulate_dtype,
    dia_spmm_reference,
    dia_spmv_reference,
)

__all__ = ["dia_spmv_core", "dia_spmv", "dia_spmm_core", "dia_spmm"]

THREADS_PER_BLOCK = 256
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def _check_matrix(A):
    if A.data.dtype not in _DTYPE_CODE:
        raise KernelError(f"unsupported DIA storage dtype {A.data.dtype}")
    if not A.data.is_contiguous():
        raise KernelError("DIA data must be contiguous")
    if A.offsets_dev.dtype != torch.int32 or \
            A.offsets_dev.device != A.data.device:
        raise KernelError("DIA offsets_dev must be int32 on the data's device")


def dia_spmv_core(A, x: torch.Tensor, with_dot: bool = False,
                  out: torch.Tensor = None):
    """y = A @ x for x of length num_columns, y of length num_rows, both
    in the storage dtype.

    ``with_dot=True`` returns ``(y, dot)`` where ``dot`` is <x, A x> as
    a 0-d tensor in the accumulator dtype (float64 for float64 data,
    else float32), summed from one partial per block: CG's p.Ap without
    a second pass over the vectors.  ``out`` (optional) receives y and
    must not overlap x.
    """
    _check_matrix(A)
    dt = A.data.dtype
    check_vector("x", x, (A.num_columns,), dt)
    if out is not None:
        check_vector("out", out, (A.num_rows,), dt)
        check_no_alias(x, out)
    cuda = on_cuda("DIA", A.data, x, *(() if out is None else (out,)))
    if not cuda:
        res = dia_spmv_reference(A, x, with_dot=with_dot)
        y = res[0] if with_dot else res
        if out is not None:
            y = out.copy_(y)
        return (y, res[1]) if with_dot else y

    from spmv_tpu_torch.ops._build import load_library

    n = A.num_rows
    y = out if out is not None else torch.empty(n, dtype=dt, device=x.device)
    nblocks = -(-n // THREADS_PER_BLOCK)
    partials = (torch.empty(nblocks, dtype=accumulate_dtype(dt),
                            device=x.device) if with_dot else None)
    if n > 0:
        lib = load_library()
        rc = lib.dia_spmv_launch(
            _DTYPE_CODE[dt], x.device.index, A.data.data_ptr(),
            A.offsets_dev.data_ptr(), A.num_diagonals, n, A.num_columns,
            x.data_ptr(), y.data_ptr(),
            partials.data_ptr() if with_dot else None,
            THREADS_PER_BLOCK,
            stream_of(x))
        raise_on(lib, rc, "dia_spmv")
        dia_spmv_core.launches += 1
    if with_dot:
        return y, partials.sum()
    return y


dia_spmv_core.launches = 0


def dia_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """One-shot y = A @ x: x is cast to the storage dtype first."""
    return dia_spmv_core(A, x.to(A.data.dtype).contiguous())


def dia_spmm_core(A, X: torch.Tensor, out: torch.Tensor = None):
    """Y = A @ X for X of shape (num_columns, k), row-major, in the
    storage dtype; Y is (num_rows, k).  ``out`` must not overlap X."""
    _check_matrix(A)
    dt = A.data.dtype
    if X.dim() != 2:
        raise KernelError(f"X must be (num_columns, k); got {tuple(X.shape)}")
    k = X.shape[1]
    check_vector("X", X, (A.num_columns, k), dt)
    if out is not None:
        check_vector("out", out, (A.num_rows, k), dt)
        check_no_alias(X, out)
    cuda = on_cuda("DIA", A.data, X, *(() if out is None else (out,)))
    if not cuda:
        Y = dia_spmm_reference(A, X)
        return out.copy_(Y) if out is not None else Y

    from spmv_tpu_torch.ops._build import load_library

    n = A.num_rows
    Y = out if out is not None else torch.empty((n, k), dtype=dt,
                                                device=X.device)
    if n > 0 and k > 0:
        lib = load_library()
        rc = lib.dia_spmm_launch(
            _DTYPE_CODE[dt], X.device.index, A.data.data_ptr(),
            A.offsets_dev.data_ptr(), A.num_diagonals, n, A.num_columns,
            k, X.data_ptr(), Y.data_ptr(), THREADS_PER_BLOCK,
            stream_of(X))
        raise_on(lib, rc, "dia_spmm")
        dia_spmm_core.launches += 1
    return Y


dia_spmm_core.launches = 0


def dia_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """One-shot Y = A @ X: X is cast to the storage dtype first."""
    return dia_spmm_core(A, X.to(A.data.dtype).contiguous())


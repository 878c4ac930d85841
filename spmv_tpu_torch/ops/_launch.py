"""Launch discipline shared by the kernel wrappers.

Each wrapper checks device, dtype, shape and contiguity here before it
launches, and raises through ``raise_on`` when the C launcher returns a
CUDA error.  ``on_cuda`` is the only place that decides between a
kernel and its plain version: CUDA tensors take the kernel, CPU tensors
the plain version, and any other device (or a mix) raises.
``spmm_plan`` gives the path of the SpMM kernels that hold a row's
column sums in registers (K4a-c, the CSR SpMM; ``csrc/spmm_rows.cuh``),
``ell_spmv_plan`` that of the ELL SpMV (``csrc/ell_spmv.cu``).
"""

from __future__ import annotations

import torch

from spmv_tpu_torch.errors import KernelError

__all__ = ["on_cuda", "check_vector", "check_no_alias", "raise_on",
           "stream_of", "column_block", "x_vector_loads", "spmm_plan",
           "ell_spmv_plan"]

# The column blocks of K4a-c and the CSR SpMM, passed to every launch: a
# thread holds kb = min(k, COLUMNS) sums in registers.
COLUMNS = 8

# The row lengths the ELL SpMV has a template of (kMaxSlots in
# csrc/ell_spmv.cu); a longer row is walked this many slots a round.
ELL_MAX_SLOTS = 8


def on_cuda(what: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises for any
    other device or a mix of devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise KernelError(
            f"matrix and vectors lie on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise KernelError(f"no {what} kernel for device {dev}")


def check_vector(name: str, t: torch.Tensor, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape):
        raise KernelError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise KernelError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise KernelError(f"{name} must be contiguous")


def check_no_alias(x: torch.Tensor, out: torch.Tensor) -> None:
    xs, xe = x.data_ptr(), x.data_ptr() + x.numel() * x.element_size()
    os_, oe = out.data_ptr(), out.data_ptr() + out.numel() * out.element_size()
    if xs < oe and os_ < xe:
        raise KernelError(
            "out must not overlap the input vector (the kernels have no "
            "in-place variant; alternate between two buffers)")


def raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.spmv_tpu_torch_error_string(rc).decode()
        raise KernelError(f"{what} launch failed: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the C launchers take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def column_block(k: int) -> int:
    """Columns per block of an SpMM kernel (K4a-c, the CSR SpMM): as many
    as a thread holds in registers."""
    return max(1, min(k, COLUMNS))


def x_vector_loads(k: int, kb: int, itemsize: int, *pointers: int) -> bool:
    """Whether an SpMM kernel reads a cell's X values (and writes Y) 16
    bytes at a time: X's rows and every column block are whole 16-byte
    runs, and each of ``pointers`` (the data pointers of X and Y) is
    16-byte aligned."""
    return ((k * itemsize) % 16 == 0 and (kb * itemsize) % 16 == 0
            and all(p % 16 == 0 for p in pointers))


def spmm_plan(k: int, dtype: torch.dtype, x_ptr: int, y_ptr: int) -> dict:
    """The path K4a-c and the CSR SpMM launch on for X (num_columns, k)
    and Y of ``dtype`` at those data pointers: the columns a block
    (``kb``) and whether a cell's X values (and Y) move 16 bytes at a
    time."""
    kb = column_block(k)
    return {"kb": kb, "vector_x": x_vector_loads(k, kb, dtype.itemsize,
                                                 x_ptr, y_ptr)}


def ell_spmv_plan(row_length: int) -> dict:
    """The path the ELL SpMV launches on for rows of ``row_length`` slots:
    ``slots``, the row length of its template (0 past ``ELL_MAX_SLOTS``
    and for no slot: rounds of ``ELL_MAX_SLOTS`` slots)."""
    return {"slots": row_length if 0 < row_length <= ELL_MAX_SLOTS else 0}

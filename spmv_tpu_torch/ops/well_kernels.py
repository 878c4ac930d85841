"""WELL kernel wrappers: the counterpart of the WELL SpMV section of
``spmv_tpu/ops/pallas_kernels.py`` (``csrc/well_spmv.cu``).

- K5a ``well_whole_core`` replaces ``_well_kernel`` (pallas_kernels.py:431,
  through ``well_spmv_padded``, :474): a ``DeviceWell`` in whole-x mode;
- K5b ``well_seg_core`` replaces ``_well_seg_kernel`` (:557, through
  ``_well_seg_call``, :622): a ``DeviceWell`` in segmented mode.

The ``.cu`` header says what bounds them and how the simple design
works.  ``well_spmv_core`` composes them after ``well_spmv`` (:682): the
chunk kernel of the container's mode writes every row of y, then the
CSR spill adds (``csr_spmv_core(..., accumulate=True)``).  Nothing is
padded, so ``well_spmv_padded`` has no separate counterpart.

Each part wrapper takes its plain version (``ops/spmv.py``) for CPU
tensors, launches its kernel for CUDA tensors, and raises for anything
else, with the launch discipline of ``ops/_launch.py``; ``.launches``
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
from spmv_tpu_torch.ops.csr_kernels import csr_spmv_core
from spmv_tpu_torch.ops.spmv import well_chunks_reference

__all__ = ["well_whole_core", "well_seg_core", "well_spmv_core",
           "well_spmv"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
LANE = 128
SMEM_MAX = 232448          # bytes of shared memory a block may have


def _prepare(what, A, x, out, segmented: bool) -> bool:
    """Check A's chunk arrays and the vectors; returns whether they lie
    on a CUDA device."""
    if (A.segment_of_step is not None) != segmented:
        raise KernelError(
            f"{what}: the matrix is in "
            f"{'segmented' if A.segment_of_step is not None else 'whole-x'}"
            " mode")
    dt = A.value.dtype
    if dt not in _DTYPE_CODE:
        raise KernelError(f"unsupported WELL value dtype {dt}")
    indices = (A.local_index, A.window_start, A.group_of_chunk,
               A.step_ptr) + ((A.segment_of_step,) if segmented else ())
    for t in (A.value,) + indices:
        if not t.is_contiguous():
            raise KernelError(f"{what}: matrix arrays must be contiguous")
    if any(t.dtype != torch.int32 for t in indices):
        raise KernelError(f"{what}: index arrays must be int32")
    if A.out_rows * LANE * A.value.element_size() > SMEM_MAX:
        raise KernelError(
            f"{what}: blocks_per_out={A.blocks_per_out} needs more than "
            f"{SMEM_MAX} bytes of shared memory per block")
    check_vector("x", x, (A.num_columns,), dt)
    if out is not None:
        check_vector("out", out, (A.num_rows,), dt)
        check_no_alias(x, out)
    tensors = (A.value, x) + indices + (() if out is None else (out,))
    return on_cuda("WELL", *tensors)


def _launch(wrapper, name, A, x, out, segmented):
    """Launch ``name``'s kernel and count it on ``wrapper``."""
    from spmv_tpu_torch.ops._build import load_library

    y = out if out is not None else torch.empty(
        A.num_rows, dtype=x.dtype, device=x.device)
    if A.num_rows > 0:
        lib = load_library()
        seg = (A.segment_of_step.data_ptr(),) if segmented else ()
        rc = getattr(lib, f"{name}_launch")(
            _DTYPE_CODE[x.dtype], x.device.index, A.value.data_ptr(),
            A.local_index.data_ptr(), A.window_start.data_ptr(),
            A.group_of_chunk.data_ptr(), *seg, A.step_ptr.data_ptr(),
            A.chunks_per_step, A.out_rows, A.num_out_blocks, A.num_rows,
            A.num_columns, x.data_ptr(), y.data_ptr(), stream_of(x))
        raise_on(lib, rc, name)
        wrapper.launches += 1
    return y


def well_whole_core(A, x: torch.Tensor,
                    out: torch.Tensor = None) -> torch.Tensor:
    """K5a: the WELL chunks' product (without the spill) for a whole-x
    ``DeviceWell``; x of length num_columns and y of length num_rows in
    the value dtype.  ``out`` (optional, not overlapping x) receives y."""
    if not _prepare("well_whole", A, x, out, segmented=False):
        y = well_chunks_reference(A, x)
        return y if out is None else out.copy_(y)
    return _launch(well_whole_core, "well_whole", A, x, out,
                   segmented=False)


well_whole_core.launches = 0


def well_seg_core(A, x: torch.Tensor,
                  out: torch.Tensor = None) -> torch.Tensor:
    """K5b: the WELL chunks' product for a segmented ``DeviceWell``;
    arguments as for ``well_whole_core``."""
    if not _prepare("well_seg", A, x, out, segmented=True):
        y = well_chunks_reference(A, x)
        return y if out is None else out.copy_(y)
    return _launch(well_seg_core, "well_seg", A, x, out, segmented=True)


well_seg_core.launches = 0


def well_spmv_core(A, x: torch.Tensor,
                   out: torch.Tensor = None) -> torch.Tensor:
    """y = A @ x for a ``DeviceWell``: the chunk kernel of its mode (K5a
    or K5b) writes y, then the CSR spill adds.  x of length num_columns
    and y of length num_rows, in the value dtype; ``out`` (optional, not
    overlapping x) receives y."""
    if x.dim() != 1:
        raise KernelError(f"x must be 1-D; got {tuple(x.shape)}")
    core = well_whole_core if A.segment_of_step is None else well_seg_core
    y = core(A, x, out=out)
    if A.spill is not None:
        csr_spmv_core(A.spill, x, out=y, accumulate=True)
    return y


def well_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """One-shot y = A @ x: x is cast to the value dtype first."""
    return well_spmv_core(A, x.to(A.value_dtype).contiguous())

"""WELL kernel wrappers: the counterpart of the WELL SpMV and SpMM
sections of ``spmv_tpu/ops/pallas_kernels.py``.

SpMV (``csrc/well_spmv.cu``), the whole product in one launch: the
live slots of the chunks (``slot_mask``), then the spill in lane order:

- K5a ``well_whole_core`` replaces ``_well_kernel`` (pallas_kernels.py:431,
  through ``well_spmv_padded``, :474): a ``DeviceWell`` in whole-x mode;
- K5b ``well_seg_core`` replaces ``_well_seg_kernel`` (:557, through
  ``_well_seg_call``, :622): a ``DeviceWell`` in segmented mode.

SpMM, X of shape (num_columns, k) (``csrc/well_spmm.cu``), the whole
product in one launch as well: K5's reading, a row's column sums in
registers:

- K6a ``well_whole_spmm_core`` replaces ``_well_spmm_kernel`` (:1079,
  through ``well_spmm_padded``, :1256);
- K6b ``well_seg_spmm_core`` replaces ``_well_seg_spmm_kernel`` (:1121,
  through ``_well_seg_spmm_call``, :1188).

The ``.cu`` headers say what bounds them and how the designs work.
``well_spmv_core`` and ``well_spmm_core`` stand for ``well_spmv`` (:682)
and ``well_spmm`` (:1337): each is the one kernel of the container's
mode, the spill folded in (the JAX package adds it in XLA).  Nothing is
padded, so the ``_padded`` entry points have no separate counterpart.
The SpMM takes the columns in blocks of ``well_column_block`` (at most
8, one launch for all of them), and ``well_spmm_plan`` gives the path of
a launch: the column block and 16-byte or scalar X loads
(``x_vector_loads``, shared with K4a-c).  Not carried over: the TPU's VMEM
limits on whole x (8 MB) and on the segment (12 MB): the kernels read x
directly, so K5a and K6a take any x.

K5 and K6 read no slot whose mask bit is clear, so an inf or NaN in x
under an all-zero slot, which gives NaN in the JAX kernels (0 * inf),
leaves the port's product finite: a stated deviation (ROADMAP.md, Queue
3), which ``well_spmv_reference`` specifies for x and for X.

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
    x_vector_loads,
)
from spmv_tpu_torch.ops.spmv import well_spmv_reference

__all__ = ["well_whole_core", "well_seg_core", "well_spmv_core",
           "well_spmv", "well_whole_spmm_core", "well_seg_spmm_core",
           "well_spmm_core", "well_spmm", "well_column_block",
           "well_spmm_plan"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
LANE = 128
SMEM_MAX = 232448          # bytes of shared memory a block may have
# The SpMM kernels' column block: a thread holds kb <= COLUMNS column
# sums of its row in registers, and each column block reads the value +
# index stream once.
COLUMNS = 8


def well_column_block(k: int) -> int:
    """Columns per block of the K6 kernels for k columns: at most
    COLUMNS."""
    return max(1, min(k, COLUMNS))


def well_spmm_plan(k: int, dtype: torch.dtype, x_ptr: int,
                   y_ptr: int) -> dict:
    """The path K6 launches on for X (num_columns, k) and Y of ``dtype``
    at those data pointers: the columns a block (``kb``), the column
    blocks, and whether a cell's X values (and Y) move 16 bytes at a
    time."""
    kb = well_column_block(k)
    return {"kb": kb, "column_blocks": -(-k // kb),
            "vector_x": x_vector_loads(k, kb, dtype.itemsize, x_ptr, y_ptr)}


def _prepare(what, A, x, out, segmented: bool, ndim: int = 1) -> bool:
    """Check A's arrays and x (``ndim`` 1 for the SpMV, 2 for the SpMM's
    X); returns whether they lie on a CUDA device."""
    if (A.segment_of_step is not None) != segmented:
        raise KernelError(
            f"{what}: the matrix is in "
            f"{'segmented' if A.segment_of_step is not None else 'whole-x'}"
            " mode")
    dt = A.value.dtype
    if dt not in _DTYPE_CODE:
        raise KernelError(f"unsupported WELL value dtype {dt}")
    indices = (A.local_index, A.window_start, A.group_of_chunk,
               A.step_ptr) + ((A.segment_of_step,) if segmented else ()) + \
        tuple(t for t in (A.spill_ptr, A.spill_row, A.spill_col)
              if t is not None)
    arrays = (A.value, A.slot_mask) + (
        () if A.spill_value is None else (A.spill_value,))
    if A.slot_mask.dtype != torch.uint8 or (
            A.spill_value is not None and A.spill_value.dtype != dt):
        raise KernelError(f"{what}: slot_mask must be uint8 and "
                          "spill_value of the value dtype")
    for t in arrays + indices:
        if not t.is_contiguous():
            raise KernelError(f"{what}: matrix arrays must be contiguous")
    if any(t.dtype != torch.int32 for t in indices):
        raise KernelError(f"{what}: index arrays must be int32")
    if A.out_rows * LANE * A.value.element_size() > SMEM_MAX:
        raise KernelError(
            f"{what}: blocks_per_out={A.blocks_per_out} needs more than "
            f"{SMEM_MAX} bytes of shared memory per block (K5's tile)")
    if x.dim() != ndim:
        raise KernelError(f"{what}: x must be {ndim}-D; got "
                          f"{tuple(x.shape)}")
    tail = tuple(x.shape[1:])
    check_vector("x", x, (A.num_columns,) + tail, dt)
    if out is not None:
        check_vector("out", out, (A.num_rows,) + tail, dt)
        check_no_alias(x, out)
    tensors = arrays + (x,) + indices + (() if out is None else (out,))
    return on_cuda("WELL", *tensors)


def _matrix_args(A, segmented) -> tuple:
    """The launch arguments of A that K5 and K6 share, from value to
    num_columns."""
    ptr = (lambda t: None if t is None else t.data_ptr())
    return (A.value.data_ptr(), A.local_index.data_ptr(),
            A.window_start.data_ptr(), A.group_of_chunk.data_ptr(),
            *((A.segment_of_step.data_ptr(),) if segmented else ()),
            A.step_ptr.data_ptr(), A.slot_mask.data_ptr(), ptr(A.spill_ptr),
            ptr(A.spill_row), ptr(A.spill_col), ptr(A.spill_value),
            A.chunks_per_step, A.out_rows, A.num_out_blocks, A.num_rows,
            A.num_columns)


def _launch(wrapper, name, A, x, out, segmented):
    """Launch ``name``'s kernel and count it on ``wrapper``."""
    from spmv_tpu_torch.ops._build import load_library

    if A.value.data_ptr() % 16 or A.local_index.data_ptr() % 16:
        raise KernelError(f"{name}: value and local_index must start on "
                          "16-byte boundaries (K5 loads 4 lanes at once)")
    y = out if out is not None else torch.empty(
        A.num_rows, dtype=x.dtype, device=x.device)
    if A.num_rows > 0:
        lib = load_library()
        rc = getattr(lib, f"{name}_launch")(
            _DTYPE_CODE[x.dtype], x.device.index,
            *_matrix_args(A, segmented), x.data_ptr(), y.data_ptr(),
            stream_of(x))
        raise_on(lib, rc, name)
        wrapper.launches += 1
    return y


def well_whole_core(A, x: torch.Tensor,
                    out: torch.Tensor = None) -> torch.Tensor:
    """K5a: y = A @ x, the live slots of the chunks and the spill in one
    launch, for a whole-x ``DeviceWell``; x of length num_columns and y
    of length num_rows in the value dtype.  ``out`` (optional, not
    overlapping x) receives y."""
    if not _prepare("well_whole", A, x, out, segmented=False):
        y = well_spmv_reference(A, x)
        return y if out is None else out.copy_(y)
    return _launch(well_whole_core, "well_whole", A, x, out,
                   segmented=False)


well_whole_core.launches = 0


def well_seg_core(A, x: torch.Tensor,
                  out: torch.Tensor = None) -> torch.Tensor:
    """K5b: y = A @ x for a segmented ``DeviceWell``; arguments as for
    ``well_whole_core``."""
    if not _prepare("well_seg", A, x, out, segmented=True):
        y = well_spmv_reference(A, x)
        return y if out is None else out.copy_(y)
    return _launch(well_seg_core, "well_seg", A, x, out, segmented=True)


well_seg_core.launches = 0


def well_spmv_core(A, x: torch.Tensor,
                   out: torch.Tensor = None) -> torch.Tensor:
    """y = A @ x for a ``DeviceWell``: one launch of the kernel of its
    mode (K5a or K5b), the spill folded in.  x of length num_columns and
    y of length num_rows, in the value dtype; ``out`` (optional, not
    overlapping x) receives y."""
    if x.dim() != 1:
        raise KernelError(f"x must be 1-D; got {tuple(x.shape)}")
    core = well_whole_core if A.segment_of_step is None else well_seg_core
    return core(A, x, out=out)


def well_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """One-shot y = A @ x: x is cast to the value dtype first."""
    return well_spmv_core(A, x.to(A.value_dtype).contiguous())


def _launch_spmm(wrapper, name, A, X, out, segmented):
    """Launch ``name``'s SpMM kernel on ``well_spmm_plan``'s path and count
    it on ``wrapper``."""
    from spmv_tpu_torch.ops._build import load_library

    k = X.shape[1]
    Y = out if out is not None else torch.empty(
        (A.num_rows, k), dtype=X.dtype, device=X.device)
    plan = well_spmm_plan(k, X.dtype, X.data_ptr(), Y.data_ptr())
    if A.num_rows > 0 and k > 0:
        lib = load_library()
        rc = getattr(lib, f"{name}_launch")(
            _DTYPE_CODE[X.dtype], X.device.index,
            *_matrix_args(A, segmented), k, plan["kb"],
            int(plan["vector_x"]), X.data_ptr(), Y.data_ptr(), stream_of(X))
        raise_on(lib, rc, name)
        wrapper.launches += 1
    return Y


def well_whole_spmm_core(A, X: torch.Tensor,
                         out: torch.Tensor = None) -> torch.Tensor:
    """K6a: Y = A @ X, the live slots of the chunks and the spill in one
    launch, for a whole-x ``DeviceWell``; X of shape (num_columns, k) and
    Y (num_rows, k), row-major, in the value dtype.  ``out`` (optional,
    not overlapping X) receives Y."""
    if not _prepare("well_whole_spmm", A, X, out, segmented=False, ndim=2):
        Y = well_spmv_reference(A, X)
        return Y if out is None else out.copy_(Y)
    return _launch_spmm(well_whole_spmm_core, "well_whole_spmm", A, X, out,
                        False)


well_whole_spmm_core.launches = 0


def well_seg_spmm_core(A, X: torch.Tensor,
                       out: torch.Tensor = None) -> torch.Tensor:
    """K6b: Y = A @ X for a segmented ``DeviceWell``; arguments as for
    ``well_whole_spmm_core``."""
    if not _prepare("well_seg_spmm", A, X, out, segmented=True, ndim=2):
        Y = well_spmv_reference(A, X)
        return Y if out is None else out.copy_(Y)
    return _launch_spmm(well_seg_spmm_core, "well_seg_spmm", A, X, out,
                        True)


well_seg_spmm_core.launches = 0


def well_spmm_core(A, X: torch.Tensor,
                   out: torch.Tensor = None) -> torch.Tensor:
    """Y = A @ X for a ``DeviceWell``: one launch of the kernel of its
    mode (K6a or K6b), the spill folded in.  X of shape (num_columns, k)
    and Y (num_rows, k), row-major, in the value dtype; ``out``
    (optional, not overlapping X) receives Y."""
    if X.dim() != 2:
        raise KernelError(f"X must be (num_columns, k); got {tuple(X.shape)}")
    core = (well_whole_spmm_core if A.segment_of_step is None
            else well_seg_spmm_core)
    return core(A, X, out=out)


def well_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """One-shot Y = A @ X: X is cast to the value dtype first."""
    return well_spmm_core(A, X.to(A.value_dtype).contiguous())

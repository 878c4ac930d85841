"""WELL kernel wrappers: the counterpart of the WELL SpMV and SpMM
sections of ``spmv_tpu/ops/pallas_kernels.py``.

SpMV (``csrc/well_spmv.cu``):

- K5a ``well_whole_core`` replaces ``_well_kernel`` (pallas_kernels.py:431,
  through ``well_spmv_padded``, :474): a ``DeviceWell`` in whole-x mode;
- K5b ``well_seg_core`` replaces ``_well_seg_kernel`` (:557, through
  ``_well_seg_call``, :622): a ``DeviceWell`` in segmented mode.

SpMM, X of shape (num_columns, k) (``csrc/well_spmm.cu``):

- K6a ``well_whole_spmm_core`` replaces ``_well_spmm_kernel`` (:1079,
  through ``well_spmm_padded``, :1256);
- K6b ``well_seg_spmm_core`` replaces ``_well_seg_spmm_kernel`` (:1121,
  through ``_well_seg_spmm_call``, :1188).

The ``.cu`` headers say what bounds them and how the simple designs
work.  ``well_spmv_core`` and ``well_spmm_core`` compose them after
``well_spmv`` (:682) and ``well_spmm`` (:1337): the chunk kernel of the
container's mode writes every row, then the CSR spill adds
(``csr_spmv_core`` / ``csr_spmm_core`` with ``accumulate=True``, which
leaves empty rows alone).  Nothing is padded, so the ``_padded`` entry
points have no separate counterpart; the SpMM kernels take the columns
in blocks, whose width ``well_column_block`` picks by a shared-memory
budget.  Not carried over: the TPU's VMEM limits on whole x (8 MB) and
on the segment (12 MB): the kernels read X directly, so K6a takes any X.

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
from spmv_tpu_torch.ops.csr_kernels import csr_spmm_core, csr_spmv_core
from spmv_tpu_torch.ops.spmv import well_chunks_reference

__all__ = ["well_whole_core", "well_seg_core", "well_spmv_core",
           "well_spmv", "well_whole_spmm_core", "well_seg_spmm_core",
           "well_spmm_core", "well_spmm", "well_column_block"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
LANE = 128
SMEM_MAX = 232448          # bytes of shared memory a block may have
# The SpMM kernels' column block: a block has 128 x kc threads (kc <=
# COLUMNS) and a tile of out_rows x kc x 128 values in shared memory, kc
# as wide as TILE_BUDGET bytes allow (at least one column).
COLUMNS = 8
TILE_BUDGET = 64 * 1024


def well_column_block(dtype: torch.dtype, k: int, out_rows: int) -> int:
    """Columns per block of the K6 kernels for k columns: as many as a
    tile of TILE_BUDGET bytes holds, at most COLUMNS and k.  Raises where
    one column's tile cannot fit a block's shared memory."""
    per_column = out_rows * LANE * dtype.itemsize
    if per_column > SMEM_MAX:
        raise KernelError(
            f"WELL SpMM: a {out_rows}-row tile needs {per_column} bytes of "
            f"shared memory per column, more than the {SMEM_MAX} a block "
            "can have")
    return max(1, min(k, COLUMNS, TILE_BUDGET // per_column))


def _prepare(what, A, x, out, segmented: bool, ndim: int = 1) -> bool:
    """Check A's chunk arrays and x (``ndim`` 1 for the SpMV, 2 for the
    SpMM's X); returns whether they lie on a CUDA device."""
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
    if x.dim() != ndim:
        raise KernelError(f"{what}: x must be {ndim}-D; got "
                          f"{tuple(x.shape)}")
    tail = tuple(x.shape[1:])
    check_vector("x", x, (A.num_columns,) + tail, dt)
    if out is not None:
        check_vector("out", out, (A.num_rows,) + tail, dt)
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


def _launch_spmm(wrapper, name, A, X, out, segmented, columns=None):
    """Launch ``name``'s SpMM kernel and count it on ``wrapper``:
    ``well_column_block``'s width of columns a block, or ``columns`` where
    a width measurement gives one."""
    from spmv_tpu_torch.ops._build import load_library

    k = X.shape[1]
    kc = columns or well_column_block(X.dtype, k, A.out_rows)
    Y = out if out is not None else torch.empty(
        (A.num_rows, k), dtype=X.dtype, device=X.device)
    if A.num_rows > 0 and k > 0:
        lib = load_library()
        seg = (A.segment_of_step.data_ptr(),) if segmented else ()
        rc = getattr(lib, f"{name}_launch")(
            _DTYPE_CODE[X.dtype], X.device.index, A.value.data_ptr(),
            A.local_index.data_ptr(), A.window_start.data_ptr(),
            A.group_of_chunk.data_ptr(), *seg, A.step_ptr.data_ptr(),
            A.chunks_per_step, A.out_rows, A.num_out_blocks, A.num_rows,
            A.num_columns, k, kc, X.data_ptr(), Y.data_ptr(), stream_of(X))
        raise_on(lib, rc, name)
        wrapper.launches += 1
    return Y


def well_whole_spmm_core(A, X: torch.Tensor,
                         out: torch.Tensor = None) -> torch.Tensor:
    """K6a: the WELL chunks' product (without the spill) for a whole-x
    ``DeviceWell``; X of shape (num_columns, k) and Y (num_rows, k),
    row-major, in the value dtype.  ``out`` (optional, not overlapping
    X) receives Y."""
    if not _prepare("well_whole_spmm", A, X, out, segmented=False, ndim=2):
        Y = well_chunks_reference(A, X)
        return Y if out is None else out.copy_(Y)
    return _launch_spmm(well_whole_spmm_core, "well_whole_spmm", A, X, out,
                        False)


well_whole_spmm_core.launches = 0


def well_seg_spmm_core(A, X: torch.Tensor,
                       out: torch.Tensor = None) -> torch.Tensor:
    """K6b: the WELL chunks' product for a segmented ``DeviceWell``;
    arguments as for ``well_whole_spmm_core``."""
    if not _prepare("well_seg_spmm", A, X, out, segmented=True, ndim=2):
        Y = well_chunks_reference(A, X)
        return Y if out is None else out.copy_(Y)
    return _launch_spmm(well_seg_spmm_core, "well_seg_spmm", A, X, out,
                        True)


well_seg_spmm_core.launches = 0


def well_spmm_core(A, X: torch.Tensor,
                   out: torch.Tensor = None) -> torch.Tensor:
    """Y = A @ X for a ``DeviceWell``: the chunk kernel of its mode (K6a
    or K6b) writes Y, then the CSR spill adds.  X of shape (num_columns,
    k) and Y (num_rows, k), row-major, in the value dtype; ``out``
    (optional, not overlapping X) receives Y."""
    if X.dim() != 2:
        raise KernelError(f"X must be (num_columns, k); got {tuple(X.shape)}")
    core = (well_whole_spmm_core if A.segment_of_step is None
            else well_seg_spmm_core)
    Y = core(A, X, out=out)
    if A.spill is not None:
        csr_spmm_core(A.spill, X, out=Y, accumulate=True)
    return Y


def well_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """One-shot Y = A @ X: X is cast to the value dtype first."""
    return well_spmm_core(A, X.to(A.value_dtype).contiguous())

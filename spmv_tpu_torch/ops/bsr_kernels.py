"""BSR kernel wrappers: the counterpart of the BSR SpMM section of
``spmv_tpu/ops/pallas_kernels.py`` (``csrc/bsr_spmm.cu``).

``bsr_spmm_core`` launches kernel K7, the one CUDA counterpart of both
Pallas kernels that ``bsr_spmm`` (pallas_kernels.py:954) dispatches to:
K7a ``_bsr_spmm_kernel`` (:896, X streamed a tile per block) and K7b
``_bsr_spmm_wholex_kernel`` (:918, X resident in VMEM up to 80 MB).  The
two differ only in where X lives on the TPU; on Hopper an X tile reaches
shared memory through L2 either way (the ``.cu`` header says more).

The dtype contract is ``bsr_spmm``'s (:957-962): X is cast to the
blocks' dtype (``bsr_spmm`` casts; ``bsr_spmm_core`` takes it so), float32
and float64 blocks give Y in their own type, bfloat16 blocks accumulate
in float32 and give float32 Y.  ``bsr_spmv`` is the SpMM of one column,
as the JAX ``spmv`` on ``DeviceBsr`` is.

K7 has two paths, chosen by ``bsr_path`` from the shape alone, never by
a failure: bfloat16 blocks of 64 or 128 rows with k a multiple of 8 and
16-byte aligned X and Y go to the tensor cores (``csrc/bsr_spmm_tc.cu``:
TMA and ``wgmma``); everything else (float32, float64, the other
bfloat16 shapes) to the register-tiled SIMT kernel
(``csrc/bsr_spmm.cu``).  A failed launch or tensor-map encode raises
``KernelError``.

The wrapper takes its plain version (``bsr_spmm_reference``) for CPU
tensors, launches its kernel for CUDA tensors, and raises for anything
else, with the launch discipline of ``ops/_launch.py``;
``bsr_spmm_core.launches`` counts its launches, and
``.tensor_core_launches`` and ``.simt_launches`` those of each path.
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
from spmv_tpu_torch.ops.spmv import accumulate_dtype, bsr_spmm_reference

__all__ = ["bsr_path", "bsr_spmm_core", "bsr_spmm", "bsr_spmv"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
TENSOR_CORE_BLOCK_ROWS = (64, 128)    # a block is one or two wgmma M tiles


def bsr_path(dtype: torch.dtype, block_rows: int, k: int, *ptrs: int) -> str:
    """K7's path for ``block_rows``-row blocks of ``dtype`` times k columns
    of X: ``"tensor_core"`` for bfloat16 blocks of 64 or 128 rows with k a
    multiple of 8 and every address in ``ptrs`` (X's and Y's) 16-byte
    aligned (what a TMA tensor map takes: 16-byte row strides and bases),
    else ``"simt"``."""
    if (dtype == torch.bfloat16 and block_rows in TENSOR_CORE_BLOCK_ROWS
            and k % 8 == 0 and all(p % 16 == 0 for p in ptrs)):
        return "tensor_core"
    return "simt"


def bsr_spmm_core(A, X: torch.Tensor,
                  out: torch.Tensor = None) -> torch.Tensor:
    """K7: Y = A @ X for a ``DeviceBsr``; X of shape (num_columns, k),
    row-major, in the blocks' dtype; Y of shape (num_rows, k) in its
    accumulator type.  ``out`` (optional, not overlapping X) receives
    Y."""
    dt = A.blocks.dtype
    if dt not in _DTYPE_CODE:
        raise KernelError(f"unsupported BSR block dtype {dt}")
    for name in ("block_col", "row_ptr"):
        t = getattr(A, name)
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise KernelError(f"BSR {name} must be contiguous int32")
    if not A.blocks.is_contiguous():
        raise KernelError("BSR blocks must be contiguous")
    if X.dim() != 2:
        raise KernelError(f"X must be (num_columns, k); got {tuple(X.shape)}")
    k = X.shape[1]
    acc = accumulate_dtype(dt)
    check_vector("X", X, (A.num_columns, k), dt)
    if out is not None:
        check_vector("out", out, (A.num_rows, k), acc)
        check_no_alias(X, out)
    tensors = (A.blocks, A.block_col, A.row_ptr, X) + (
        () if out is None else (out,))
    if not on_cuda("BSR", *tensors):
        Y = bsr_spmm_reference(A, X)
        return Y if out is None else out.copy_(Y)

    from spmv_tpu_torch.ops._build import load_library

    Y = out if out is not None else torch.empty(
        (A.num_rows, k), dtype=acc, device=X.device)
    if A.num_rows > 0 and k > 0:
        if A.blocks.data_ptr() % 16:
            raise KernelError("BSR blocks must start on a 16-byte boundary")
        lib = load_library()
        common = (A.blocks.data_ptr(), A.block_col.data_ptr(),
                  A.row_ptr.data_ptr(), A.block_rows)
        if bsr_path(dt, A.block_rows, k, X.data_ptr(),
                    Y.data_ptr()) == "tensor_core":
            rc = lib.bsr_tc_launch(
                X.device.index, *common, A.num_blocks, A.num_block_rows,
                A.num_rows, A.num_columns, k, X.data_ptr(), Y.data_ptr(),
                stream_of(X))
            raise_on(lib, rc, "bsr_spmm (tensor cores)")
            bsr_spmm_core.tensor_core_launches += 1
        else:
            rc = lib.bsr_simt_launch(
                _DTYPE_CODE[dt], X.device.index, *common, A.num_block_rows,
                A.num_rows, A.num_columns, k, X.data_ptr(), Y.data_ptr(),
                stream_of(X))
            raise_on(lib, rc, "bsr_spmm (SIMT)")
            bsr_spmm_core.simt_launches += 1
        bsr_spmm_core.launches += 1
    return Y


bsr_spmm_core.launches = 0
bsr_spmm_core.tensor_core_launches = 0
bsr_spmm_core.simt_launches = 0


def bsr_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """One-shot Y = A @ X: X is cast to the blocks' dtype first."""
    return bsr_spmm_core(A, X.to(A.blocks.dtype).contiguous())


def bsr_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: the SpMM of one column."""
    if x.dim() != 1:
        raise KernelError(f"x must be 1-D; got {tuple(x.shape)}")
    return bsr_spmm(A, x[:, None])[:, 0]

"""WELL-CW kernel wrappers: the counterpart of the WELL-CW SpMV section
of ``spmv_tpu/ops/pallas_kernels.py``.

- K3c ``wellcw_merged_core`` replaces ``_cw_merged_kernel``
  (pallas_kernels.py:1568), the merged level + stage-1 pool grid;
- K3a ``wellcw_level_core`` replaces ``_cw_kernel`` (:1374), a level of
  the fallback layout;
- K3b ``wellcw_pool_core`` replaces ``_cw_pool_kernel`` (:1484), the
  fallback pool and every tail pool.

All three are in ``csrc/wellcw_spmv.cu``, whose header says what bounds
them and how the simple design works.  ``wellcw_spmv_core`` composes
them after ``wellcw_spmv_padded`` / ``wellcw_spmv`` (:1821-1872): merged,
levels, pool, tail pools, then the CSR remainder (``csr_spmv_core``), in
stream order into one output of exactly ``num_rows`` entries.  The first
launch writes every row; the later ones add.  Nothing is padded, so the
JAX ``_padded`` entry point has no separate counterpart.

Each part wrapper takes its plain version (``ops/spmv.py``) for CPU
tensors, launches its kernel for CUDA tensors, and raises for anything
else, with the launch discipline of ``ops/_launch.py``; ``.launches``
on each counts its launches.  Not ported: the TPU's stride tables and
VMEM plumbing (``_cw_tables``, ``_cw_table_reuse``, ``_cw_vmem_guard``,
``_cw_vmem_params``): the kernels read x directly.
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
from spmv_tpu_torch.ops.csr_kernels import csr_spmv_core
from spmv_tpu_torch.ops.spmv import (
    cw_level_reference,
    cw_merged_reference,
    cw_pool_reference,
)

__all__ = ["wellcw_merged_core", "wellcw_level_core", "wellcw_pool_core",
           "wellcw_spmv_core", "wellcw_spmv"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
LANE = 128
POOL_SMEM_LIMIT = 48 * 1024     # bytes of the pool kernel's tile


def _prepare(what, part, x, num_rows, rows_covered, out, accumulate,
             indices):
    """Check a part and its vectors; returns (cuda, out or None)."""
    dt = part.value.dtype
    if dt not in _DTYPE_CODE:
        raise KernelError(f"unsupported WELL-CW value dtype {dt}")
    for t in (part.value,) + indices:
        if not t.is_contiguous():
            raise KernelError(f"{what}: matrix arrays must be contiguous")
    if any(t.dtype != torch.int32 for t in indices):
        raise KernelError(f"{what}: index arrays must be int32")
    if x.dim() != 1:
        raise KernelError(f"{what}: x must be 1-D")
    check_vector("x", x, (x.numel(),), dt)
    if num_rows > rows_covered:
        raise KernelError(f"{what}: {num_rows} rows, but the part covers "
                          f"only {rows_covered}")
    if out is not None:
        check_vector("out", out, (num_rows,), dt)
        check_no_alias(x, out)
    elif accumulate:
        raise KernelError("accumulate=True needs an out buffer")
    tensors = (part.value, x) + indices + (() if out is None else (out,))
    return on_cuda("WELL-CW", *tensors)


def _finish_plain(y, out, accumulate):
    if out is None:
        return y
    return out.add_(y) if accumulate else out.copy_(y)


def _output(out, num_rows, x):
    return out if out is not None else torch.empty(
        num_rows, dtype=x.dtype, device=x.device)


def wellcw_merged_core(mg, x: torch.Tensor, num_rows: int,
                       out: torch.Tensor = None,
                       accumulate: bool = False) -> torch.Tensor:
    """K3c: the merged grid's contribution to y (length num_rows), x of
    length num_columns in the value dtype; ``out`` receives it, or
    ``out + it`` with ``accumulate=True``."""
    if mg.kl != 64 * mg.cap + mg.pool_per_block:
        raise KernelError("merged grid: kl != 64 * cap + pool_per_block")
    cuda = _prepare("wellcw_merged", mg, x, num_rows,
                    mg.num_blocks * 64 * LANE, out, accumulate,
                    (mg.local_index, mg.anchor4))
    if not cuda:
        return _finish_plain(cw_merged_reference(mg, x, num_rows), out,
                             accumulate)

    from spmv_tpu_torch.ops._build import load_library

    y = _output(out, num_rows, x)
    if num_rows > 0:
        lib = load_library()
        rc = lib.wellcw_merged_launch(
            _DTYPE_CODE[x.dtype], x.device.index, mg.value.data_ptr(),
            mg.local_index.data_ptr(), mg.anchor4.data_ptr(), mg.d, mg.cap,
            mg.pool_per_block, mg.num_blocks, num_rows, x.numel(),
            x.data_ptr(), y.data_ptr(), int(accumulate), stream_of(x))
        raise_on(lib, rc, "wellcw_merged")
        wellcw_merged_core.launches += 1
    return y


wellcw_merged_core.launches = 0


def wellcw_level_core(lvl, x: torch.Tensor, num_rows: int,
                      out: torch.Tensor = None,
                      accumulate: bool = False) -> torch.Tensor:
    """K3a: a fallback level's contribution to y; arguments as for
    ``wellcw_merged_core``."""
    num_groups = lvl.group_ptr.numel() - 1
    cuda = _prepare("wellcw_level", lvl, x, num_rows, num_groups * LANE,
                    out, accumulate,
                    (lvl.local_index, lvl.anchor4, lvl.group_of_chunk,
                     lvl.group_ptr))
    if not cuda:
        return _finish_plain(cw_level_reference(lvl, x, num_rows), out,
                             accumulate)

    from spmv_tpu_torch.ops._build import load_library

    y = _output(out, num_rows, x)
    if num_rows > 0:
        lib = load_library()
        rc = lib.wellcw_level_launch(
            _DTYPE_CODE[x.dtype], x.device.index, lvl.value.data_ptr(),
            lvl.local_index.data_ptr(), lvl.anchor4.data_ptr(),
            lvl.group_ptr.data_ptr(), lvl.d, num_groups, num_rows,
            x.numel(), x.data_ptr(), y.data_ptr(), int(accumulate),
            stream_of(x))
        raise_on(lib, rc, "wellcw_level")
        wellcw_level_core.launches += 1
    return y


wellcw_level_core.launches = 0


def wellcw_pool_core(pool, x: torch.Tensor, num_rows: int,
                     out: torch.Tensor = None,
                     accumulate: bool = False) -> torch.Tensor:
    """K3b: a pooled level's contribution to y; arguments as for
    ``wellcw_merged_core``."""
    cuda = _prepare("wellcw_pool", pool, x, num_rows,
                    pool.num_blocks * pool.out_rows * LANE, out, accumulate,
                    (pool.local_index, pool.anchor4, pool.rowmap,
                     pool.block_ptr))
    if not cuda:
        return _finish_plain(cw_pool_reference(pool, x, num_rows), out,
                             accumulate)

    from spmv_tpu_torch.ops._build import load_library

    if pool.out_rows * 32 * x.element_size() > POOL_SMEM_LIMIT:
        raise KernelError(
            f"wellcw_pool: out_rows={pool.out_rows} needs more than "
            f"{POOL_SMEM_LIMIT} bytes of shared memory per block")
    y = _output(out, num_rows, x)
    if num_rows > 0:
        lib = load_library()
        rc = lib.wellcw_pool_launch(
            _DTYPE_CODE[x.dtype], x.device.index, pool.value.data_ptr(),
            pool.local_index.data_ptr(), pool.anchor4.data_ptr(),
            pool.rowmap.data_ptr(), pool.block_ptr.data_ptr(), pool.d,
            pool.out_rows, pool.num_blocks, num_rows, x.numel(),
            x.data_ptr(), y.data_ptr(), int(accumulate), stream_of(x))
        raise_on(lib, rc, "wellcw_pool")
        wellcw_pool_core.launches += 1
    return y


wellcw_pool_core.launches = 0


def wellcw_spmv_core(A, x: torch.Tensor,
                     out: torch.Tensor = None) -> torch.Tensor:
    """y = A @ x for a ``DeviceWellCw``: x of length num_columns and y of
    length num_rows, both in the value dtype.  ``out`` (optional, not
    overlapping x) receives y."""
    dt = A.value_dtype
    n = A.num_rows
    check_vector("x", x, (A.num_columns,), dt)
    if out is not None:
        check_vector("out", out, (n,), dt)
        check_no_alias(x, out)
    y = _output(out, n, x)
    written = False         # the first launch writes y, the later ones add
    if A.merged is not None:
        wellcw_merged_core(A.merged, x, n, out=y)
        written = True
    for lvl in A.levels:
        wellcw_level_core(lvl, x, n, out=y, accumulate=written)
        written = True
    for pool in ([] if A.pool is None else [A.pool]) + list(A.tail_pools):
        wellcw_pool_core(pool, x, n, out=y, accumulate=written)
        written = True
    if A.remainder is not None:
        csr_spmv_core(A.remainder, x, out=y, accumulate=written)
    return y


def wellcw_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """One-shot y = A @ x: x is cast to the value dtype first."""
    return wellcw_spmv_core(A, x.to(A.value_dtype).contiguous())

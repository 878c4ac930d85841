"""WELL-CW kernel wrappers: the counterpart of the WELL-CW SpMV and SpMM
sections of ``spmv_tpu/ops/pallas_kernels.py``.

SpMV (``csrc/wellcw_spmv.cu``):

- K3c ``wellcw_merged_core`` replaces ``_cw_merged_kernel``
  (pallas_kernels.py:1568), the merged level + stage-1 pool grid;
- K3a ``wellcw_level_core`` replaces ``_cw_kernel`` (:1374), a level of
  the fallback layout;
- K3b ``wellcw_pool_core`` replaces ``_cw_pool_kernel`` (:1484), the
  fallback pool and every tail pool.

SpMM, X of shape (num_columns, k) (``csrc/wellcw_spmm.cu``):

- K4a ``wellcw_merged_spmm_core`` replaces ``_cw_merged_spmm_kernel``
  (:1653);
- K4b ``wellcw_level_spmm_core`` replaces ``_cw_spmm_kernel`` (:1875);
- K4c ``wellcw_pool_spmm_core`` replaces ``_cw_pool_spmm_kernel``
  (:1920).

The ``.cu`` headers say what bounds the kernels and how the simple
designs work.  ``wellcw_spmv_core`` and ``wellcw_spmm_core`` compose
them after ``wellcw_spmv_padded`` / ``wellcw_spmv`` (:1821-1872) and
``_wellcw_spmm_padded`` / ``wellcw_spmm`` (:2035-2124): merged, levels,
pool, tail pools, then the CSR remainder (``csr_spmv_core`` /
``csr_spmm_core``), in stream order into one output of exactly
``num_rows`` rows.  The first launch writes every row; the later ones
add.  Nothing is padded, so the JAX ``_padded`` entry points have no
separate counterpart.

Each part wrapper takes its plain version (``ops/spmv.py``) for CPU
tensors, launches its kernel for CUDA tensors, and raises for anything
else, with the launch discipline of ``ops/_launch.py``; ``.launches``
on each counts its launches.  The SpMM kernels take the columns in
blocks; ``column_block`` picks the width.  Not ported: the TPU's stride
tables and VMEM plumbing (``_cw_tables``, ``_cw_tables3``,
``_cw_table_reuse``, ``_cw_vmem_guard``, ``_cw_vmem_params``,
``_CW_SPMM_UNROLL``): the kernels read x and X directly.
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
from spmv_tpu_torch.ops.spmv import (
    cw_level_reference,
    cw_merged_reference,
    cw_pool_reference,
)

__all__ = ["wellcw_merged_core", "wellcw_level_core", "wellcw_pool_core",
           "wellcw_spmv_core", "wellcw_spmv", "wellcw_merged_spmm_core",
           "wellcw_level_spmm_core", "wellcw_pool_spmm_core",
           "wellcw_spmm_core", "wellcw_spmm", "column_block"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
LANE = 128
WARP = 32
POOL_SMEM_LIMIT = 48 * 1024     # bytes of the SpMV pool kernel's tile
# The SpMM kernels' column blocks (csrc/wellcw_spmm.cu), passed to every
# launch: a level thread holds kb = min(k, COLUMNS) sums in registers; a
# pool tile holds rows x kb x 32 accumulators in shared memory, kb as
# wide as the tile's budget allows
# (K4a: 64 rows, 64 KB; K4c: out_rows, 32 KB, so that several one-warp
# blocks share an SM), at most COLUMNS (the kernels' widest register
# block of X values).  A block may use at most SMEM_MAX bytes.
COLUMNS = 8
TILE_BUDGET = {"merged": 64 * 1024, "pool": 32 * 1024}
SMEM_MAX = 232448


def column_block(kind: str, dtype: torch.dtype, k: int,
                 rows: int = 64) -> int:
    """Columns per block of an SpMM kernel: ``kind`` is "level",
    "merged" or "pool" (``rows`` is the pool tile's out_rows).  Raises
    where one column's tile cannot fit a block's shared memory."""
    if kind == "level":
        return max(1, min(k, COLUMNS))
    per_column = rows * WARP * dtype.itemsize
    if per_column > SMEM_MAX:
        raise KernelError(
            f"wellcw {kind} SpMM: a {rows}-row tile needs {per_column} "
            f"bytes of shared memory per column, more than the "
            f"{SMEM_MAX} a block can have")
    return max(1, min(k, COLUMNS, TILE_BUDGET[kind] // per_column))


def _prepare(what, part, x, num_rows, rows_covered, out, accumulate,
             indices, ndim=1):
    """Check a part and its vectors (x of ``ndim`` dimensions: 1 for the
    SpMV, 2 for the SpMM); returns whether they lie on a CUDA device."""
    dt = part.value.dtype
    if dt not in _DTYPE_CODE:
        raise KernelError(f"unsupported WELL-CW value dtype {dt}")
    for t in (part.value,) + indices:
        if not t.is_contiguous():
            raise KernelError(f"{what}: matrix arrays must be contiguous")
    if any(t.dtype != torch.int32 for t in indices):
        raise KernelError(f"{what}: index arrays must be int32")
    if x.dim() != ndim:
        raise KernelError(f"{what}: x must be {ndim}-D")
    check_vector("x", x, tuple(x.shape), dt)
    if num_rows > rows_covered:
        raise KernelError(f"{what}: {num_rows} rows, but the part covers "
                          f"only {rows_covered}")
    if out is not None:
        check_vector("out", out, (num_rows,) + tuple(x.shape[1:]), dt)
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
        (num_rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)


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


def _compose(A, x, out, parts):
    """A's product with x (m,) or X (m, k) through ``parts`` = (merged,
    level, pool, csr) wrappers, in stream order into one output of
    num_rows rows: the first launch writes, the later ones add."""
    merged_core, level_core, pool_core, csr_core = parts
    n = A.num_rows
    tail = tuple(x.shape[1:])
    check_vector("x", x, (A.num_columns,) + tail, A.value_dtype)
    if out is not None:
        check_vector("out", out, (n,) + tail, A.value_dtype)
        check_no_alias(x, out)
    y = _output(out, n, x)
    written = False
    if A.merged is not None:
        merged_core(A.merged, x, n, out=y)
        written = True
    for lvl in A.levels:
        level_core(lvl, x, n, out=y, accumulate=written)
        written = True
    for pool in ([] if A.pool is None else [A.pool]) + list(A.tail_pools):
        pool_core(pool, x, n, out=y, accumulate=written)
        written = True
    if A.remainder is not None:
        csr_core(A.remainder, x, out=y, accumulate=written)
    return y


def wellcw_spmv_core(A, x: torch.Tensor,
                     out: torch.Tensor = None) -> torch.Tensor:
    """y = A @ x for a ``DeviceWellCw``: x of length num_columns and y of
    length num_rows, both in the value dtype.  ``out`` (optional, not
    overlapping x) receives y."""
    if x.dim() != 1:
        raise KernelError(f"x must be 1-D; got {tuple(x.shape)}")
    return _compose(A, x, out, (wellcw_merged_core, wellcw_level_core,
                                wellcw_pool_core, csr_spmv_core))


def wellcw_spmv(A, x: torch.Tensor) -> torch.Tensor:
    """One-shot y = A @ x: x is cast to the value dtype first."""
    return wellcw_spmv_core(A, x.to(A.value_dtype).contiguous())


def wellcw_merged_spmm_core(mg, X: torch.Tensor, num_rows: int,
                            out: torch.Tensor = None,
                            accumulate: bool = False) -> torch.Tensor:
    """K4a: the merged grid's contribution to Y (num_rows, k), X of shape
    (num_columns, k), row-major, in the value dtype; ``out`` receives
    it, or ``out + it`` with ``accumulate=True``."""
    if mg.kl != 64 * mg.cap + mg.pool_per_block:
        raise KernelError("merged grid: kl != 64 * cap + pool_per_block")
    cuda = _prepare("wellcw_merged_spmm", mg, X, num_rows,
                    mg.num_blocks * 64 * LANE, out, accumulate,
                    (mg.local_index, mg.anchor4), ndim=2)
    if not cuda:
        return _finish_plain(cw_merged_reference(mg, X, num_rows), out,
                             accumulate)

    from spmv_tpu_torch.ops._build import load_library

    k = X.shape[1]
    kb = column_block("merged", X.dtype, k)
    Y = _output(out, num_rows, X)
    if num_rows > 0 and k > 0:
        lib = load_library()
        rc = lib.wellcw_merged_spmm_launch(
            _DTYPE_CODE[X.dtype], X.device.index, mg.value.data_ptr(),
            mg.local_index.data_ptr(), mg.anchor4.data_ptr(), mg.d, mg.cap,
            mg.pool_per_block, mg.num_blocks, num_rows, X.shape[0], k, kb,
            X.data_ptr(), Y.data_ptr(), int(accumulate), stream_of(X))
        raise_on(lib, rc, "wellcw_merged_spmm")
        wellcw_merged_spmm_core.launches += 1
    return Y


wellcw_merged_spmm_core.launches = 0


def wellcw_level_spmm_core(lvl, X: torch.Tensor, num_rows: int,
                           out: torch.Tensor = None,
                           accumulate: bool = False) -> torch.Tensor:
    """K4b: a fallback level's contribution to Y; arguments as for
    ``wellcw_merged_spmm_core``."""
    num_groups = lvl.group_ptr.numel() - 1
    cuda = _prepare("wellcw_level_spmm", lvl, X, num_rows,
                    num_groups * LANE, out, accumulate,
                    (lvl.local_index, lvl.anchor4, lvl.group_of_chunk,
                     lvl.group_ptr), ndim=2)
    if not cuda:
        return _finish_plain(cw_level_reference(lvl, X, num_rows), out,
                             accumulate)

    from spmv_tpu_torch.ops._build import load_library

    k = X.shape[1]
    kb = column_block("level", X.dtype, k)
    Y = _output(out, num_rows, X)
    if num_rows > 0 and k > 0:
        lib = load_library()
        rc = lib.wellcw_level_spmm_launch(
            _DTYPE_CODE[X.dtype], X.device.index, lvl.value.data_ptr(),
            lvl.local_index.data_ptr(), lvl.anchor4.data_ptr(),
            lvl.group_ptr.data_ptr(), lvl.d, num_groups, num_rows,
            X.shape[0], k, kb, X.data_ptr(), Y.data_ptr(), int(accumulate),
            stream_of(X))
        raise_on(lib, rc, "wellcw_level_spmm")
        wellcw_level_spmm_core.launches += 1
    return Y


wellcw_level_spmm_core.launches = 0


def wellcw_pool_spmm_core(pool, X: torch.Tensor, num_rows: int,
                          out: torch.Tensor = None,
                          accumulate: bool = False) -> torch.Tensor:
    """K4c: a pooled level's contribution to Y; arguments as for
    ``wellcw_merged_spmm_core``."""
    cuda = _prepare("wellcw_pool_spmm", pool, X, num_rows,
                    pool.num_blocks * pool.out_rows * LANE, out, accumulate,
                    (pool.local_index, pool.anchor4, pool.rowmap,
                     pool.block_ptr), ndim=2)
    if not cuda:
        return _finish_plain(cw_pool_reference(pool, X, num_rows), out,
                             accumulate)

    from spmv_tpu_torch.ops._build import load_library

    k = X.shape[1]
    kb = column_block("pool", X.dtype, k, rows=pool.out_rows)
    Y = _output(out, num_rows, X)
    if num_rows > 0 and k > 0:
        lib = load_library()
        rc = lib.wellcw_pool_spmm_launch(
            _DTYPE_CODE[X.dtype], X.device.index, pool.value.data_ptr(),
            pool.local_index.data_ptr(), pool.anchor4.data_ptr(),
            pool.rowmap.data_ptr(), pool.block_ptr.data_ptr(), pool.d,
            pool.out_rows, pool.num_blocks, num_rows, X.shape[0], k, kb,
            X.data_ptr(), Y.data_ptr(), int(accumulate), stream_of(X))
        raise_on(lib, rc, "wellcw_pool_spmm")
        wellcw_pool_spmm_core.launches += 1
    return Y


wellcw_pool_spmm_core.launches = 0


def wellcw_spmm_core(A, X: torch.Tensor,
                     out: torch.Tensor = None) -> torch.Tensor:
    """Y = A @ X for a ``DeviceWellCw``: X of shape (num_columns, k) and
    Y of shape (num_rows, k), row-major, in the value dtype.  ``out``
    (optional, not overlapping X) receives Y."""
    if X.dim() != 2:
        raise KernelError(f"X must be (num_columns, k); got {tuple(X.shape)}")
    return _compose(A, X, out, (wellcw_merged_spmm_core,
                                wellcw_level_spmm_core,
                                wellcw_pool_spmm_core, csr_spmm_core))


def wellcw_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """One-shot Y = A @ X: X is cast to the value dtype first."""
    return wellcw_spmm_core(A, X.to(A.value_dtype).contiguous())

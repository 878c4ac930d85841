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

The ``.cu`` headers say what bounds the kernels and how they work.
K3b and K3c stream their chunks in bulk copies through a ring in shared
memory, a cluster of CTAs an output block: ``launch_plan`` gives each
launch's plan from the shape alone, ``stream_plan`` a pool CTA's lanes,
the ring's stages and the part of x a K3c CTA stages in shared memory,
``cluster_size`` the CTAs a cluster.  ``wellcw_spmv_core`` and
``wellcw_spmm_core`` compose them after ``wellcw_spmv_padded`` /
``wellcw_spmv`` (:1821-1872) and ``_wellcw_spmm_padded`` /
``wellcw_spmm`` (:2035-2124): merged, levels, pool, tail pools, then the
CSR remainder (``csr_spmv_core`` / ``csr_spmm_core``), in stream order
into one output of exactly ``num_rows`` rows.  The first launch writes
every row; the later ones add.  Nothing is padded, so the JAX
``_padded`` entry points have no separate counterpart.

Each part wrapper takes its plain version (``ops/spmv.py``) for CPU
tensors, launches its kernel for CUDA tensors, and raises for anything
else, with the launch discipline of ``ops/_launch.py``; ``.launches``
on each counts its launches.  The SpMM kernels take the columns in
blocks; ``column_block`` picks the width, and ``spmm_plan`` their X
loads (both in ``ops/_launch.py``, shared with the CSR SpMM).  Not
ported: the TPU's stride tables and VMEM plumbing (``_cw_tables``,
``_cw_tables3``, ``_cw_table_reuse``, ``_cw_vmem_guard``,
``_cw_vmem_params``, ``_CW_SPMM_UNROLL``): the kernels read x and X
directly.
"""

from __future__ import annotations

import functools

import torch

from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.ops._launch import (
    check_no_alias,
    check_vector,
    column_block,
    on_cuda,
    raise_on,
    spmm_plan,
    stream_of,
    x_vector_loads,
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
           "wellcw_spmm_core", "wellcw_spmm", "column_block", "cluster_size",
           "stream_plan", "launch_plan", "x_vector_loads", "spmm_plan"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
LANE = 128
WARP = 32
MERGED_ROWS = 64                # groups of a merged output block
# K3b / K3c (csrc/wellcw_spmv.cu): a CTA keeps about RING_BYTES of its
# chunk stream in flight, in 2 .. MAX_STAGES stages of one chunk, and a
# K3c CTA stages up to WINDOW_BYTES of x in shared memory; a CTA keeps to
# PAIR_BYTES (two CTAs an SM: 228 KB, 1 KB reserved a CTA) where its
# tile and two stages fit them; BARRIER_BYTES of static shared memory
# hold the mbarriers
RING_BYTES = 48 * 1024
WINDOW_BYTES = 48 * 1024
PAIR_BYTES = (228 * 1024 - 2 * 1024) // 2
MAX_STAGES = 8
BARRIER_BYTES = (2 * MAX_STAGES + 1) * 8
# the cluster sizes the host picks from (the kernels also take 4): at the
# bench leg's shapes clusters of 4 ran K3b 1.5x and K3c 1.6x slower than
# clusters of 2 (they did not fit the card in one wave)
CLUSTER_SIZES = (1, 2)
# A block may use at most SMEM_MAX bytes of shared memory.
SMEM_MAX = 232448


def cluster_size(units: int, num_sms: int) -> int:
    """CTAs a cluster of K3b / K3c: the fewest of CLUSTER_SIZES whose grid
    of ``units`` clusters (output blocks x lane slices) covers the card's
    ``num_sms`` SMs; the most where none does."""
    for c in CLUSTER_SIZES:
        if units * c >= num_sms:
            return c
    return CLUSTER_SIZES[-1]


def stream_plan(rows: int, itemsize: int, rowmap: bool,
                window: int = 0) -> tuple:
    """(lanes, stages, window) of a K3b (``rowmap``) or K3c CTA: the widest
    of 128, 64 and 32 lanes whose (rows x lanes) tile and a ring of two
    stages fit a block's shared memory; within PAIR_BYTES where those fit
    it, else within the block's whole shared memory, the x ``window``
    (columns; 0 for K3b) up to WINDOW_BYTES, then as many stages of one
    chunk's lanes (8 x lanes values, indices and, for pools, rowmap
    entries) as RING_BYTES asks, at most MAX_STAGES and as many as fit.
    Raises where not even 32 lanes fit."""
    for lanes in (LANE, LANE // 2, WARP):
        tile = rows * lanes * itemsize
        stage = 8 * lanes * (itemsize + (8 if rowmap else 4))
        least = BARRIER_BYTES + tile + 2 * stage
        if least > SMEM_MAX:
            continue
        room = (PAIR_BYTES if least <= PAIR_BYTES else SMEM_MAX) - least
        win = min(window * itemsize, WINDOW_BYTES, room) // itemsize // 4 * 4
        stages = min(MAX_STAGES, 2 + (room - win * itemsize) // stage,
                     max(2, -(-RING_BYTES // stage)))
        return lanes, stages, win
    raise KernelError(
        f"wellcw_pool: a {rows}-row tile of {WARP} lanes needs "
        f"{rows * WARP * itemsize} bytes of shared memory, more than a "
        f"block can have beside its ring")


def launch_plan(part, itemsize: int, num_sms: int) -> dict:
    """The plan K3b (``part`` a pool) or K3c (the merged grid) launches
    with on a card of ``num_sms`` SMs: CTAs a cluster, lanes a CTA, ring
    stages and the columns of x a K3c CTA stages."""
    pool = hasattr(part, "rowmap")
    lanes, stages, window = stream_plan(
        part.out_rows if pool else MERGED_ROWS, itemsize, rowmap=pool,
        window=0 if pool else part.max_window)
    return {"cluster": cluster_size(part.num_blocks * (LANE // lanes),
                                    num_sms),
            "lanes": lanes, "stages": stages, "x_window_columns": window}


@functools.lru_cache(maxsize=None)
def _num_sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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
                    (mg.local_index, mg.anchor4, mg.x_window))
    if not cuda:
        return _finish_plain(cw_merged_reference(mg, x, num_rows), out,
                             accumulate)

    from spmv_tpu_torch.ops._build import load_library

    plan = launch_plan(mg, x.element_size(), _num_sms(x.device.index))
    y = _output(out, num_rows, x)
    if num_rows > 0:
        lib = load_library()
        rc = lib.wellcw_merged_launch(
            _DTYPE_CODE[x.dtype], x.device.index, mg.value.data_ptr(),
            mg.local_index.data_ptr(), mg.anchor4.data_ptr(),
            mg.x_window.data_ptr(), mg.d, mg.cap, mg.pool_per_block,
            mg.num_blocks, num_rows, x.numel(), x.data_ptr(), y.data_ptr(),
            int(accumulate), plan["stages"], plan["x_window_columns"],
            plan["cluster"], stream_of(x))
        raise_on(lib, rc, "wellcw_merged")
        wellcw_merged_core.launches += 1
    return y


wellcw_merged_core.launches = 0


def _level_index(lvl, device, what: str) -> torch.Tensor:
    """The index array K3a and K4b read for a level: ``local_index16``
    where the level has it (checked), else ``local_index``."""
    index = lvl.local_index16
    if index is None:
        return lvl.local_index
    if index.dtype != torch.int16 or index.shape != lvl.local_index.shape \
            or not index.is_contiguous() or index.device != device:
        raise KernelError(f"{what}: local_index16 must be a contiguous "
                          "int16 copy of local_index")
    return index


def wellcw_level_core(lvl, x: torch.Tensor, num_rows: int,
                      out: torch.Tensor = None,
                      accumulate: bool = False) -> torch.Tensor:
    """K3a: a fallback level's contribution to y; arguments as for
    ``wellcw_merged_core``.  The kernel reads ``local_index16`` where the
    level has it, else ``local_index``."""
    num_groups = lvl.group_ptr.numel() - 1
    cuda = _prepare("wellcw_level", lvl, x, num_rows, num_groups * LANE,
                    out, accumulate,
                    (lvl.local_index, lvl.anchor4, lvl.group_of_chunk,
                     lvl.group_ptr))
    if not cuda:
        return _finish_plain(cw_level_reference(lvl, x, num_rows), out,
                             accumulate)

    from spmv_tpu_torch.ops._build import load_library

    index = _level_index(lvl, x.device, "wellcw_level")
    y = _output(out, num_rows, x)
    if num_rows > 0:
        lib = load_library()
        rc = lib.wellcw_level_launch(
            _DTYPE_CODE[x.dtype], x.device.index, lvl.value.data_ptr(),
            index.data_ptr(), 8 * index.element_size(),
            lvl.anchor4.data_ptr(), lvl.group_ptr.data_ptr(), lvl.d,
            num_groups, num_rows, x.numel(), x.data_ptr(), y.data_ptr(),
            int(accumulate), stream_of(x))
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

    plan = launch_plan(pool, x.element_size(), _num_sms(x.device.index))
    y = _output(out, num_rows, x)
    if num_rows > 0:
        lib = load_library()
        rc = lib.wellcw_pool_launch(
            _DTYPE_CODE[x.dtype], x.device.index, pool.value.data_ptr(),
            pool.local_index.data_ptr(), pool.anchor4.data_ptr(),
            pool.rowmap.data_ptr(), pool.block_ptr.data_ptr(), pool.d,
            pool.out_rows, pool.num_blocks, num_rows, x.numel(),
            x.data_ptr(), y.data_ptr(), int(accumulate), plan["lanes"],
            plan["stages"], plan["cluster"], stream_of(x))
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
    it, or ``out + it`` with ``accumulate=True``.  The kernel takes the
    path ``spmm_plan`` gives."""
    if mg.kl != 64 * mg.cap + mg.pool_per_block:
        raise KernelError("merged grid: kl != 64 * cap + pool_per_block")
    if (mg.pool_ptr is None) != (mg.pool_per_block == 0):
        raise KernelError("merged grid: a pool list is needed exactly "
                          "where the grid has pool chunks")
    pool = () if mg.pool_ptr is None else (mg.pool_ptr, mg.pool_col)
    cuda = _prepare("wellcw_merged_spmm", mg, X, num_rows,
                    mg.num_blocks * 64 * LANE, out, accumulate,
                    (mg.local_index, mg.anchor4) + pool, ndim=2)
    if not cuda:
        return _finish_plain(cw_merged_reference(mg, X, num_rows), out,
                             accumulate)

    from spmv_tpu_torch.ops._build import load_library

    index = mg.level_index16
    if (index.dtype != torch.int16 or not index.is_contiguous()
            or index.numel() != mg.num_blocks * mg.lvl_per_block * 1024
            or index.device != X.device):
        raise KernelError("wellcw_merged_spmm: level_index16 must be the "
                          "level chunks' contiguous int16 indices")
    if mg.pool_ptr is not None and (mg.pool_value.dtype != X.dtype or
                                    mg.pool_value.device != X.device):
        raise KernelError("wellcw_merged_spmm: pool_value must be on X's "
                          "device in X's dtype")
    k = X.shape[1]
    Y = _output(out, num_rows, X)
    plan = spmm_plan(k, X.dtype, X.data_ptr(), Y.data_ptr())
    if num_rows > 0 and k > 0:
        lib = load_library()
        ptr = (lambda t: None if t is None else t.data_ptr())
        rc = lib.wellcw_merged_spmm_launch(
            _DTYPE_CODE[X.dtype], X.device.index, mg.value.data_ptr(),
            index.data_ptr(), mg.anchor4.data_ptr(), ptr(mg.pool_ptr),
            ptr(mg.pool_col), ptr(mg.pool_value), mg.d, mg.cap, mg.kl,
            mg.num_blocks * 64, num_rows, X.shape[0], k, plan["kb"],
            int(plan["vector_x"]), X.data_ptr(), Y.data_ptr(),
            int(accumulate), stream_of(X))
        raise_on(lib, rc, "wellcw_merged_spmm")
        wellcw_merged_spmm_core.launches += 1
    return Y


wellcw_merged_spmm_core.launches = 0


def wellcw_level_spmm_core(lvl, X: torch.Tensor, num_rows: int,
                           out: torch.Tensor = None,
                           accumulate: bool = False) -> torch.Tensor:
    """K4b: a fallback level's contribution to Y; arguments as for
    ``wellcw_merged_spmm_core``.  The kernel reads ``local_index16``
    where the level has it, else ``local_index``, on the path
    ``spmm_plan`` gives."""
    num_groups = lvl.group_ptr.numel() - 1
    cuda = _prepare("wellcw_level_spmm", lvl, X, num_rows,
                    num_groups * LANE, out, accumulate,
                    (lvl.local_index, lvl.anchor4, lvl.group_of_chunk,
                     lvl.group_ptr), ndim=2)
    if not cuda:
        return _finish_plain(cw_level_reference(lvl, X, num_rows), out,
                             accumulate)

    from spmv_tpu_torch.ops._build import load_library

    index = _level_index(lvl, X.device, "wellcw_level_spmm")
    k = X.shape[1]
    Y = _output(out, num_rows, X)
    plan = spmm_plan(k, X.dtype, X.data_ptr(), Y.data_ptr())
    if num_rows > 0 and k > 0:
        lib = load_library()
        rc = lib.wellcw_level_spmm_launch(
            _DTYPE_CODE[X.dtype], X.device.index, lvl.value.data_ptr(),
            index.data_ptr(), 8 * index.element_size(),
            lvl.anchor4.data_ptr(), lvl.group_ptr.data_ptr(), lvl.d,
            num_groups, num_rows, X.shape[0], k, plan["kb"],
            int(plan["vector_x"]), X.data_ptr(), Y.data_ptr(),
            int(accumulate), stream_of(X))
        raise_on(lib, rc, "wellcw_level_spmm")
        wellcw_level_spmm_core.launches += 1
    return Y


wellcw_level_spmm_core.launches = 0


def wellcw_pool_spmm_core(pool, X: torch.Tensor, num_rows: int,
                          out: torch.Tensor = None,
                          accumulate: bool = False) -> torch.Tensor:
    """K4c: a pooled level's contribution to Y; arguments as for
    ``wellcw_merged_spmm_core``.  The kernel reads the pool's row list
    (``list_rows``, ``list_len``, ``list_slice``, ``list_col``,
    ``list_value``) on the path ``spmm_plan`` gives; without
    ``accumulate`` it zeroes Y first, with it a row that owns no cell is
    not written."""
    cuda = _prepare("wellcw_pool_spmm", pool, X, num_rows,
                    pool.num_blocks * pool.out_rows * LANE, out, accumulate,
                    (pool.local_index, pool.anchor4, pool.rowmap,
                     pool.block_ptr, pool.list_rows, pool.list_len,
                     pool.list_slice, pool.list_col), ndim=2)
    if not cuda:
        return _finish_plain(cw_pool_reference(pool, X, num_rows), out,
                             accumulate)

    from spmv_tpu_torch.ops._build import load_library

    if pool.list_value.dtype != X.dtype or pool.list_value.device != X.device:
        raise KernelError("wellcw_pool_spmm: list_value must be on X's "
                          "device in X's dtype")
    k = X.shape[1]
    Y = _output(out, num_rows, X)
    plan = spmm_plan(k, X.dtype, X.data_ptr(), Y.data_ptr())
    if num_rows > 0 and k > 0:
        lib = load_library()
        rc = lib.wellcw_pool_spmm_launch(
            _DTYPE_CODE[X.dtype], X.device.index, pool.list_rows.data_ptr(),
            pool.list_len.data_ptr(), pool.list_slice.data_ptr(),
            pool.list_col.data_ptr(), pool.list_value.data_ptr(),
            pool.list_rows.numel(), num_rows,
            X.shape[0], k, plan["kb"], int(plan["vector_x"]), X.data_ptr(),
            Y.data_ptr(), int(accumulate), stream_of(X))
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

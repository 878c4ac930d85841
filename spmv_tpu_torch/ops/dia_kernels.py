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
value read).  K1 is one thread per row with coalesced diagonal and
shifted-x reads; K2, on the path ``dia_spmm_plan`` picks, loads a row's
one or two 16-byte groups a thread straight from device memory, or
streams slabs of X and of the diagonals into shared memory with bulk
asynchronous copies (``csrc/dia_spmm.cu`` explains both).

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

import functools

import torch

from spmv_tpu_torch.errors import KernelError
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

__all__ = ["dia_spmv_core", "dia_spmv", "dia_spmm_core", "dia_spmm",
           "dia_spmm_plan", "dia_spmm_windows"]

THREADS_PER_BLOCK = 256
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}

# K2's launch (csrc/dia_spmm.cu): the path codes, its threads a CTA
# (kThreads), the 16-byte groups a row the row path takes at most, the
# rows a slab thread owns (kSlabPasses), the diagonals a window holds at
# most (kMaxWindowDiags), the ring's stages, the shared memory a CTA's
# ring may take and a CTA's shared memory on an H100.
DIA_SPMM_PATHS = {"slab": 0, "row": 1}
SPMM_THREADS = 256
MAX_ROW_GROUPS = 2
SLAB_PASSES = 4
MAX_WINDOW_DIAGS = 8
SPMM_STAGES = (4, 8)
SPMM_RING_BYTES = 192 * 1024
SMEM_BYTES = 227 * 1024


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


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def dia_spmm_windows(offsets, span: int) -> list:
    """K2's windows of diagonals, as ``draw_windows`` in
    ``csrc/dia_spmm.cu`` draws them: ``[(first, last), ...]``, a new
    window where an offset falls below the one before, passes the
    window's first by more than ``span`` rows, or the window already
    holds ``MAX_WINDOW_DIAGS``; span -1 puts each diagonal alone."""
    offsets = [int(o) for o in offsets]
    if not offsets:
        return []
    wins, first = [], 0
    for d in range(1, len(offsets)):
        if (offsets[d] < offsets[d - 1] or offsets[d] - offsets[first] > span
                or d - first >= MAX_WINDOW_DIAGS):
            wins.append((first, d - 1))
            first = d
    wins.append((first, len(offsets) - 1))
    return wins


@functools.lru_cache(maxsize=256)
def dia_spmm_plan(k: int, dtype, offsets=(), x_aligned: bool = True,
                  y_aligned: bool = True, path: str = None) -> dict:
    """The launch K2 makes for k right-hand sides of ``dtype`` over a
    matrix with these diagonal ``offsets``, X's and Y's first bytes
    16-byte aligned or not.

    - ``width``: V = 16 / itemsize columns a group (one 16-byte load);
      ``groups``: ceil(k / V) a row.
    - ``row_ok``: k is one or two whole groups (``MAX_ROW_GROUPS``) and
      X and Y are aligned, so a thread's row is one or two 16-byte loads
      and stores.
    - ``path``: ``"row"`` (a thread a row, 16-byte loads from device
      memory; only where ``row_ok``) or ``"slab"`` (bulk-copied slabs in
      shared memory; any k, any alignment).  ``path=None`` takes the row
      path wherever it can run and the slab path elsewhere, the faster
      of the two at each shape measured on an H100 (PERF.md §6); a path
      asked for that cannot run raises.
    - the slab path's plan: ``passes`` rows a thread, a pass of 256 /
      groups rows apart, so ``rows`` = passes x 256 / groups a unit; past
      256 groups a unit is one row (``passes`` 1) and ``chunk_cols`` =
      256 V columns, ``chunks`` units a row.  ``span`` (the window rule's
      rows: a pass, -1 in chunks), ``windows`` (``dia_spmm_windows``),
      ``max_span`` and ``wdiags`` (the widest and fullest window),
      ``x_stage_bytes`` and ``d_stage_bytes`` (a stage's X slab and one
      diagonal's data slab, each with 32 bytes for aligning its ends to
      16), ``stages`` and ``smem_bytes`` (the CTA's dynamic shared
      memory, at most ``SMEM_BYTES``: more diagonals than that holds
      raise).
    """
    item = torch.empty(0, dtype=dtype).element_size()
    V = 16 // item
    groups = -(-k // V)
    row_ok = (k % V == 0 and groups <= MAX_ROW_GROUPS and x_aligned
              and y_aligned)
    if path is None:
        path = "row" if row_ok else "slab"
    if path not in DIA_SPMM_PATHS:
        raise KernelError(f"no K2 path {path!r}: {sorted(DIA_SPMM_PATHS)}")
    if path == "row" and not row_ok:
        raise KernelError(
            f"K2's row path needs k = {V} or {2 * V} and 16-byte aligned X "
            f"and Y (k={k}, X aligned {x_aligned}, Y aligned {y_aligned})")
    if groups <= SPMM_THREADS:
        span = SPMM_THREADS // max(groups, 1)
        passes, chunk_cols, chunks = SLAB_PASSES, max(k, 1), 1
        rows = passes * span
    else:
        rows, passes, chunk_cols = 1, 1, SPMM_THREADS * V
        chunks, span = -(-k // chunk_cols), -1
    windows = dia_spmm_windows(offsets, span)
    offs = [int(o) for o in offsets]
    max_span = max((offs[b] - offs[a] for a, b in windows), default=0)
    wdiags = max((b - a + 1 for a, b in windows), default=1)
    if chunks > 1:
        x_stage = _up16(chunk_cols * item + 32)
    else:
        x_stage = _up16((max_span + rows) * k * item + 32)
    d_stage = _up16(rows * item + 32)
    stage = x_stage + wdiags * d_stage
    # beside the ring: its two barriers a stage, the offsets and the
    # windows' bounds
    fixed = 4 * (2 * len(offs) + 2)
    stages = min(max(len(windows) + 1, SPMM_STAGES[0]), SPMM_STAGES[1])
    while stages > 2 and (stages * stage > SPMM_RING_BYTES or
                          stages * (stage + 16) + fixed > SMEM_BYTES):
        stages -= 1
    smem = stages * (stage + 16) + fixed
    if smem > SMEM_BYTES:
        raise KernelError(
            f"K2's slab path needs {smem} bytes of shared memory for "
            f"{len(offs)} diagonals at k={k}; a CTA has {SMEM_BYTES}")
    return {"path": path, "width": V, "groups": groups, "row_ok": row_ok,
            "passes": passes, "rows": rows, "chunk_cols": chunk_cols,
            "chunks": chunks, "span": span, "windows": windows,
            "max_span": max_span, "wdiags": wdiags,
            "x_stage_bytes": x_stage, "d_stage_bytes": d_stage,
            "stages": stages, "smem_bytes": smem}


def dia_spmm_core(A, X: torch.Tensor, out: torch.Tensor = None,
                  path: str = None):
    """Y = A @ X for X of shape (num_columns, k), row-major, in the
    storage dtype; Y is (num_rows, k).  ``out`` must not overlap X.
    ``path`` asks ``dia_spmm_plan`` for a K2 path (None: its pick)."""
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
    if path is not None:
        # a path that cannot take these inputs raises on either device
        dia_spmm_plan(k, dt, A.offsets, X.data_ptr() % 16 == 0,
                      out is None or out.data_ptr() % 16 == 0, path)
    if not cuda:
        Y = dia_spmm_reference(A, X)
        return out.copy_(Y) if out is not None else Y

    from spmv_tpu_torch.ops._build import load_library

    n = A.num_rows
    Y = out if out is not None else torch.empty((n, k), dtype=dt,
                                                device=X.device)
    if n > 0 and k > 0:
        plan = dia_spmm_plan(k, dt, A.offsets, X.data_ptr() % 16 == 0,
                             Y.data_ptr() % 16 == 0, path)
        lib = load_library()
        rc = lib.dia_spmm_launch(
            _DTYPE_CODE[dt], X.device.index, A.data.data_ptr(),
            A.offsets_dev.data_ptr(), A.num_diagonals, n, A.num_columns,
            k, X.data_ptr(), Y.data_ptr(), DIA_SPMM_PATHS[plan["path"]],
            plan["rows"], plan["chunk_cols"], plan["chunks"],
            plan["stages"], plan["span"], plan["max_span"], plan["wdiags"],
            plan["x_stage_bytes"], plan["d_stage_bytes"], stream_of(X))
        raise_on(lib, rc, "dia_spmm")
        dia_spmm_core.launches += 1
    return Y


dia_spmm_core.launches = 0


def dia_spmm(A, X: torch.Tensor) -> torch.Tensor:
    """One-shot Y = A @ X: X is cast to the storage dtype first."""
    return dia_spmm_core(A, X.to(A.data.dtype).contiguous())


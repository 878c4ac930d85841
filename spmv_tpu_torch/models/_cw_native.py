"""ctypes bridge to the native WELL-CW packer (csrc/cwpack.cpp).

Same on-demand build + graceful-degradation pattern as
models._well_native: ``available()`` is False without a compiler, and
WellCwMatrix._build falls back to the pure numpy packers (whose
semantics the native core mirrors exactly — tests/test_cw_native.py
asserts bit-identical outputs for both level and pool modes).

The port's copy of ``spmv_tpu/models/_cw_native.py``: the same code,
importing the port's copies instead of the JAX package, except where the
library comes from: ``spmv_tpu_torch._hostlib.host_library`` builds
``csrc/cwpack.cpp`` into ``spmv_tpu_torch/_build/host/``, named by a
hash of the source, and the committed ``csrc/build/*.so`` are never
read. Without a compiler the Python fallback runs; it is host packing
with the same output.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from spmv_tpu_torch._hostlib import host_library

__all__ = ["available", "pack_level", "pack_pool", "sort_perm"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


class _CwPacked(ctypes.Structure):
    _fields_ = [
        ("num_chunks", ctypes.c_int64),
        ("value", ctypes.POINTER(ctypes.c_double)),
        ("local_index", ctypes.POINTER(ctypes.c_int32)),
        ("anchor4", ctypes.POINTER(ctypes.c_int32)),
        ("grp", ctypes.POINTER(ctypes.c_int32)),
        ("rank", ctypes.POINTER(ctypes.c_int64)),
        ("rowmap", ctypes.POINTER(ctypes.c_int32)),
        ("num_spill", ctypes.c_int64),
        ("spill_idx", ctypes.POINTER(ctypes.c_int64)),
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = host_library("cwpack.cpp")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.cw_pack.restype = ctypes.POINTER(_CwPacked)
        lib.cw_pack.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int64,
        ]
        lib.cw_pack_free.restype = None
        lib.cw_pack_free.argtypes = [ctypes.POINTER(_CwPacked)]
        lib.rc_sort_perm.restype = None
        lib.rc_sort_perm.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _call(num_rows, num_columns, rows, cols, vals, d, cap, min_pop,
          pool_groups):
    lib = _load()
    if lib is None:
        raise RuntimeError("native cwpack unavailable")
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    res = lib.cw_pack(
        int(num_rows), int(num_columns),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(rows.size), int(d), int(cap), float(min_pop),
        int(pool_groups),
    )
    try:
        p = res.contents
        nc = p.num_chunks
        if nc:
            value = np.ctypeslib.as_array(
                p.value, shape=(nc, 8, 128)).copy()
            loc = np.ctypeslib.as_array(
                p.local_index, shape=(nc, 8, 128)).copy()
            anchor4 = np.ctypeslib.as_array(
                p.anchor4, shape=(nc,)).copy()
            grp = np.ctypeslib.as_array(p.grp, shape=(nc,)).copy()
            rank = np.ctypeslib.as_array(p.rank, shape=(nc,)).copy()
            rowmap = (
                np.ctypeslib.as_array(
                    p.rowmap, shape=(nc, 8, 128)).copy()
                if pool_groups > 0 else None
            )
        else:
            value = np.zeros((0, 8, 128), np.float64)
            loc = np.zeros((0, 8, 128), np.int32)
            anchor4 = np.zeros(0, np.int32)
            grp = np.zeros(0, np.int32)
            rank = np.zeros(0, np.int64)
            rowmap = (np.zeros((0, 8, 128), np.int32)
                      if pool_groups > 0 else None)
        ns = p.num_spill
        spill = (np.ctypeslib.as_array(p.spill_idx, shape=(ns,)).copy()
                 if ns else np.zeros(0, np.int64))
        return value, loc, anchor4, grp, rank, rowmap, spill
    finally:
        lib.cw_pack_free(res)


def pack_level(num_rows, num_columns, rows, cols, vals, d, cap,
               min_pop):
    """Native _pack_level; returns (CwLevel, spilled) like the numpy
    packer."""
    from spmv_tpu_torch.models.wellcw import CwLevel

    value, loc, anchor4, grp, rank, _rm, spill = _call(
        num_rows, num_columns, rows, cols, vals, d, cap, min_pop, 0)
    lvl = CwLevel(d=d, value=value, local_index=loc, anchor4=anchor4,
                  group_of_chunk=grp, cap=cap, rank_of_chunk=rank)
    return lvl, spill


def pack_pool(num_rows, num_columns, rows, cols, vals, d, cap,
              pool_groups):
    """Native _pack_pool; returns (CwPoolLevel | None, spilled)."""
    from spmv_tpu_torch.models.wellcw import CwPoolLevel

    if np.asarray(rows).size == 0:
        return None, np.zeros(0, dtype=np.int64)
    value, loc, anchor4, grp, _rank, rowmap, spill = _call(
        num_rows, num_columns, rows, cols, vals, d, cap, 0.0,
        pool_groups)
    if value.shape[0] == 0:
        return None, np.arange(np.asarray(rows).size, dtype=np.int64)
    pool = CwPoolLevel(d=d, value=value, local_index=loc,
                       anchor4=anchor4, rowmap=rowmap,
                       pool_of_chunk=grp, pool_groups=pool_groups,
                       cap=cap)
    return pool, spill


def sort_perm(rows, cols):
    """Stable (row, col) sort permutation via the native radix core —
    equivalent to np.lexsort((cols, rows)), ~6x faster at 10M+."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native cwpack unavailable")
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    perm = np.empty(rows.size, dtype=np.int64)
    lib.rc_sort_perm(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        int(rows.size),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return perm

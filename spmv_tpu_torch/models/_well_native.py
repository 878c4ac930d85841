"""ctypes bridge to the native WELL packer (csrc/wellpack.cpp).

Same on-demand build + graceful-degradation pattern as
spmv_tpu.perfmodel.native: ``available()`` is False without a
compiler, and WellMatrix._build falls back to the pure Python packer
(whose semantics the native core mirrors exactly —
tests/test_well_native.py asserts bit-identical outputs).

The port's copy of ``spmv_tpu/models/_well_native.py``: the same code,
importing the port's copies instead of the JAX package, except where the
library comes from: ``spmv_tpu_torch._hostlib.host_library`` builds
``csrc/wellpack.cpp`` into ``spmv_tpu_torch/_build/host/``, named by a
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

__all__ = ["available", "pack"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


class _WellPacked(ctypes.Structure):
    _fields_ = [
        ("num_chunks", ctypes.c_int64),
        ("value", ctypes.POINTER(ctypes.c_double)),
        ("local_index", ctypes.POINTER(ctypes.c_int32)),
        ("window_start", ctypes.POINTER(ctypes.c_int32)),
        ("group_of_chunk", ctypes.POINTER(ctypes.c_int32)),
        ("num_spill", ctypes.c_int64),
        ("spill_rows", ctypes.POINTER(ctypes.c_int64)),
        ("spill_cols", ctypes.POINTER(ctypes.c_int64)),
        ("spill_vals", ctypes.POINTER(ctypes.c_double)),
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = host_library("wellpack.cpp")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.well_pack.restype = ctypes.POINTER(_WellPacked)
        lib.well_pack.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.well_pack_free.restype = None
        lib.well_pack_free.argtypes = [ctypes.POINTER(_WellPacked)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def pack(num_rows, num_columns, row_ptr, cols, vals, window_rows,
         max_rounds):
    """Native WELL packing; returns the same tuple the Python packer
    produces: (value, local_index, window_start, group_of_chunk,
    spill_rows, spill_cols, spill_vals)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native wellpack unavailable")
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    res = lib.well_pack(
        int(num_rows), int(num_columns),
        row_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(window_rows), int(max_rounds),
    )
    try:
        p = res.contents
        nc = p.num_chunks
        value = np.ctypeslib.as_array(
            p.value, shape=(nc, 8, 128)
        ).copy()
        loc = np.ctypeslib.as_array(
            p.local_index, shape=(nc, 8, 128)
        ).copy()
        ws = np.ctypeslib.as_array(
            p.window_start, shape=(nc, 8)
        ).copy()
        grp = np.ctypeslib.as_array(
            p.group_of_chunk, shape=(nc,)
        ).copy()
        ns = p.num_spill
        if ns:
            sp_r = np.ctypeslib.as_array(
                p.spill_rows, shape=(ns,)
            ).copy()
            sp_c = np.ctypeslib.as_array(
                p.spill_cols, shape=(ns,)
            ).copy()
            sp_v = np.ctypeslib.as_array(
                p.spill_vals, shape=(ns,)
            ).copy()
        else:
            sp_r = np.empty(0, dtype=np.int64)
            sp_c = np.empty(0, dtype=np.int64)
            sp_v = np.empty(0, dtype=np.float64)
        return value, loc, ws, grp, sp_r, sp_c, sp_v
    finally:
        lib.well_pack_free(res)

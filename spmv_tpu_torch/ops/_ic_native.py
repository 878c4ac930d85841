"""ctypes bridge to the native incomplete factorizers (csrc/ic0.cpp).

``available()`` is False without a compiler, and ops.incomplete (and
``models.reorder.find_new_order_coloring``) then fall back to the
pure-Python loops, whose numeric semantics the native kernels mirror
(tests/test_torch_incomplete.py holds the two in lockstep).

The port's copy of ``spmv_tpu/ops/_ic_native.py``: the same code,
except where the library comes from: ``spmv_tpu_torch._hostlib.
host_library`` builds ``csrc/ic0.cpp`` into ``spmv_tpu_torch/_build/
host/``, named by a hash of the source, and the committed
``csrc/build/*.so`` are never read.  The entry points check their
arrays with exceptions rather than ``assert``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from spmv_tpu_torch._hostlib import host_library

__all__ = ["available", "ic0_inplace", "ilu0_inplace",
           "level_schedule", "greedy_color"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = host_library("ic0.cpp")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.spmv_ic0_factor.argtypes = [
            ctypes.c_int64, i64p, i32p, f64p]
        lib.spmv_ic0_factor.restype = ctypes.c_int64
        lib.spmv_ilu0_factor.argtypes = [
            ctypes.c_int64, i64p, i32p, f64p, i64p]
        lib.spmv_ilu0_factor.restype = ctypes.c_int64
        lib.spmv_level_schedule.argtypes = [
            ctypes.c_int64, i64p, i32p, ctypes.c_int32, i64p]
        lib.spmv_level_schedule.restype = ctypes.c_int64
        lib.spmv_greedy_color.argtypes = [
            ctypes.c_int64, i64p, i64p, i64p, i64p,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.spmv_greedy_color.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native ic0 library unavailable")
    return lib


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _check_values(vals: np.ndarray) -> None:
    if vals.dtype != np.float64 or not vals.flags.c_contiguous:
        raise ValueError("vals must be a contiguous float64 array "
                         "(it is updated in place)")


def ic0_inplace(rp: np.ndarray, cols: np.ndarray,
                vals: np.ndarray) -> int:
    """Run the native IC(0) update on column-sorted lower-pattern CSR
    arrays (diag last per row); ``vals`` is modified in place.
    Returns 0 on success or (bad_row + 1)."""
    lib = _library()
    _check_values(vals)
    rp = np.ascontiguousarray(rp, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    return int(lib.spmv_ic0_factor(
        len(rp) - 1, _ptr(rp, ctypes.c_int64),
        _ptr(cols, ctypes.c_int32), _ptr(vals, ctypes.c_double)))


def ilu0_inplace(rp: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 diag_slot: np.ndarray) -> int:
    """Run the native ILU(0) elimination on column-sorted full-pattern
    CSR arrays; ``vals`` is modified in place.  Returns 0 on success
    or (pivot_row + 1)."""
    lib = _library()
    _check_values(vals)
    rp = np.ascontiguousarray(rp, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    diag_slot = np.ascontiguousarray(diag_slot, np.int64)
    return int(lib.spmv_ilu0_factor(
        len(rp) - 1, _ptr(rp, ctypes.c_int64),
        _ptr(cols, ctypes.c_int32), _ptr(vals, ctypes.c_double),
        _ptr(diag_slot, ctypes.c_int64)))


def level_schedule(rp: np.ndarray, cols: np.ndarray, n: int,
                   lower: bool) -> np.ndarray:
    """Per-row dependency levels via the native kernel."""
    lib = _library()
    rp = np.ascontiguousarray(rp, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    out = np.zeros(n, dtype=np.int64)
    lib.spmv_level_schedule(
        n, _ptr(rp, ctypes.c_int64), _ptr(cols, ctypes.c_int32),
        1 if lower else 0, _ptr(out, ctypes.c_int64))
    return out


def greedy_color(sptr: np.ndarray, sadj: np.ndarray,
                 visit: np.ndarray) -> np.ndarray:
    """Greedy first-fit coloring in visit order (native)."""
    lib = _library()
    n = len(sptr) - 1
    sptr = np.ascontiguousarray(sptr, np.int64)
    sadj = np.ascontiguousarray(sadj, np.int64)
    visit = np.ascontiguousarray(visit, np.int64)
    color = np.full(n, -1, dtype=np.int64)
    scratch = np.zeros(n + 2, dtype=np.uint8)
    lib.spmv_greedy_color(
        n, _ptr(sptr, ctypes.c_int64), _ptr(sadj, ctypes.c_int64),
        _ptr(visit, ctypes.c_int64), _ptr(color, ctypes.c_int64),
        scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return color

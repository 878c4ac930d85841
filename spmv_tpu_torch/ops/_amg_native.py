"""ctypes bridge to the native SA-AMG aggregation (csrc/amg.cpp).

``available()`` is False without a compiler, and ops.amg then falls back
to the pure-Python aggregation loop, whose semantics the native pass
mirrors exactly (tests/test_torch_amg.py holds the two in lockstep).

The port's copy of ``spmv_tpu/ops/_amg_native.py``: the same code,
except where the library comes from: ``spmv_tpu_torch._hostlib.
host_library`` builds ``csrc/amg.cpp`` into ``spmv_tpu_torch/_build/
host/``, named by a hash of the source, and the committed
``csrc/build/*.so`` are never read.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from spmv_tpu_torch._hostlib import host_library

__all__ = ["available", "aggregate"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = host_library("amg.cpp")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.spmv_amg_aggregate.argtypes = [
            ctypes.c_int64, i64p, i32p, i64p, i64p]
        lib.spmv_amg_aggregate.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def aggregate(rp: np.ndarray, cols: np.ndarray):
    """Greedy aggregation over a strength-graph CSR; returns
    (agg ids (n,), count) like ops.amg._aggregate_py."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native amg aggregation unavailable")
    n = len(rp) - 1
    rp = np.ascontiguousarray(rp, np.int64)
    cols = np.ascontiguousarray(cols, np.int32)
    agg = np.empty(n, np.int64)
    scratch = np.empty(n, np.int64)
    cnt = lib.spmv_amg_aggregate(
        n,
        rp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        agg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return agg, int(cnt)

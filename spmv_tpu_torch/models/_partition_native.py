"""ctypes bridge to the native partitioner cores (csrc/partition.cpp).

Same on-demand build + graceful-degradation pattern as
models._cw_native: ``available()`` is False without a compiler, and
``partition_graph`` falls back to the pure-Python matching/FM loops.
``hem_match`` is bit-identical to the Python loop for the same visit
order (pinned by tests/test_reorder_quality.py); ``fm_refine`` runs
the same algorithm but its heap breaks equal-gain ties by LARGEST
node id where Python's heapq breaks them by smallest, so refined
partitions can differ between the two implementations (the test
bounds the cut gap instead of asserting equality).

The native cores replace exactly the two per-node/per-move Python
loops that dominated wall time on irregular graphs (100k-row
random_sparse at P=8: 181 s python -> ~2 s native; the vectorized
numpy coarsening/contraction/recursion stays in reorder.py).

The port's copy of ``spmv_tpu/models/_partition_native.py``: the same
code, importing the port's copies instead of the JAX package, except
where the library comes from: ``spmv_tpu_torch._hostlib.host_library``
builds ``csrc/partition.cpp`` into ``spmv_tpu_torch/_build/host/``,
named by a hash of the source, and the committed ``csrc/build/*.so`` are
never read. Without a compiler the Python fallback runs; it is host
packing with the same output.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

from spmv_tpu_torch._hostlib import host_library

__all__ = ["available", "hem_match", "fm_refine"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = host_library("partition.cpp")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.hem_match.restype = ctypes.c_int64
        lib.hem_match.argtypes = [
            ctypes.c_int64, _I64P, _I64P, _I64P, _I64P, _I64P,
        ]
        lib.fm_refine.restype = ctypes.c_int64
        lib.fm_refine.argtypes = [
            ctypes.c_int64, _I64P, _I64P, _I64P, _I64P, _U8P,
            ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def hem_match(ptr, adj, wgt, order):
    """Greedy heavy-edge matching; returns (cid, nc)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native partition unavailable")
    ptr = _i64(ptr)
    adj = _i64(adj)
    wgt = _i64(wgt)
    order = _i64(order)
    n = ptr.size - 1
    cid = np.empty(n, dtype=np.int64)
    nc = lib.hem_match(
        n,
        ptr.ctypes.data_as(_I64P), adj.ctypes.data_as(_I64P),
        wgt.ctypes.data_as(_I64P), order.ctypes.data_as(_I64P),
        cid.ctypes.data_as(_I64P),
    )
    return cid, int(nc)


def fm_refine(ptr, adj, wgt, vwgt, side, limit_a, limit_b,
              passes=4):
    """Boundary FM passes; mutates and returns ``side`` (bool)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native partition unavailable")
    ptr = _i64(ptr)
    adj = _i64(adj)
    wgt = _i64(wgt)
    vwgt = _i64(vwgt)
    s8 = np.ascontiguousarray(side, dtype=np.uint8)
    lib.fm_refine(
        ptr.size - 1,
        ptr.ctypes.data_as(_I64P), adj.ctypes.data_as(_I64P),
        wgt.ctypes.data_as(_I64P), vwgt.ctypes.data_as(_I64P),
        s8.ctypes.data_as(_U8P),
        float(limit_a), float(limit_b), int(passes),
    )
    return s8.astype(bool)

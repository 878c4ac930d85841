"""ctypes bridge to the native simulation core (csrc/simcache.cpp).

All entry points degrade gracefully: ``available()`` is False when no
compiler is present, and callers fall back to the pure Python
simulator, which gives the same miss counts.

The port's copy of ``spmv_tpu/perfmodel/native.py``: the same code,
except where the library comes from: ``spmv_tpu_torch._hostlib.
host_library`` builds ``csrc/simcache.cpp`` into
``spmv_tpu_torch/_build/host/``, named by a hash of the source, and
``csrc/build/`` is never read or written.  Without a compiler the
Python replay runs; it is host code, not a device fallback.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from spmv_tpu_torch._hostlib import host_library

__all__ = ["available", "library_path", "replay_interleaved",
           "replay_single"]

# (refs_done, refs_total, is_warmup) — the SIGALRM-progress analogue
_PROGRESS_FN = ctypes.CFUNCTYPE(
    None, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_path: Optional[str] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _path, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = host_library("simcache.cpp")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.simcache_replay_interleaved_progress
        except (OSError, AttributeError):
            return None
        lib.simcache_replay_interleaved_progress.restype = ctypes.c_int
        lib.simcache_replay_interleaved_progress.argtypes = [
            ctypes.c_int,      # policy
            ctypes.c_uint64,   # cache_lines
            ctypes.c_uint64,   # line_size
            ctypes.c_int,      # num_threads
            ctypes.POINTER(ctypes.c_uint64),   # addresses
            ctypes.POINTER(ctypes.c_int32),    # numa_domains
            ctypes.POINTER(ctypes.c_uint64),   # offsets
            ctypes.c_int,      # num_numa_domains
            ctypes.c_int,      # warmup
            ctypes.c_uint64,   # seed
            ctypes.POINTER(ctypes.c_int64),    # misses_out
            _PROGRESS_FN,      # progress callback (may be null)
            ctypes.c_uint64,   # progress_interval_ms
        ]
        _lib, _path = lib, path
        return _lib


def available() -> bool:
    return _load() is not None


def library_path() -> Optional[str]:
    """The loaded native core's path (under ``_build/host/``), or None
    where the Python replay runs."""
    _load()
    return _path


def replay_interleaved(
    policy: int,
    cache_lines: int,
    line_size: int,
    strings: Sequence[Tuple[np.ndarray, np.ndarray]],
    num_numa_domains: int,
    warmup: bool = False,
    seed: int = 1,
    progress=None,
    progress_interval: float = 0.0,
) -> np.ndarray:
    """Run the interleaved replay in C++; returns (P, domains) int64."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native simcache library unavailable")
    P = len(strings)
    offsets = np.zeros(P + 1, dtype=np.uint64)
    for p, (a, _) in enumerate(strings):
        offsets[p + 1] = offsets[p] + a.size
    total = int(offsets[-1])
    addresses = np.empty(total, dtype=np.uint64)
    numas = np.empty(total, dtype=np.int32)
    for p, (a, d) in enumerate(strings):
        lo, hi = int(offsets[p]), int(offsets[p + 1])
        addresses[lo:hi] = a
        numas[lo:hi] = d

    misses = np.zeros(P * num_numa_domains, dtype=np.int64)
    cb = _PROGRESS_FN()
    if progress is not None and progress_interval > 0:
        def _cb(done, total, is_warmup):
            progress(int(done), int(total), bool(is_warmup))
        cb = _PROGRESS_FN(_cb)
    rc = lib.simcache_replay_interleaved_progress(
        int(policy),
        int(cache_lines),
        int(line_size),
        P,
        addresses.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        numas.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        int(num_numa_domains),
        1 if warmup else 0,
        int(seed) & 0xFFFFFFFFFFFFFFFF,
        misses.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cb,
        int(progress_interval * 1000),
    )
    if rc != 0:
        raise RuntimeError(f"simcache_replay_interleaved failed: rc={rc}")
    return misses.reshape(P, num_numa_domains)


def replay_single(
    policy: int,
    cache_lines: int,
    line_size: int,
    addresses: np.ndarray,
    numa_domains: np.ndarray,
    num_numa_domains: int,
    seed: int = 1,
) -> np.ndarray:
    out = replay_interleaved(
        policy, cache_lines, line_size,
        [(addresses, numa_domains)], num_numa_domains, seed=seed,
    )
    return out[0]

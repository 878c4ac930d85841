"""ctypes bridge to the native Matrix Market parser (csrc/mmparse.cpp).

``load_matrix_native(path)`` parses .mtx / .mtx.gz / SuiteSparse
.tar.gz files in C++ (zlib + ustar + strtod fast path) and returns a
``MatrixMarket`` identical to the Python parser's output (semantics
defined by spmv_tpu.io.matrix_market; cross-checked in tests).
Falls back gracefully: ``available()`` is False when the library
cannot be built/loaded.

The port's copy of ``spmv_tpu/io/native.py``: the same code, importing
the port's copies instead of the JAX package, except where the library
comes from: ``spmv_tpu_torch._hostlib.host_library`` builds
``csrc/mmparse.cpp`` into ``spmv_tpu_torch/_build/host/``, named by a
hash of the source, and the committed ``csrc/build/*.so`` are never
read. Without a compiler the Python fallback runs; it is host packing
with the same output.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from spmv_tpu_torch._hostlib import host_library

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.io.matrix_market import MatrixMarket

__all__ = ["available", "load_matrix_native"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_FIELDS = {0: "real", 1: "integer", 2: "pattern", 3: "complex"}
_SYMMETRIES = {0: "general", 1: "symmetric", 2: "skew-symmetric",
               3: "hermitian"}


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = host_library("mmparse.cpp", ("-lz",))
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.mmparse_parse_file.restype = ctypes.c_void_p
        lib.mmparse_parse_file.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int
        ]
        try:
            lib.mmparse_parse_file_member.restype = ctypes.c_void_p
            lib.mmparse_parse_file_member.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_int,
            ]
            lib.mmparse_copy_imag.restype = None
            lib.mmparse_copy_imag.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)
            ]
        except AttributeError:
            return None  # stale .so from pre-streaming sources
        for f in ("mmparse_rows", "mmparse_cols", "mmparse_nnz"):
            getattr(lib, f).restype = ctypes.c_int64
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        for f in ("mmparse_field", "mmparse_symmetry"):
            getattr(lib, f).restype = ctypes.c_int
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        lib.mmparse_copy.restype = None
        lib.mmparse_copy.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.mmparse_free.restype = None
        lib.mmparse_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def load_matrix_native(
    path: str, expand_symmetry: bool = False
) -> MatrixMarket:
    lib = _load()
    if lib is None:
        raise MatrixError("native mmparse library unavailable")
    errbuf = ctypes.create_string_buffer(512)
    # SuiteSparse member convention (matrix-market.cpp:760-764): a
    # tarball <stem>.tar.gz holds <stem>/<stem>.mtx — select exactly
    # that member so auxiliary matrices (e.g. <stem>_b.mtx) stored
    # earlier in the archive cannot be picked by accident.
    spath = os.fspath(path)
    base = os.path.basename(spath)
    for ext in (".tar.gz", ".tgz"):
        if base.endswith(ext):
            stem = base[: -len(ext)]
            member = f"{stem}/{stem}.mtx".encode()
            break
    else:
        member = b""
    h = lib.mmparse_parse_file_member(
        spath.encode(), member, errbuf, len(errbuf)
    )
    if not h:
        raise MatrixError(
            f"native parse failed for {path!r}: "
            f"{errbuf.value.decode(errors='replace')}"
        )
    try:
        rows = int(lib.mmparse_rows(h))
        cols = int(lib.mmparse_cols(h))
        nnz = int(lib.mmparse_nnz(h))
        field = _FIELDS[lib.mmparse_field(h)]
        symmetry = _SYMMETRIES[lib.mmparse_symmetry(h)]
        ri = np.empty(nnz, dtype=np.int32)
        ci = np.empty(nnz, dtype=np.int32)
        vals = np.empty(nnz, dtype=np.float64)
        lib.mmparse_copy(
            h,
            ri.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ci.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        imag = None
        if field == "complex":
            imag = np.empty(nnz, dtype=np.float64)
            lib.mmparse_copy_imag(
                h, imag.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            )
    finally:
        lib.mmparse_free(h)

    if field == "pattern":
        vals = np.ones(nnz, dtype=np.float64)
    mm = MatrixMarket(
        object="matrix",
        format="coordinate",
        field=field,
        symmetry=symmetry,
        num_rows=rows,
        num_columns=cols,
        num_entries=nnz,
        rows_1based=ri,
        cols_1based=ci,
        values=vals,
        values_imag=imag,
    )
    return mm.expand_symmetry() if expand_symmetry else mm

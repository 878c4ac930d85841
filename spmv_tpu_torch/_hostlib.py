"""Build the repository's C++ host helpers (``csrc/*.cpp``) for the port.

The port's ctypes loaders (``io/native.py``, ``models/_cw_native.py``,
``models/_well_native.py``, ``models/_partition_native.py``) compile
their source with the host C++ compiler at first use into
``spmv_tpu_torch/_build/host/`` (listed in ``.gitignore``).  Each library
is named by a hash of its source and flags, so an edited source is
rebuilt, and the port never reads or writes ``csrc/build/``.  A build
writes a temporary file and renames it into place, so concurrent
processes never load a half-written library.  Without a compiler the
loaders fall back to their Python packers, which give the same output.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

__all__ = ["host_library"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def host_library(source: str, link: tuple = ()) -> Optional[str]:
    """Path of the library built from ``csrc/<source>``, compiled if this
    source has none yet; None when the source or the compiler is
    missing or the compile fails."""
    src = CSRC_DIR / source
    try:
        code = src.read_bytes()
    except OSError:
        return None
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(link)).encode() + code)
    lib = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return str(lib)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(src), *link]
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return str(lib)

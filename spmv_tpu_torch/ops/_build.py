"""Build and load the port's CUDA kernels.

The kernels in ``spmv_tpu_torch/csrc`` have a plain C interface and are
compiled with ``nvcc`` into one shared library for Hopper (``sm_90a``),
then loaded with ``ctypes``; no PyTorch header is compiled, which keeps
the build to seconds.  The library is built at first use into
``spmv_tpu_torch/_build/`` (listed in ``.gitignore``), named by a hash of
the sources and flags, under a file lock so concurrent processes build
it once.  A missing ``nvcc`` or a failed compile raises
``KernelBuildError`` naming the command and its output; nothing falls
back to another path.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from spmv_tpu.errors import KernelError

__all__ = ["KernelBuildError", "build_library", "find_nvcc",
           "load_library", "nvcc_version"]

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("dia_spmv.cu", "dia_spmm.cu")
HEADERS = ("dia_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",     # registers / spills of each kernel in the log
)
DEFAULT_CUDA_HOME = "/usr/local/cuda"


class KernelBuildError(KernelError):
    """nvcc is missing or failed; the message names the command."""


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then $PATH, then the default CUDA
    install."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(on_path)
    cands.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
        f"{DEFAULT_CUDA_HOME}/bin); the CUDA kernels are built with: "
        + " ".join(("nvcc",) + NVCC_FLAGS + ("-o", "<lib>.so")
                   + SOURCES))


def nvcc_version() -> str:
    """First line of ``nvcc --version`` naming the release."""
    r = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                       text=True, timeout=60, check=False)
    lines = [ln for ln in r.stdout.splitlines() if "release" in ln]
    return (lines or r.stdout.splitlines() or ["unknown"])[-1].strip()


def _digest() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build_library(build_dir: Path = None) -> tuple:
    """Compile the kernels if the current sources have no library yet.

    Returns ``(path, log)``: the library and the compiler's output (empty
    when an earlier build was reused).
    """
    build_dir = Path(build_dir or BUILD_DIR)
    lib = build_dir / f"libspmv_tpu_torch_{_digest()}.so"
    if lib.exists():
        return lib, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib, ""
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC_DIR / s) for s in SOURCES)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=600, check=False)
        except (OSError, subprocess.SubprocessError) as e:
            raise KernelBuildError(
                f"could not run: {' '.join(cmd)}: {e}") from e
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed with exit code {r.returncode}: "
                f"{' '.join(cmd)}\n{r.stderr}{r.stdout}")
        os.replace(tmp, lib)
        return lib, r.stderr + r.stdout


_PTR = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    lib.dia_spmv_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _I32, _I64, _I64, _PTR, _PTR, _PTR,
        _I32, _PTR]
    lib.dia_spmv_launch.restype = _I32
    lib.dia_spmm_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _I32, _I64, _I64, _I32, _PTR, _PTR,
        _I32, _PTR]
    lib.dia_spmm_launch.restype = _I32
    lib.spmv_tpu_torch_error_string.argtypes = [_I32]
    lib.spmv_tpu_torch_error_string.restype = ctypes.c_char_p
    return lib

"""Build and load the port's CUDA kernels.

The kernels in ``spmv_tpu_torch/csrc`` have a plain C interface and are
compiled with ``nvcc`` for Hopper (``sm_90a``), one process per source,
all started together, then linked into one shared library and loaded
with ``ctypes``; no PyTorch header is compiled, which keeps the build to
seconds.  The library is built at first use into
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

from spmv_tpu_torch.errors import KernelError

__all__ = ["KernelBuildError", "build_library", "find_nvcc",
           "load_library", "nvcc_version"]

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("dia_spmv.cu", "dia_spmm.cu", "wellcw_spmv.cu", "wellcw_spmm.cu",
           "csr_spmv.cu", "csr_spmm.cu", "ell_spmv.cu", "ell_spmm.cu",
           "well_spmv.cu", "well_spmm.cu", "bsr_spmm.cu", "bsr_spmm_tc.cu",
           "fused_vcycle.cu", "tri_solve.cu")
HEADERS = ("dia_common.cuh", "cw_common.cuh", "mbarrier.cuh",
           "spmm_rows.cuh", "csr_rows.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
        + " ".join(("nvcc",) + NVCC_FLAGS + ("-c", "<source>.cu"))
        + ", then nvcc -shared -o <lib>.so <objects>")


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
        nvcc = find_nvcc()
        objs = [tmp.with_name(f"{tmp.name}.{Path(src).stem}.o")
                for src in SOURCES]
        try:
            log = _run_all([
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC_DIR / src)]
                for src, obj in zip(SOURCES, objs)])
            log += _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                              str(tmp), *map(str, objs)]])
        except KernelBuildError:
            tmp.unlink(missing_ok=True)
            raise
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        os.replace(tmp, lib)
        return lib, log


def _run_all(cmds) -> str:
    """Run the commands side by side; raise ``KernelBuildError`` naming
    the first that failed, after all have ended.  Returns their output."""
    procs = []
    try:
        for cmd in cmds:
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    except OSError as e:
        for _, p in procs:
            p.kill()
            p.wait()
        raise KernelBuildError(f"could not run: {' '.join(cmd)}: {e}") from e
    log, failed = "", None
    for cmd, p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        log += err + out
        if p.returncode != 0 and failed is None:
            failed = (cmd, p.returncode, err + out)
    if failed is not None:
        cmd, rc, text = failed
        raise KernelBuildError(
            f"nvcc failed with exit code {rc}: {' '.join(cmd)}\n{text}")
    return log


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
    lib.wellcw_level_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _I32, _PTR, _PTR, _I32, _I64, _I64, _I64,
        _PTR, _PTR, _I32, _PTR]
    lib.wellcw_level_launch.restype = _I32
    lib.wellcw_pool_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I64, _I64,
        _I64, _PTR, _PTR, _I32, _I32, _I32, _I32, _PTR]
    lib.wellcw_pool_launch.restype = _I32
    lib.wellcw_merged_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I64, _I64,
        _I64, _PTR, _PTR, _I32, _I32, _I32, _I32, _PTR]
    lib.wellcw_merged_launch.restype = _I32
    lib.csr_spmv_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _PTR, _I64, _I64, _PTR, _I64, _I64, _I32,
        _PTR, _PTR, _I32, _I32, _PTR]
    lib.csr_spmv_launch.restype = _I32
    lib.ell_spmv_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _I32, _I32, _I64, _I64, _PTR, _PTR, _I32,
        _I32, _PTR]
    lib.ell_spmv_launch.restype = _I32
    lib.ell_spmm_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _I32, _I64, _I64, _I32, _I32, _I32, _PTR,
        _PTR, _I32, _PTR]
    lib.ell_spmm_launch.restype = _I32
    lib.wellcw_level_spmm_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _I32, _PTR, _PTR, _I32, _I64, _I64, _I64,
        _I32, _I32, _I32, _PTR, _PTR, _I32, _PTR]
    lib.wellcw_level_spmm_launch.restype = _I32
    lib.wellcw_pool_spmm_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _I32,
        _I32, _I32, _PTR, _PTR, _I32, _PTR]
    lib.wellcw_pool_spmm_launch.restype = _I32
    lib.wellcw_merged_spmm_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32,
        _I64, _I64, _I64, _I32, _I32, _I32, _PTR, _PTR, _I32, _PTR]
    lib.wellcw_merged_spmm_launch.restype = _I32
    lib.csr_spmm_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _PTR, _I64,
        _I64, _I32, _I32, _I32, _I32, _I32, _PTR, _PTR, _I32, _PTR]
    lib.csr_spmm_launch.restype = _I32
    lib.well_whole_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
        _PTR, _I32, _I32, _I64, _I64, _I64, _PTR, _PTR, _I32, _PTR]
    lib.well_whole_launch.restype = _I32
    lib.well_seg_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
        _PTR, _PTR, _I32, _I32, _I64, _I64, _I64, _PTR, _PTR, _I32, _PTR]
    lib.well_seg_launch.restype = _I32
    lib.well_whole_spmm_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
        _PTR, _I32, _I32, _I64, _I64, _I64, _I32, _I32, _I32, _PTR, _PTR,
        _PTR]
    lib.well_whole_spmm_launch.restype = _I32
    lib.well_seg_spmm_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
        _PTR, _PTR, _I32, _I32, _I64, _I64, _I64, _I32, _I32, _I32, _PTR,
        _PTR, _PTR]
    lib.well_seg_spmm_launch.restype = _I32
    lib.bsr_simt_launch.argtypes = [
        _I32, _I32, _PTR, _PTR, _PTR, _I32, _I64, _I64, _I64, _I32, _PTR,
        _PTR, _PTR]
    lib.bsr_simt_launch.restype = _I32
    lib.bsr_tc_launch.argtypes = [
        _I32, _PTR, _PTR, _PTR, _I32, _I64, _I64, _I64, _I64, _I32, _PTR,
        _PTR, _PTR]
    lib.bsr_tc_launch.restype = _I32
    lib.fused_vcycle_launch.argtypes = [
        _I32, _I32, _I32, _I32, _I64, _PTR, _PTR, _PTR, _PTR, _I32, _PTR]
    lib.fused_vcycle_launch.restype = _I32
    lib.tri_solve_launch.argtypes = [
        _I32, _I32, _I32, _PTR, _PTR, _I32, _I32, _PTR, _PTR, _PTR, _PTR,
        _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _PTR, _PTR, _I32, _I32, _PTR,
        ctypes.POINTER(ctypes.c_longlong)]
    lib.tri_solve_launch.restype = _I32
    lib.spmv_tpu_torch_error_string.argtypes = [_I32]
    lib.spmv_tpu_torch_error_string.restype = ctypes.c_char_p
    return lib

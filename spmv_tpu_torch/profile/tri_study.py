"""cuSPARSE's sparse triangular solve (SpSV) as the ``tri_solve`` kernel's
yardstick, where ``torch.triangular_solve`` on a sparse CSR factor does
not run (on an H100 with torch 2.11 it ended its process with SIGFPE).

``Spsv(t, lower, unit, b, z)`` holds cuSPARSE's state for one host CSR
triangle ``t`` (``ops.incomplete``'s factors: IC(0)'s L and L^T,
ILU(0)'s unit L and U) on the card: the matrix, b and z descriptors, the
work buffer and the analysis, done once; calling it runs
``cusparseSpSV_solve`` (z = T^-1 b) on the current stream.  The C side
is ``profile/tri_study.cu``, built here with nvcc and ``-lcusparse`` into
``spmv_tpu_torch/_build/study/``.  No path of the port calls it:
``chip_smoke.py`` phase 28 times it beside the kernel.  Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

__all__ = ["Spsv"]

HERE = Path(__file__).resolve().parent
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (once per source) and load ``profile/tri_study.cu``."""
    from spmv_tpu_torch.ops._build import (
        BUILD_DIR,
        NVCC_FLAGS,
        KernelBuildError,
        find_nvcc,
    )

    src = HERE / "tri_study.cu"
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out_dir = BUILD_DIR / "study"
    so = out_dir / f"tri_study_{tag}.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        lib_dir = Path(nvcc).resolve().parent.parent / "lib64"
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), str(src),
               f"-L{lib_dir}", "-lcusparse", "-Xlinker", f"-rpath={lib_dir}"]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                           check=False)
        if r.returncode != 0:
            raise KernelBuildError(f"nvcc failed with exit code "
                                   f"{r.returncode}: {' '.join(cmd)}\n"
                                   f"{r.stderr}{r.stdout}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.spsv_create.argtypes = [_I, _L, _L, _P, _P, _P, _I, _I, _P, _P, _P,
                                ctypes.POINTER(_P)]
    lib.spsv_create.restype = _I
    lib.spsv_solve.argtypes = [_P, _P]
    lib.spsv_solve.restype = _I
    lib.spsv_destroy.argtypes = [_P]
    lib.spsv_destroy.restype = None
    lib.spsv_error.argtypes = [_I]
    lib.spsv_error.restype = ctypes.c_char_p
    return lib


class Spsv:
    """cuSPARSE SpSV for one host CSR triangle, b -> z on the card (both
    float32 or float64, length n); the analysis runs here, once."""

    def __init__(self, t, lower: bool, unit: bool, b: torch.Tensor,
                 z: torch.Tensor):
        self._lib = _library()
        dev = b.device
        rp = np.asarray(t.row_ptr)[:t.num_rows + 1]
        self._keep = (
            torch.from_numpy(rp.astype(np.int32)).to(dev),
            torch.from_numpy(np.asarray(t.column_index[:rp[-1]],
                                        np.int32)).to(dev),
            torch.from_numpy(np.asarray(t.value[:rp[-1]])).to(
                device=dev, dtype=b.dtype),
            b, z)
        state = _P()
        rc = self._lib.spsv_create(
            _DTYPE_CODE[b.dtype], t.num_rows, int(rp[-1]),
            *(x.data_ptr() for x in self._keep[:3]), int(lower), int(unit),
            b.data_ptr(), z.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(state))
        self._check(rc, "spsv_create")
        self._state = state

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"cuSPARSE {what}: "
                               f"{self._lib.spsv_error(rc).decode()} ({rc})")

    def __call__(self) -> torch.Tensor:
        stream = torch.cuda.current_stream(self._keep[3].device).cuda_stream
        self._check(self._lib.spsv_solve(self._state, stream), "spsv_solve")
        return self._keep[4]

    def close(self) -> None:
        if self._state:
            self._lib.spsv_destroy(self._state)
            self._state = None

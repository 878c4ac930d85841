"""Kernels of the port: ``triad``, ``dia``, ``wellcw``, ``well`` and
``bsr``.

The counterpart of ``spmv_tpu/kernels.py``.  ``Kernel`` and
``_MatrixKernel`` are the port's copies of the JAX package's base classes
(loading, conversion, ``describe``, ``flops_per_run``), without the
simulation mode's memory layouts and reference strings, which come with
that mode.  Each kernel runs on ``device`` in ``dtype`` (by default the
card, through ``default_device``, and ``default_value_dtype``); the byte
counts are the JAX package's at the tensor's value width.  ``dia``,
``wellcw``, ``well`` and ``bsr`` have an SpMV and an SpMM step (``bsr``'s
SpMV is its SpMM of one column).  Every other kernel name raises: it is
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.io.matrix_market import MatrixMarket, load_matrix
from spmv_tpu_torch.models.bsr import BLOCK, BsrMatrix
from spmv_tpu_torch.models.device import (
    DeviceBsr,
    DeviceDia,
    DeviceWell,
    DeviceWellCw,
    default_device,
    default_value_dtype,
)
from spmv_tpu_torch.models.dia import DiaMatrix
from spmv_tpu_torch.models.well import WellMatrix
from spmv_tpu_torch.models.wellcw import WellCwMatrix
from spmv_tpu_torch.ops.bsr_kernels import bsr_spmm_core
from spmv_tpu_torch.ops.dia_kernels import dia_spmm_core, dia_spmv_core
from spmv_tpu_torch.ops.spmv import accumulate_dtype
from spmv_tpu_torch.ops.triad import triad
from spmv_tpu_torch.ops.well_kernels import well_spmm_core, well_spmv_core
from spmv_tpu_torch.ops.wellcw_kernels import (
    wellcw_spmm_core,
    wellcw_spmv_core,
)

__all__ = ["Kernel", "TriadKernel", "DiaKernel", "WellCwKernel",
           "WellKernel", "BsrKernel", "make_kernel", "KERNEL_NAMES"]

IDX = 4     # bytes of a stored int32 index

KERNEL_NAMES = (
    "triad",
    "coo",
    "coo-atomic",
    "csr",
    "ell",
    "hybrid",
    "dia",
    "well",
    "wellcw",
    "bsr",
    "xla-csr",
)


class _PingPong:
    """Two buffers a chained step alternates between: each step reads one
    and writes the other, so no iteration allocates and no output
    aliases its input."""

    def __init__(self, first: torch.Tensor):
        self.bufs = (first, torch.empty_like(first))

    def other(self, v: torch.Tensor) -> torch.Tensor:
        return self.bufs[1] if v is self.bufs[0] else self.bufs[0]


def _chain_output(y: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Feed y back as the next iteration's input (``spmv_tpu.kernels.
    _chain_output``): a rectangular matrix takes y's leading entries and
    keeps the previous input's tail."""
    if y.shape == v.shape:
        return y
    if y.shape[0] >= v.shape[0]:
        return y[: v.shape[0]]
    return torch.cat([y, v[y.shape[0]:]])


def _chained(core, A, v0: torch.Tensor):
    """``(step, (v0, A))`` for the timing harness: ``step(v, A)`` is
    ``core(A, v)`` fed back as the next input, through two buffers in
    turn on a square matrix."""
    if A.num_rows == A.num_columns:
        bufs = _PingPong(v0)

        def step(v, A):
            return core(A, v, out=bufs.other(v))
    else:
        def step(v, A):
            return _chain_output(core(A, v[: A.num_columns]), v)

    return step, (v0, A)


class Kernel:
    """Base kernel interface (the JAX package's ``Kernel``)."""

    name: str = "kernel"

    def init(self, verbose: bool = False) -> None:
        raise NotImplementedError

    def run_fn(self):
        """Returns (step, args): a chainable step and its arguments."""
        raise NotImplementedError

    def flops_per_run(self) -> int:
        raise NotImplementedError

    def bytes_per_run(self) -> int:
        """Minimum device-memory traffic of one run (streaming lower
        bound)."""
        raise NotImplementedError

    def traffic_split(self):
        """(stream_bytes, resident_rw_bytes): the part of bytes_per_run
        that streams once per run vs the r+w volume over buffers a
        chained caller keeps (``perfmodel.tiling.roofline_time``)."""
        return self.bytes_per_run(), 0

    def describe(self) -> dict:
        return {"name": self.name}


class TriadKernel(Kernel):
    """STREAM triad on the port's device."""

    name = "triad"

    def __init__(self, num_entries: int, device=None,
                 dtype: Optional[torch.dtype] = None):
        if num_entries <= 0:
            raise KernelError("triad: num_entries must be positive")
        self.num_entries = num_entries
        self.device = torch.device(device or default_device())
        self.dtype = dtype or default_value_dtype()

    def init(self, verbose: bool = False) -> None:
        pass

    def run_fn(self):
        n = self.num_entries
        b = torch.ones(n, dtype=self.dtype, device=self.device)
        c = torch.full((n,), 2.0, dtype=self.dtype, device=self.device)
        bufs = _PingPong(b)

        def step(v, c):
            return triad(v, c, 3.1, out=bufs.other(v))

        return step, (b, c)

    def flops_per_run(self) -> int:
        return 2 * self.num_entries

    def bytes_per_run(self) -> int:
        return 3 * self.dtype.itemsize * self.num_entries

    def describe(self) -> dict:
        return {"name": self.name, "num_entries": self.num_entries}


class _MatrixKernel(Kernel):
    """Shared behaviour of the SpMV kernels: exactly one of a Matrix
    Market path, a ``MatrixMarket`` or a converted host matrix."""

    def __init__(self, matrix_path: str = None, mm: MatrixMarket = None,
                 matrix=None, device=None,
                 dtype: Optional[torch.dtype] = None):
        if sum(x is not None for x in (matrix_path, mm, matrix)) != 1:
            raise KernelError(
                "provide exactly one of matrix_path / mm / matrix")
        self.matrix_path = matrix_path
        self._mm = mm
        self._premade = matrix
        self.matrix = None
        self.device = torch.device(device or default_device())
        self.dtype = dtype or default_value_dtype()

    def init(self, verbose: bool = False) -> None:
        if self._premade is not None:
            self.matrix = self._premade
            return
        mm = self._mm
        if mm is None:
            mm = load_matrix(self.matrix_path, verbose=verbose)
        self._mm = mm
        self.matrix = self._convert(mm)

    def _convert(self, mm):
        raise NotImplementedError

    @property
    def value_bytes(self) -> int:
        return self.dtype.itemsize

    def flops_per_run(self) -> int:
        return 2 * self.matrix.num_entries

    def traffic_split(self):
        # the matrix streams; x and y are the chained iterate
        m = self.matrix
        vec = (m.num_columns + m.num_rows) * self.value_bytes
        return self.bytes_per_run() - vec, vec

    def describe(self) -> dict:
        m = self.matrix
        return {
            "name": self.name,
            "matrix": self.matrix_path or "<in-memory>",
            "rows": m.num_rows,
            "columns": m.num_columns,
            "nonzeros": m.num_entries,
            "matrix_format": m.format_name,
            "memory_usage_bytes": m.memory_usage_bytes(),
        }


class DiaKernel(_MatrixKernel):
    """DIA SpMV / SpMM through kernels K1 / K2 on CUDA (their plain
    versions on the CPU)."""

    name = "dia"

    def __init__(self, *args, max_diagonals: int = 1024, **kw):
        super().__init__(*args, **kw)
        self.max_diagonals = max_diagonals

    def _convert(self, mm):
        return DiaMatrix.from_matrix_market(
            mm, max_diagonals=self.max_diagonals)

    def device_matrix(self) -> DeviceDia:
        return DeviceDia.from_host(self.matrix, dtype=self.dtype,
                                   device=self.device)

    def run_fn(self):
        A = self.device_matrix()
        return _chained(dia_spmv_core, A, torch.ones(
            A.num_columns, dtype=self.dtype, device=self.device))

    def spmm_fn(self, k: int):
        if k <= 0:
            raise KernelError("spmm: k must be positive")
        A = self.device_matrix()
        return _chained(dia_spmm_core, A, torch.ones(
            (A.num_columns, k), dtype=self.dtype, device=self.device))

    def bytes_per_run(self) -> int:
        m = self.matrix
        return (m.data.size + m.num_columns + m.num_rows) * self.value_bytes

    def describe(self) -> dict:
        d = super().describe()
        d["num_diagonals"] = self.matrix.num_diagonals
        d["fill_ratio"] = self.matrix.fill_ratio
        return d


class WellCwKernel(_MatrixKernel):
    """WELL-CW SpMV / SpMM through kernels K3a-c / K4a-c and the CSR
    remainder kernels on CUDA (their plain versions on the CPU)."""

    name = "wellcw"

    def _convert(self, mm):
        return WellCwMatrix.from_matrix_market(mm)

    def device_matrix(self) -> DeviceWellCw:
        return DeviceWellCw.from_host(self.matrix, dtype=self.dtype,
                                      device=self.device)

    def run_fn(self):
        A = self.device_matrix()
        return _chained(wellcw_spmv_core, A, torch.ones(
            A.num_columns, dtype=self.dtype, device=self.device))

    def spmm_fn(self, k: int):
        if k <= 0:
            raise KernelError("spmm: k must be positive")
        A = self.device_matrix()
        return _chained(wellcw_spmm_core, A, torch.ones(
            (A.num_columns, k), dtype=self.dtype, device=self.device))

    def bytes_per_run(self) -> int:
        m = self.matrix
        vb = self.value_bytes
        b = sum(lv.value.size * (vb + IDX) for lv in m.levels)
        for p in m._pools():
            b += p.value.size * (vb + 2 * IDX)        # + rowmap
        if m.remainder is not None:
            b += m.remainder.num_entries * (vb + IDX)
        return b + (m.num_columns + m.num_rows) * vb

    def describe(self) -> dict:
        d = super().describe()
        d["num_chunks"] = self.matrix.num_chunks
        d["levels"] = [{"d": lv.d, "chunks": lv.num_chunks}
                       for lv in self.matrix.levels]
        d["pool_chunks"] = sum(p.num_chunks for p in self.matrix._pools())
        d["remainder_fraction"] = self.matrix.remainder_fraction
        d["fill_ratio"] = self.matrix.fill_ratio
        return d


class WellKernel(_MatrixKernel):
    """WELL SpMV / SpMM through kernels K5a / K6a (whole x) or K5b / K6b
    (segmented) and the CSR spill kernels on CUDA (their plain versions
    on the CPU)."""

    name = "well"

    def __init__(self, *args, window_rows: int = 4, **kw):
        super().__init__(*args, **kw)
        self.window_rows = window_rows

    def _convert(self, mm):
        return WellMatrix.from_matrix_market(
            mm, window_rows=self.window_rows)

    def device_matrix(self) -> DeviceWell:
        return DeviceWell.from_host(self.matrix, dtype=self.dtype,
                                    device=self.device)

    def run_fn(self):
        A = self.device_matrix()
        return _chained(well_spmv_core, A, torch.ones(
            A.num_columns, dtype=self.dtype, device=self.device))

    def spmm_fn(self, k: int):
        if k <= 0:
            raise KernelError("spmm: k must be positive")
        A = self.device_matrix()
        return _chained(well_spmm_core, A, torch.ones(
            (A.num_columns, k), dtype=self.dtype, device=self.device))

    def bytes_per_run(self) -> int:
        m = self.matrix
        vb = self.value_bytes
        b = m.value.size * (vb + IDX)
        if m.spill is not None:
            b += m.spill.num_entries * (vb + IDX)
        return b + (m.num_columns + m.num_rows) * vb

    def describe(self) -> dict:
        d = super().describe()
        d["num_chunks"] = self.matrix.num_chunks
        d["window_rows"] = self.matrix.window_rows
        d["spill_fraction"] = self.matrix.spill_fraction
        d["fill_ratio"] = self.matrix.fill_ratio
        return d


def _bsr_core(A, v: torch.Tensor, out: torch.Tensor = None):
    """K7 on x (m,) or X (m, k) in the accumulator type, as a chained
    step carries it: cast to the blocks' dtype first (a copy only for
    bfloat16 blocks, whose Y is float32)."""
    X = v.to(A.blocks.dtype)
    if v.dim() == 2:
        return bsr_spmm_core(A, X, out=out)
    y = bsr_spmm_core(A, X[:, None], out=None if out is None
                      else out[:, None])
    return y[:, 0] if out is None else out


class BsrKernel(_MatrixKernel):
    """BSR SpMM (and SpMV, its SpMM of one column) through kernel K7 on
    CUDA (its plain version on the CPU): dense (block_rows, 128) blocks,
    so an SpMM amortizes one block read over the whole X panel
    (``models/bsr.py``).  ``dtype`` is the blocks' type: float32,
    float64 or bfloat16, whose products accumulate in float32; the
    chained vectors are in the accumulator type."""

    name = "bsr"

    def __init__(self, *args, block_rows="auto", **kw):
        super().__init__(*args, **kw)
        self.block_rows = block_rows

    def _convert(self, mm):
        return BsrMatrix.from_matrix_market(mm, block_rows=self.block_rows)

    def device_matrix(self) -> DeviceBsr:
        return DeviceBsr.from_host(self.matrix, dtype=self.dtype,
                                   device=self.device)

    def run_fn(self):
        A = self.device_matrix()
        return _chained(_bsr_core, A, torch.ones(
            A.num_columns, dtype=accumulate_dtype(self.dtype),
            device=self.device))

    def spmm_fn(self, k: int):
        if k <= 0:
            raise KernelError("spmm: k must be positive")
        A = self.device_matrix()
        return _chained(_bsr_core, A, torch.ones(
            (A.num_columns, k), dtype=accumulate_dtype(self.dtype),
            device=self.device))

    def bytes_per_run(self) -> int:
        m = self.matrix
        vb = self.value_bytes
        nb = int(m.num_blocks)
        return (
            nb * m.block_rows * BLOCK * vb   # stored blocks streamed
            + nb * IDX                       # block_col
            + (m.num_block_rows + 1) * IDX   # block_rowptr
            + m.num_columns * vb             # x read at least once
            + m.num_rows * vb                # y written
        )


def make_kernel(
    name: str,
    matrix_path: str = None,
    mm: MatrixMarket = None,
    matrix=None,
    triad_entries: int = 0,
    device=None,
    dtype: Optional[torch.dtype] = None,
    **kw,
):
    """Kernel factory: ``triad``, ``dia``, ``wellcw``, ``well`` and
    ``bsr``; any other name of the JAX package's factory raises
    ``KernelError`` (not yet ported)."""
    if name == "triad":
        return TriadKernel(triad_entries, device=device, dtype=dtype)
    classes = {"dia": DiaKernel, "wellcw": WellCwKernel, "well": WellKernel,
               "bsr": BsrKernel}
    if name in classes:
        return classes[name](matrix_path=matrix_path, mm=mm, matrix=matrix,
                             device=device, dtype=dtype, **kw)
    if name in KERNEL_NAMES:
        raise KernelError(
            f"kernel {name!r} is not yet ported to spmv_tpu_torch; see "
            "ROADMAP.md")
    raise KernelError(
        f"unknown kernel {name!r}; expected one of {KERNEL_NAMES}")

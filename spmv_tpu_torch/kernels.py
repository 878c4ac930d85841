"""Kernels of the port: ``triad``, ``coo``, ``coo-atomic``, ``csr``,
``ell``, ``hybrid``, ``dia``, ``well``, ``wellcw``, ``bsr`` and
``xla-csr``: every name of the JAX package's factory.

The counterpart of ``spmv_tpu/kernels.py``.  ``Kernel`` and
``_MatrixKernel`` are the port's copies of the JAX package's base classes
(loading, conversion, ``describe``, ``flops_per_run``), with the
simulation mode's memory layouts (``_make_layout``) and per-thread
memory reference strings (``memory_reference_string``), JAX's element
for element: they model the format's reference loop on the trace
config's CPU-like cache hierarchy, not the port's GPU kernels.  The
layout is built from the host matrix at its first use (``layout``), so
profile mode pays nothing for it.  Each kernel runs on ``device`` in ``dtype`` (by default the
card, through ``default_device``, and ``default_value_dtype``); the byte
counts are the JAX package's at the tensor's value width, except where
a class says it prices what its launches read.  Every matrix kernel has
an SpMV and an SpMM step (``bsr``'s SpMV is its SpMM of one column).
``coo`` and ``coo-atomic`` run on the CSR kernels, through
``DeviceCsr.from_coo_host``, as the JAX package runs both on its CSR
segment sum; ``xla-csr`` is the vendor library's product
(``torch.sparse``, cuSPARSE on the card), the comparison kernel, as the
reference tool's ``mkl-csr`` is.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.io.matrix_market import MatrixMarket, load_matrix
from spmv_tpu_torch.models.bsr import BLOCK, BsrMatrix
from spmv_tpu_torch.models.coo import CooMatrix
from spmv_tpu_torch.models.csr import CsrMatrix
from spmv_tpu_torch.models.device import (
    LANE,
    DeviceBsr,
    DeviceCsr,
    DeviceDia,
    DeviceEll,
    DeviceHybrid,
    DeviceSparseCsr,
    DeviceWell,
    DeviceWellCw,
    default_device,
    default_value_dtype,
)
from spmv_tpu_torch.models.dia import DiaMatrix
from spmv_tpu_torch.models.ell import EllMatrix
from spmv_tpu_torch.models.hybrid import HybridMatrix
from spmv_tpu_torch.models.well import WellMatrix
from spmv_tpu_torch.models.wellcw import WellCwMatrix
from spmv_tpu_torch.perfmodel.layout import VirtualLayout
from spmv_tpu_torch.perfmodel.refstring import (
    VAL,
    bsr_spmv_refstring,
    coo_atomic_spmv_refstring,
    coo_spmv_refstring,
    csr_spmv_refstring,
    dia_spmv_refstring,
    ell_spmv_refstring,
    hybrid_spmv_refstring,
    triad_refstring,
    well_spmv_refstring,
    wellcw_spmv_refstring,
)
from spmv_tpu_torch.ops.bsr_kernels import bsr_spmm_core
from spmv_tpu_torch.ops.csr_kernels import csr_spmm_core, csr_spmv_core
from spmv_tpu_torch.ops.dia_kernels import dia_spmm_core, dia_spmv_core
from spmv_tpu_torch.ops.dispatch import sparse_csr_core
from spmv_tpu_torch.ops.ell_kernels import (
    ell_spmm_core,
    ell_spmv_core,
    hybrid_spmm_core,
    hybrid_spmv_core,
)
from spmv_tpu_torch.ops.spmv import accumulate_dtype
from spmv_tpu_torch.ops.triad import triad
from spmv_tpu_torch.ops.well_kernels import well_spmm_core, well_spmv_core
from spmv_tpu_torch.ops.wellcw_kernels import (
    wellcw_spmm_core,
    wellcw_spmv_core,
)

__all__ = ["Kernel", "TriadKernel", "CsrKernel", "XlaCsrKernel",
           "EllKernel", "CooKernel", "CooAtomicKernel", "HybridKernel",
           "DiaKernel", "WellCwKernel", "WellKernel", "BsrKernel",
           "make_kernel", "KERNEL_NAMES"]

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


def _numa(trace_config) -> np.ndarray:
    return np.asarray(trace_config.numa_domains_of_threads())


class Kernel:
    """Base kernel interface (the JAX package's ``Kernel``)."""

    name: str = "kernel"
    _layout: Optional[VirtualLayout] = None

    def init(self, verbose: bool = False) -> None:
        raise NotImplementedError

    @property
    def layout(self) -> VirtualLayout:
        """The simulation's virtual memory layout, built at first use."""
        if self._layout is None:
            self._layout = self._make_layout()
        return self._layout

    def _make_layout(self) -> VirtualLayout:
        raise NotImplementedError

    def memory_reference_string(self, trace_config, thread: int,
                                num_threads: int):
        """(addresses, numa_domains) of ``thread``'s references, one run
        of the format's reference loop split over ``num_threads``."""
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

    def _make_layout(self):
        lay = VirtualLayout()
        for nm in ("a", "b", "c"):
            lay.allocate(nm, self.num_entries, VAL)
        return lay

    def memory_reference_string(self, trace_config, thread, num_threads):
        return triad_refstring(self.num_entries, self.layout, thread,
                               num_threads, _numa(trace_config))

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
        self._layout = None
        if self._premade is not None:
            self.matrix = self._premade
            return
        mm = self._mm
        if mm is None:
            mm = load_matrix(self.matrix_path, verbose=verbose)
        self._mm = mm
        self.matrix = self._convert(mm)

    # the reference string generator of the format (perfmodel/refstring)
    _refstring = None

    def memory_reference_string(self, trace_config, thread, num_threads):
        return type(self)._refstring(self.matrix, self.layout, thread,
                                     num_threads, _numa(trace_config))

    def _convert(self, mm):
        raise NotImplementedError

    # the chained steps' cores: y = A @ x and Y = A @ X, each with out=
    _spmv_core = None
    _spmm_core = None

    def device_matrix(self):
        raise NotImplementedError

    def run_fn(self):
        A = self.device_matrix()
        return _chained(type(self)._spmv_core, A, torch.ones(
            A.num_columns, dtype=self.dtype, device=self.device))

    def spmm_fn(self, k: int):
        if k <= 0:
            raise KernelError("spmm: k must be positive")
        A = self.device_matrix()
        return _chained(type(self)._spmm_core, A, torch.ones(
            (A.num_columns, k), dtype=self.dtype, device=self.device))

    @property
    def value_bytes(self) -> int:
        return self.dtype.itemsize

    def flops_per_run(self) -> int:
        return 2 * self.matrix.num_entries

    def spmm_bytes_per_run(self, k: int) -> int:
        """The bytes of one SpMM of k right-hand sides (``--spmm K``): the
        matrix stream of ``bytes_per_run`` once, X and Y k times at the
        value width."""
        m = self.matrix
        return self.bytes_per_run() + (k - 1) * (
            m.num_columns + m.num_rows) * self.value_bytes

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


class CsrKernel(_MatrixKernel):
    """CSR SpMV / SpMM through the CSR kernels (``csrc/csr_spmv.cu``,
    ``csrc/csr_spmm.cu``) on CUDA, their plain versions on the CPU."""

    name = "csr"
    _spmv_core = csr_spmv_core
    _spmm_core = csr_spmm_core

    _refstring = csr_spmv_refstring

    def _convert(self, mm):
        return CsrMatrix.from_matrix_market(mm)

    def _make_layout(self):
        m = self.matrix
        lay = VirtualLayout()
        lay.allocate("row_ptr", m.row_ptr.size, IDX)
        lay.allocate("column_index", m.column_index.size, IDX)
        lay.allocate("value", m.value.size, VAL)
        lay.allocate("x", m.num_columns, VAL)
        lay.allocate("y", m.num_rows, VAL)
        return lay

    def device_matrix(self):
        return DeviceCsr.from_host(self.matrix, dtype=self.dtype,
                                   device=self.device)

    def bytes_per_run(self) -> int:
        m = self.matrix
        stored = int(m.row_ptr[-1])
        vb = self.value_bytes
        return (
            stored * (IDX + vb)           # column_index + value streamed
            + (m.num_rows + 1) * IDX      # row_ptr
            + m.num_columns * vb          # x read at least once
            + m.num_rows * vb             # y written
        )


class XlaCsrKernel(CsrKernel):
    """The vendor library's CSR product, the comparison kernel (the
    reference tool's ``mkl-csr``; the JAX package runs XLA's own
    lowering): ``torch.sparse`` on a ``DeviceSparseCsr`` built once,
    cuSPARSE on the card.  By design no kernel of the port runs here."""

    name = "xla-csr"
    _spmv_core = sparse_csr_core
    _spmm_core = sparse_csr_core

    def device_matrix(self):
        return DeviceSparseCsr(super().device_matrix())

    def memory_reference_string(self, trace_config, thread, num_threads):
        raise KernelError(
            "Memory reference strings are not implemented for the "
            "library kernel 'xla-csr'")


class EllKernel(_MatrixKernel):
    """ELL SpMV / SpMM through the ELL kernels (``csrc/ell_spmv.cu``,
    ``csrc/ell_spmm.cu``) on CUDA, their plain versions on the CPU."""

    name = "ell"
    _spmv_core = ell_spmv_core
    _spmm_core = ell_spmm_core

    def __init__(self, *args, skip_padding: bool = False, **kw):
        super().__init__(*args, **kw)
        self.skip_padding = skip_padding

    _refstring = ell_spmv_refstring

    def _convert(self, mm):
        return EllMatrix.from_matrix_market(
            mm, skip_padding=self.skip_padding)

    def _make_layout(self):
        m = self.matrix
        lay = VirtualLayout()
        lay.allocate("column_index", m.column_index.size, IDX)
        lay.allocate("value", m.value.size, VAL)
        lay.allocate("x", m.num_columns, VAL)
        lay.allocate("y", m.num_rows, VAL)
        return lay

    def device_matrix(self):
        return DeviceEll.from_host(self.matrix, dtype=self.dtype,
                                   device=self.device)

    def bytes_per_run(self) -> int:
        m = self.matrix
        vb = self.value_bytes
        return (m.value.size * (IDX + vb)
                + m.num_columns * vb + m.num_rows * vb)

    def describe(self) -> dict:
        d = super().describe()
        d["row_length"] = self.matrix.row_length
        d["num_padding_entries"] = self.matrix.num_padding_entries
        return d


def _csr_part_bytes(num_entries: int, num_rows: int, vb: int) -> int:
    """What the CSR kernel reads of a COO part held as a ``DeviceCsr``:
    each entry's column index and value, and the row pointers."""
    return num_entries * (IDX + vb) + (num_rows + 1) * IDX


class CooKernel(_MatrixKernel):
    """COO SpMV / SpMM on the CSR kernels: the entries sorted by row on
    the host (``DeviceCsr.from_coo_host``), as the JAX package runs both
    COO variants on its CSR segment sum.

    ``bytes_per_run`` prices what the CSR kernel reads: the entries'
    column indices and values and ``row_ptr``, where the JAX class counts
    a row index an entry (``num_entries * (2 * IDX + vb)``); a stated
    deviation."""

    name = "coo"
    _spmv_core = csr_spmv_core
    _spmm_core = csr_spmm_core
    _refstring = coo_spmv_refstring
    _num_threads_hint = 1

    def set_num_threads_hint(self, n: int) -> None:
        """The workspace array is num_threads * rows elements
        (coo-spmv.cpp:41-48); the simulator sizes it per config."""
        self._num_threads_hint = max(1, int(n))
        self._layout = None

    def _convert(self, mm):
        return CooMatrix.from_matrix_market(mm)

    def _make_layout(self):
        m = self.matrix
        lay = VirtualLayout()
        lay.allocate("row_index", m.row_index.size, IDX)
        lay.allocate("column_index", m.column_index.size, IDX)
        lay.allocate("value", m.value.size, VAL)
        lay.allocate("x", m.num_columns, VAL)
        lay.allocate("y", m.num_rows, VAL)
        lay.allocate("workspace", self._num_threads_hint * m.num_rows, VAL)
        return lay

    def memory_reference_string(self, trace_config, thread, num_threads):
        if num_threads != self._num_threads_hint:
            self.set_num_threads_hint(num_threads)
        return super().memory_reference_string(trace_config, thread,
                                               num_threads)

    def device_matrix(self):
        return DeviceCsr.from_coo_host(self.matrix, dtype=self.dtype,
                                       device=self.device)

    def bytes_per_run(self) -> int:
        m = self.matrix
        vb = self.value_bytes
        return (_csr_part_bytes(m.num_entries, m.num_rows, vb)
                + m.num_columns * vb + m.num_rows * vb)


class CooAtomicKernel(CooKernel):
    """The atomic COO variant: on the card, as in the JAX package, the
    same sorted CSR product as ``coo``; its simulation has no
    workspace."""

    name = "coo-atomic"
    _refstring = coo_atomic_spmv_refstring

    def _make_layout(self):
        m = self.matrix
        lay = VirtualLayout()
        lay.allocate("row_index", m.row_index.size, IDX)
        lay.allocate("column_index", m.column_index.size, IDX)
        lay.allocate("value", m.value.size, VAL)
        lay.allocate("x", m.num_columns, VAL)
        lay.allocate("y", m.num_rows, VAL)
        return lay

    def memory_reference_string(self, trace_config, thread, num_threads):
        return _MatrixKernel.memory_reference_string(
            self, trace_config, thread, num_threads)


class HybridKernel(_MatrixKernel):
    """Hybrid ELL + COO: the ELL kernel writes y, then the CSR kernel adds
    the COO part (held as a ``DeviceCsr``), none where it is empty.

    ``bytes_per_run`` prices what the launches read: the ELL slots as
    the JAX class counts them, and the COO part as the CSR kernel reads
    it (column index, value and ``row_ptr``; nothing where it is empty),
    where the JAX class counts a row index an entry; a stated
    deviation."""

    name = "hybrid"
    _spmv_core = hybrid_spmv_core
    _spmm_core = hybrid_spmm_core
    _refstring = hybrid_spmv_refstring
    _num_threads_hint = 1

    def set_num_threads_hint(self, n: int) -> None:
        self._num_threads_hint = max(1, int(n))
        self._layout = None

    def _convert(self, mm):
        return HybridMatrix.from_matrix_market(mm)

    def _make_layout(self):
        m = self.matrix
        lay = VirtualLayout()
        lay.allocate("ell_column_index", m.ell_column_index.size, IDX)
        lay.allocate("ell_value", m.ell_value.size, VAL)
        lay.allocate("coo_row_index", max(m.coo_row_index.size, 1), IDX)
        lay.allocate("coo_column_index", max(m.coo_column_index.size, 1),
                     IDX)
        lay.allocate("coo_value", max(m.coo_value.size, 1), VAL)
        lay.allocate("x", m.num_columns, VAL)
        lay.allocate("y", m.num_rows, VAL)
        lay.allocate("workspace", self._num_threads_hint * m.num_rows, VAL)
        return lay

    def memory_reference_string(self, trace_config, thread, num_threads):
        if num_threads != self._num_threads_hint:
            self.set_num_threads_hint(num_threads)
        return super().memory_reference_string(trace_config, thread,
                                               num_threads)

    def device_matrix(self):
        return DeviceHybrid.from_host(self.matrix, dtype=self.dtype,
                                      device=self.device)

    def bytes_per_run(self) -> int:
        m = self.matrix
        vb = self.value_bytes
        coo = (_csr_part_bytes(m.num_coo_entries, m.num_rows, vb)
               if m.num_coo_entries else 0)
        return (m.ell_value.size * (IDX + vb) + coo
                + m.num_columns * vb + m.num_rows * vb)

    def describe(self) -> dict:
        d = super().describe()
        d["ell_row_length"] = self.matrix.ell_row_length
        d["num_ell_entries"] = self.matrix.num_ell_entries
        d["num_coo_entries"] = self.matrix.num_coo_entries
        return d


class DiaKernel(_MatrixKernel):
    """DIA SpMV / SpMM through kernels K1 / K2 on CUDA (their plain
    versions on the CPU)."""

    name = "dia"
    _spmv_core = dia_spmv_core
    _spmm_core = dia_spmm_core

    def __init__(self, *args, max_diagonals: int = 1024, **kw):
        super().__init__(*args, **kw)
        self.max_diagonals = max_diagonals

    _refstring = dia_spmv_refstring

    def _convert(self, mm):
        return DiaMatrix.from_matrix_market(
            mm, max_diagonals=self.max_diagonals)

    def _make_layout(self):
        m = self.matrix
        lay = VirtualLayout()
        lay.allocate("data", m.data.size, VAL)
        lay.allocate("x", m.num_columns, VAL)
        lay.allocate("y", m.num_rows, VAL)
        return lay

    def device_matrix(self) -> DeviceDia:
        return DeviceDia.from_host(self.matrix, dtype=self.dtype,
                                   device=self.device)


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
    _spmv_core = wellcw_spmv_core
    _spmm_core = wellcw_spmm_core

    _refstring = wellcw_spmv_refstring

    def _convert(self, mm):
        return WellCwMatrix.from_matrix_market(mm)

    def _make_layout(self):
        m = self.matrix
        lay = VirtualLayout()
        for i, lv in enumerate(m.levels):
            lay.allocate(f"value{i}", lv.value.size, VAL)
            lay.allocate(f"local_index{i}", lv.local_index.size, IDX)
            lay.allocate(f"anchor{i}", lv.anchor4.size, IDX)
        for j, p in enumerate(m._pools()):
            lay.allocate(f"pool{j}_value", p.value.size, VAL)
            lay.allocate(f"pool{j}_local_index", p.local_index.size, IDX)
            lay.allocate(f"pool{j}_anchor", p.anchor4.size, IDX)
            lay.allocate(f"pool{j}_rowmap", p.rowmap.size, IDX)
        lay.allocate("x", m.num_columns, VAL)
        lay.allocate("y", m.num_rows, VAL)
        if m.remainder is not None:
            lay.allocate("rem_row_ptr", m.remainder.row_ptr.size, IDX)
            lay.allocate("rem_column_index",
                         m.remainder.column_index.size, IDX)
            lay.allocate("rem_value", m.remainder.value.size, VAL)
        return lay

    def device_matrix(self) -> DeviceWellCw:
        return DeviceWellCw.from_host(self.matrix, dtype=self.dtype,
                                      device=self.device)


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
    (segmented) on CUDA, each one launch with the spill folded in (their
    plain versions on the CPU)."""

    name = "well"
    _spmv_core = well_spmv_core
    _spmm_core = well_spmm_core

    def __init__(self, *args, window_rows: int = 4, **kw):
        super().__init__(*args, **kw)
        self.window_rows = window_rows

    _refstring = well_spmv_refstring

    def _convert(self, mm):
        return WellMatrix.from_matrix_market(
            mm, window_rows=self.window_rows)

    def _make_layout(self):
        m = self.matrix
        lay = VirtualLayout()
        lay.allocate("value", m.value.size, VAL)
        lay.allocate("local_index", m.local_index.size, IDX)
        lay.allocate("window_start", m.window_start.size, IDX)
        lay.allocate("x", m.num_columns, VAL)
        lay.allocate("y", m.num_rows, VAL)
        if m.spill is not None:
            lay.allocate("spill_row_ptr", m.spill.row_ptr.size, IDX)
            lay.allocate("spill_column_index", m.spill.column_index.size,
                         IDX)
            lay.allocate("spill_value", m.spill.value.size, VAL)
        return lay

    def device_matrix(self) -> DeviceWell:
        return DeviceWell.from_host(self.matrix, dtype=self.dtype,
                                    device=self.device)


    def bytes_per_run(self) -> int:
        """The bytes K5 moves, and K6 for one column: value + index of
        each slot that holds a nonzero (they read no other; the JAX class
        counts every slot), the spill and the vectors once."""
        m = self.matrix
        vb = self.value_bytes
        live = int((np.asarray(m.value) != 0).any(axis=2).sum())
        b = live * LANE * (vb + IDX)
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

    _refstring = bsr_spmv_refstring

    def _convert(self, mm):
        return BsrMatrix.from_matrix_market(mm, block_rows=self.block_rows)

    def _make_layout(self):
        m = self.matrix
        lay = VirtualLayout()
        lay.allocate("blocks", m.blocks.size, VAL)
        lay.allocate("block_col", m.block_col.size, IDX)
        lay.allocate("block_rowptr", m.block_rowptr.size, IDX)
        # padded vector footprints, matching the device layout
        ncb = -(-m.num_columns // BLOCK)
        lay.allocate("x", ncb * BLOCK, VAL)
        lay.allocate("y", m.num_block_rows * m.block_rows, VAL)
        return lay

    def device_matrix(self) -> DeviceBsr:
        """The host's blocks and no zero padding (``blocks_per_step=1``):
        K7 walks ``row_ptr`` and has no use for the TPU's steps.  A stated
        deviation from the JAX kernel, whose padding blocks point at
        column block 0: an inf or NaN there gives NaN (0 * inf) in every
        padded block row on JAX, the finite product here."""
        return DeviceBsr.from_host(self.matrix, dtype=self.dtype,
                                   blocks_per_step=1, device=self.device)

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
    """Kernel factory (``spmv_tpu.kernels.make_kernel``): every name of
    ``KERNEL_NAMES``; any other raises ``KernelError``."""
    if name == "triad":
        return TriadKernel(triad_entries, device=device, dtype=dtype)
    classes = {
        "coo": CooKernel,
        "coo-atomic": CooAtomicKernel,
        "csr": CsrKernel,
        "ell": EllKernel,
        "hybrid": HybridKernel,
        "dia": DiaKernel,
        "well": WellKernel,
        "wellcw": WellCwKernel,
        "bsr": BsrKernel,
        "xla-csr": XlaCsrKernel,
    }
    if name not in classes:
        raise KernelError(
            f"unknown kernel {name!r}; expected one of {KERNEL_NAMES}")
    return classes[name](matrix_path=matrix_path, mm=mm, matrix=matrix,
                         device=device, dtype=dtype, **kw)

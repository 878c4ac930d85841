"""Device-side containers: DIA, CSR, ELL, hybrid, WELL-CW, WELL and BSR.

The counterparts of ``spmv_tpu.models.device``'s ``DeviceDia``,
``DeviceCsr`` (COO included, through ``DeviceCsr.from_coo_host``),
``DeviceEll``, ``DeviceHybrid``, ``DeviceWellCw`` (with its
``DeviceCwLevel``, ``DeviceCwPool`` and ``DeviceCwMerged``),
``DeviceWell`` and ``DeviceBsr``, and of ``device_put_matrix``.
``DeviceSparseCsr`` has no counterpart there: it holds a CSR matrix as
one ``torch.sparse_csr_tensor`` for ``-s xla-csr``, the vendor
library's product, as XLA's own lowering is in the JAX package.

- DIA: the TPU container folds each diagonal into (rows/128, 128) lanes
  and pads rows to a multiple of 1024 for the Pallas kernel's DMA
  windows; a CUDA kernel addresses memory linearly, so here each
  diagonal is one contiguous row of ``data`` with exactly ``num_rows``
  entries.
- CSR: the plain unpadded ``row_ptr`` / ``column_index`` / ``value``
  triple.  The TPU container pads entries and rows for its segment sum
  and carries the expanded row ids; the CUDA kernel walks ``row_ptr``.
- ELL: slot-major (row_length, num_rows) arrays, no row padding; the
  TPU container keeps row-major tiles with rows padded to a multiple of
  8 (``DeviceEll``).
- WELL-CW, WELL and BSR: the very arrays the JAX containers hold, packed
  by the same numpy code (``_pad_cw_steps``, ``_build_cw_merged``,
  ``DeviceWell.from_host`` and ``DeviceBsr.from_host`` are copied from
  ``spmv_tpu/models/device.py``, whose module imports JAX), plus the
  chunk, step or block pointers a CUDA grid needs to find a group's, an
  output block's or a block row's run, which the TPU's sequential grid
  did not.

``default_device`` is where the port's entry points (the CLI,
``make_kernel`` and the kernel classes) get their device: the card,
unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch

from spmv_tpu_torch.errors import KernelError, MatrixError
from spmv_tpu_torch.models.bsr import BLOCK, BsrMatrix
from spmv_tpu_torch.models.coo import CooMatrix
from spmv_tpu_torch.models.csr import CsrMatrix
from spmv_tpu_torch.models.dia import DiaMatrix
from spmv_tpu_torch.models.ell import ELL_PAD_SENTINEL, EllMatrix
from spmv_tpu_torch.models.hybrid import HybridMatrix
from spmv_tpu_torch.models.well import WellMatrix
from spmv_tpu_torch.models.wellcw import WellCwMatrix

__all__ = ["DeviceDia", "DeviceCsr", "DeviceEll", "DeviceHybrid",
           "DeviceSparseCsr", "DeviceCwLevel", "DeviceCwPool",
           "DeviceCwMerged", "DeviceWellCw", "DeviceWell", "DeviceBsr",
           "device_put_matrix",
           "default_device", "default_value_dtype", "DEVICE_ENV",
           "level_index_bits", "merged_pool_list", "pool_row_list",
           "sliced_row_list", "csr_row_split", "LONG_ROW", "BLOCK_ROW"]

LANE = 128
SUBLANE = 8
# The CSR kernels' row split (csr_row_split): a row with more entries
# than LONG_ROW is long, and a warp sums it; one with more than
# BLOCK_ROW, a whole block of 256 threads.  The short rows keep a
# thread each.  Both chosen by the sweep of chip_smoke.py phase 25 on an
# H100 (PERF.md): 32 and 4,096 were the fastest pair for the hybrid's
# COO part at k = 8 and within 2% of the fastest for its SpMV.
LONG_ROW = 32
BLOCK_ROW = 4096
# the environment variable through which a caller asks for the CPU
DEVICE_ENV = "SPMV_TPU_TORCH_DEVICE"


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _tensor(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def default_device() -> torch.device:
    """The device the port's entry points run on: the first CUDA device.

    ``SPMV_TPU_TORCH_DEVICE=cpu`` asks for the CPU instead (the port's
    counterpart of the ``JAX_PLATFORMS=cpu`` the JAX package's tests
    set).  Without it, a machine with no visible CUDA device raises
    ``KernelError``: nothing carries on on the CPU unasked.
    """
    want = os.environ.get(DEVICE_ENV, "").strip().lower()
    if want == "cpu":
        return torch.device("cpu")
    if want not in ("", "cuda"):
        raise KernelError(
            f"{DEVICE_ENV}={want!r}: expected 'cpu' or 'cuda'")
    if not torch.cuda.is_available():
        raise KernelError(
            "no CUDA device is visible (torch.cuda.is_available() is "
            f"False); set {DEVICE_ENV}=cpu, or pass device='cpu', to run "
            "on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``default_device()`` when None."""
    return torch.device(device) if device is not None else default_device()


def default_value_dtype() -> torch.dtype:
    """float64 when torch's default dtype is float64 (the tests' analogue
    of JAX's x64 mode), else float32."""
    if torch.get_default_dtype() == torch.float64:
        return torch.float64
    return torch.float32


class DeviceDia(torch.nn.Module):
    """DIA matrix on a device: ``data[k, i] = A[i, i + offsets[k]]``.

    Buffers (moved by ``.to(device)``):

    - ``data``: (D, num_rows), the value dtype (float32, float64 or
      bfloat16 storage);
    - ``offsets_dev``: (D,) int32, the diagonal offsets the kernels read.

    Metadata (plain Python values): ``num_rows``, ``num_columns``,
    ``num_entries`` and ``offsets``, a tuple of ints as in the JAX
    container, which the plain versions loop over.  Entries of ``data``
    whose column ``i + offsets[k]`` falls outside [0, num_columns) are
    zero and never read by the kernels.
    """

    format_name = "dia"

    def __init__(self, num_rows: int, num_columns: int, num_entries: int,
                 offsets, data: torch.Tensor):
        super().__init__()
        offsets = tuple(int(o) for o in offsets)
        if data.dim() != 2 or tuple(data.shape) != (len(offsets),
                                                    num_rows):
            raise ValueError(
                f"data has shape {tuple(data.shape)}, expected "
                f"{(len(offsets), num_rows)}")
        self.num_rows = int(num_rows)
        self.num_columns = int(num_columns)
        self.num_entries = int(num_entries)
        self.offsets = offsets
        self.register_buffer("data", data.contiguous())
        self.register_buffer("offsets_dev", torch.tensor(
            offsets, dtype=torch.int32, device=data.device))

    @property
    def num_diagonals(self) -> int:
        return len(self.offsets)

    @classmethod
    def from_host(cls, m: DiaMatrix, dtype: Optional[torch.dtype] = None,
                  device=None) -> "DeviceDia":
        dtype = dtype or default_value_dtype()
        data = torch.from_numpy(np.ascontiguousarray(m.data,
                                                     dtype=np.float64))
        return cls(m.num_rows, m.num_columns, m.num_entries, m.offsets,
                   data.to(device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x (the plain version on the CPU, kernel K1 on CUDA)."""
        from spmv_tpu_torch.ops.dispatch import spmv

        return spmv(self, x)


class DeviceCsr(torch.nn.Module):
    """CSR on a device, unpadded: row i holds
    ``column_index[row_ptr[i]:row_ptr[i + 1]]`` and the same slice of
    ``value``.

    Buffers: ``row_ptr`` (num_rows + 1,) int32, ``column_index``
    (stored,) int32 and ``value`` (stored,) in the value dtype.  The JAX
    container's padded entries, overflow row and expanded row ids serve
    its segment sum; the CUDA kernels walk ``row_ptr`` and need none of
    them.  Built on the host by ``csr_row_split`` for the CSR kernels,
    which sum a short row (at most ``long_row_entries`` entries, the
    module's ``LONG_ROW`` when the container was built) in one thread
    and a long row in a warp or a block:

    - ``long_rows`` (long,) int32, the long rows, longest first (ties by
      row), or None where no row is long; the first ``num_block_rows``
      of them (more than ``BLOCK_ROW`` entries) take a whole block;
    - ``row_list`` (listed,) int32, the short rows that own at least one
      entry in ascending order, the rows the CSR SpMM runs a thread on,
      or None where every row owns one (the SpMM then takes every row
      and leaves the long ones to their warps).  A WELL-CW remainder
      owns a few of its rows; a CSR matrix of its own usually all.
    """

    format_name = "csr"

    def __init__(self, num_rows: int, num_columns: int, num_entries: int,
                 row_ptr: torch.Tensor, column_index: torch.Tensor,
                 value: torch.Tensor):
        super().__init__()
        if tuple(row_ptr.shape) != (num_rows + 1,):
            raise ValueError(f"row_ptr has shape {tuple(row_ptr.shape)}, "
                             f"expected {(num_rows + 1,)}")
        if column_index.shape != value.shape or column_index.dim() != 1:
            raise ValueError("column_index and value must be 1-D and of "
                             "one length")
        self.num_rows = int(num_rows)
        self.num_columns = int(num_columns)
        self.num_entries = int(num_entries)
        self.register_buffer("row_ptr", row_ptr.to(torch.int32).contiguous())
        self.register_buffer("column_index",
                             column_index.to(torch.int32).contiguous())
        self.register_buffer("value", value.contiguous())
        long_rows, self.num_block_rows, row_list = csr_row_split(
            self.row_ptr.cpu().numpy(), LONG_ROW, BLOCK_ROW)
        self.long_row_entries = LONG_ROW
        for name, rows in (("long_rows", long_rows), ("row_list", row_list)):
            self.register_buffer(name, None if rows is None else
                                 _tensor(rows, self.row_ptr.device))

    @classmethod
    def from_host(cls, m: CsrMatrix, dtype: Optional[torch.dtype] = None,
                  device=None) -> "DeviceCsr":
        dtype = dtype or default_value_dtype()
        stored = int(m.row_ptr[-1])
        return cls(
            m.num_rows, m.num_columns, m.num_entries,
            _tensor(np.asarray(m.row_ptr, np.int32), device),
            _tensor(np.asarray(m.column_index[:stored], np.int32), device),
            _tensor(np.asarray(m.value[:stored], np.float64), device, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x (the plain version on the CPU, the CSR kernel on
        CUDA)."""
        from spmv_tpu_torch.ops.dispatch import spmv

        return spmv(self, x)

    @classmethod
    def from_coo_host(cls, m: CooMatrix, dtype: Optional[torch.dtype] = None,
                      device=None) -> "DeviceCsr":
        """COO -> device, as ``spmv_tpu``'s ``DeviceCsr.from_coo_host``:
        a stable sort by row, then the CSR form, so that both COO
        variants run on the CSR kernels (the JAX package runs both on its
        CSR segment sum)."""
        order = np.argsort(m.row_index, kind="stable")
        rows = m.row_index[order]
        lengths = np.bincount(rows, minlength=m.num_rows)
        row_ptr = np.zeros(m.num_rows + 1, dtype=np.int64)
        np.cumsum(lengths, out=row_ptr[1:])
        host = CsrMatrix(
            m.num_rows, m.num_columns, m.num_entries, 1,
            row_ptr, m.column_index[order], m.value[order],
        )
        return cls.from_host(host, dtype=dtype, device=device)


class DeviceSparseCsr(torch.nn.Module):
    """A CSR matrix as one ``torch.sparse_csr_tensor`` (``matrix``, 32-bit
    indices): the vendor library's product (cuSPARSE on the card), the
    comparison kernel ``-s xla-csr`` runs, as the JAX package runs XLA's
    own lowering and the reference tool MKL.  Built once from a
    ``DeviceCsr``; no path of the port's own formats calls it."""

    format_name = "csr"

    def __init__(self, A: DeviceCsr):
        super().__init__()
        self.num_rows = A.num_rows
        self.num_columns = A.num_columns
        self.num_entries = A.num_entries
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*beta state")
            self.matrix = torch.sparse_csr_tensor(
                A.row_ptr, A.column_index, A.value,
                size=(A.num_rows, A.num_columns), check_invariants=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x through ``torch.sparse``."""
        from spmv_tpu_torch.ops.dispatch import spmv

        return spmv(self, x)


class DeviceEll(torch.nn.Module):
    """ELLPACK on a device: slot s of row i holds column
    ``column_index[s, i]`` and value ``value[s, i]``.

    Buffers: ``column_index`` (padded_row_length, num_rows) int32 and
    ``value`` (padded_row_length, num_rows) in the value dtype.  The
    slots are stored slot-major, so that the 32 rows of a warp read one
    contiguous run of a slot (128 bytes of int32 indices); the JAX
    container keeps row-major (padded_rows, padded_row_length) tiles
    with the rows padded to a multiple of 8 (a TPU sublane), a layout
    choice the port does not copy: no row is padded here.  The
    semantics are JAX's: a skip-padding sentinel becomes column 0 with
    value 0, so every padded slot is inert (value 0 at an in-bounds
    column) and is read like any other; ``padded_row_length`` is
    ``max(row_length, 1)``, as JAX pads it.
    """

    format_name = "ell"

    def __init__(self, num_rows: int, num_columns: int, num_entries: int,
                 row_length: int, column_index: torch.Tensor,
                 value: torch.Tensor):
        super().__init__()
        if column_index.shape != value.shape or column_index.dim() != 2 \
                or column_index.shape[1] != num_rows:
            raise ValueError(
                f"column_index {tuple(column_index.shape)} and value "
                f"{tuple(value.shape)} must both be (slots, {num_rows})")
        self.num_rows = int(num_rows)
        self.num_columns = int(num_columns)
        self.num_entries = int(num_entries)
        self.row_length = int(row_length)
        self.padded_row_length = int(column_index.shape[0])
        self.register_buffer("column_index",
                             column_index.to(torch.int32).contiguous())
        self.register_buffer("value", value.contiguous())

    @classmethod
    def from_host(cls, m: EllMatrix, dtype: Optional[torch.dtype] = None,
                  device=None) -> "DeviceEll":
        dtype = dtype or default_value_dtype()
        pl = max(m.row_length, 1)
        cols = np.zeros((pl, m.num_rows), dtype=np.int32)
        vals = np.zeros((pl, m.num_rows), dtype=np.float64)
        src_cols = m.column_index
        if m.skip_padding:
            # an inert in-bounds column in place of each sentinel
            src_cols = np.where(src_cols == ELL_PAD_SENTINEL, 0, src_cols)
        cols[: m.row_length] = np.asarray(src_cols).T
        vals[: m.row_length] = np.asarray(m.value).T
        return cls(m.num_rows, m.num_columns, m.num_entries, m.row_length,
                   _tensor(cols, device), _tensor(vals, device, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x (the plain version on the CPU, the ELL kernel on
        CUDA)."""
        from spmv_tpu_torch.ops.dispatch import spmv

        return spmv(self, x)


class DeviceHybrid(torch.nn.Module):
    """Hybrid ELL + COO on a device: ``ell``, a ``DeviceEll`` of width
    ``max(ell_row_length, 1)``, and ``coo``, the COO part as a
    ``DeviceCsr`` (``from_coo_host``), whose ``row_list`` holds the short
    rows that own a COO entry (empty where the COO part is) and
    ``long_rows`` its long ones (``csr_row_split``)."""

    format_name = "hybrid"

    def __init__(self, num_rows: int, num_columns: int, num_entries: int,
                 ell: DeviceEll, coo: DeviceCsr):
        super().__init__()
        self.num_rows = int(num_rows)
        self.num_columns = int(num_columns)
        self.num_entries = int(num_entries)
        self.ell = ell
        self.coo = coo

    @classmethod
    def from_host(cls, m: HybridMatrix, dtype: Optional[torch.dtype] = None,
                  device=None) -> "DeviceHybrid":
        """Device conversion, as ``spmv_tpu``'s ``DeviceHybrid.from_host``."""
        ell_host = EllMatrix(
            m.num_rows, m.num_columns, m.num_ell_entries,
            max(m.ell_row_length, 1),
            m.ell_column_index
            if m.ell_row_length > 0
            else np.zeros((m.num_rows, 1), dtype=np.int32),
            m.ell_value
            if m.ell_row_length > 0
            else np.zeros((m.num_rows, 1)),
            m.ell_skip_padding,
        )
        coo_host = CooMatrix(
            m.num_rows, m.num_columns, m.num_coo_entries,
            m.coo_row_index, m.coo_column_index, m.coo_value,
        )
        return cls(m.num_rows, m.num_columns, m.num_entries,
                   DeviceEll.from_host(ell_host, dtype=dtype, device=device),
                   DeviceCsr.from_coo_host(coo_host, dtype=dtype,
                                           device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x (the plain versions on the CPU; on CUDA the ELL
        kernel, then the CSR kernel adding the COO part)."""
        from spmv_tpu_torch.ops.dispatch import spmv

        return spmv(self, x)


def _check_value_dtype(dtype: torch.dtype, what: str) -> None:
    if dtype.itemsize < 4 or not dtype.is_floating_point:
        raise MatrixError(
            f"{what} requires a >=32-bit value dtype; got "
            f"{str(dtype).replace('torch.', '')}.")


def level_index_bits(d: int) -> int:
    """Bits of the level index K3a reads for a level of window multiple
    ``d``: a level cell's ``local_index`` is ``w * 128 + lane < 1024 d``,
    so 16 where that fits an int16 (d <= 32), else 32."""
    return 16 if LANE * SUBLANE * int(d) <= 1 << 15 else 32


def _int16_copy(local_index: np.ndarray, what: str) -> np.ndarray:
    narrow = local_index.astype(np.int16)
    if not np.array_equal(narrow, local_index):
        raise MatrixError(f"{what}: a local_index does not fit int16")
    return narrow


class DeviceCwLevel(torch.nn.Module):
    """One WELL-CW level of the fallback layout (kernel K3a).

    Buffers, as in the JAX container: ``value`` (chunks, 8, 128),
    ``local_index`` (chunks, 8, 128) int32, ``anchor4`` and
    ``group_of_chunk`` (steps, 1, K) int32, ``block_of_step`` (steps,)
    int32; and, derived on the host for K3a:

    - ``group_ptr`` (num_groups + 1,) int32: group g's chunks are
      ``[group_ptr[g], group_ptr[g + 1])`` (``group_of_chunk`` is
      non-decreasing), so one CUDA thread per (group, lane) finds its
      run without the TPU's in-order grid;
    - ``local_index16`` (chunks, 8, 128) int16, ``local_index``'s values
      where ``level_index_bits(d)`` is 16, else None: K3a reads it in
      place of ``local_index`` (2 bytes a cell instead of 4).

    Metadata: ``d``, ``num_chunks``, ``chunks_per_step`` (K) and ``xr4``
    (the JAX stride-table height, kept for parity; no table is built).
    """

    def __init__(self, d, chunks_per_step, xr4, value, local_index,
                 anchor4, group_of_chunk, block_of_step, num_groups,
                 dtype, device=None):
        super().__init__()
        self.d = int(d)
        self.num_chunks = int(value.shape[0])
        self.chunks_per_step = int(chunks_per_step)
        self.xr4 = int(xr4)
        grp = np.asarray(group_of_chunk).reshape(-1)
        ptr = np.searchsorted(grp, np.arange(num_groups + 1))
        self.register_buffer("value", _tensor(value, device, dtype))
        local_index = np.asarray(local_index).astype(np.int32)
        self.register_buffer("local_index", _tensor(local_index, device))
        self.register_buffer(
            "local_index16",
            _tensor(_int16_copy(local_index, "DeviceCwLevel"), device)
            if level_index_bits(self.d) == 16 else None)
        self.register_buffer("anchor4",
                             _tensor(anchor4.astype(np.int32), device))
        self.register_buffer("group_of_chunk",
                             _tensor(group_of_chunk.astype(np.int32), device))
        self.register_buffer("block_of_step",
                             _tensor(block_of_step.astype(np.int32), device))
        self.register_buffer("group_ptr",
                             _tensor(ptr.astype(np.int32), device))


class DeviceCwPool(torch.nn.Module):
    """A pooled WELL-CW level (kernel K3b): the fallback layout's
    stage-1 pool, or a tail pool of either layout.  Chunks are shared
    across the ``out_rows`` groups of one output block; ``rowmap`` holds
    each cell's global group.

    Buffers, as in the JAX container: ``value``, ``local_index`` and
    ``rowmap`` (chunks, 8, 128), ``anchor4`` (steps, 1, K),
    ``block_of_step`` (steps,); and

    - ``block_ptr`` (num_blocks + 1,) int32: output block b's chunks are
      ``[block_ptr[b], block_ptr[b + 1])``, so one CUDA block per output
      block finds its run;
    - for K4c, one thread a row, the row list (``pool_row_list``) laid
      out in slices of 32 rows (``sliced_row_list``): ``list_rows`` (n,)
      int32, the Y rows that own a cell, longest run first,
      ``list_len`` (n,) int32 their runs' lengths, ``list_slice``
      (ceil(n / 32) + 1,) int32 each slice's first cell, and per cell
      ``list_col`` (int32) and ``list_value``: cell i of row t is at
      ``list_slice[t // 32] + 32 i + t % 32``.

    Metadata: ``d``, ``num_chunks``, ``chunks_per_step``, ``xr4`` and
    ``out_rows`` (64 for the stage-1 pool, the pool width for a tail).
    """

    def __init__(self, d, chunks_per_step, xr4, value, local_index,
                 anchor4, rowmap, block_of_step, num_groups, dtype,
                 device=None, out_rows: int = 64):
        super().__init__()
        self.d = int(d)
        self.num_chunks = int(value.shape[0])
        self.chunks_per_step = int(chunks_per_step)
        self.xr4 = int(xr4)
        self.out_rows = int(out_rows)
        self.num_blocks = -(-int(num_groups) // self.out_rows)
        blks = np.asarray(block_of_step).reshape(-1)
        ptr = np.searchsorted(blks, np.arange(self.num_blocks + 1)) \
            * self.chunks_per_step
        self.register_buffer("value", _tensor(value, device, dtype))
        self.register_buffer("local_index",
                             _tensor(local_index.astype(np.int32), device))
        self.register_buffer("anchor4",
                             _tensor(anchor4.astype(np.int32), device))
        self.register_buffer("rowmap", _tensor(rowmap.astype(np.int32), device))
        self.register_buffer("block_of_step",
                             _tensor(block_of_step.astype(np.int32), device))
        self.register_buffer("block_ptr",
                             _tensor(ptr.astype(np.int32), device))
        rows = sliced_row_list(*pool_row_list(
            value, local_index, anchor4, rowmap, self.d, self.out_rows, ptr))
        for name, a in zip(("list_rows", "list_len", "list_slice",
                            "list_col", "list_value"), rows):
            self.register_buffer(name, _tensor(
                a, device, dtype if name == "list_value" else None))


def pool_row_list(value, local_index, anchor4, rowmap, d: int,
                  out_rows: int, block_ptr) -> tuple:
    """The cells of a pool as K4c adds them, one run a row: ``(rows, ptr,
    col, value)`` numpy arrays.

    The cells of output block b are those of its chunks ``[block_ptr[b],
    block_ptr[b + 1])``; one of chunk c, slot s, lane l with ``rowmap``
    g belongs to Y row ``g * 128 + l`` and reads x at column ``(anchor4[c]
    * d + (loc >> 7)) * 128 + (loc & 127)``.  Every cell whose group g
    lies in the block's ``[b * out_rows, (b + 1) * out_rows)`` is kept,
    values of 0 and columns past the end included (K4c reads 0 there),
    as the Pallas kernel's tile adds them; the rest are dropped.  The
    cells are sorted stably by row, so each row keeps the storage order
    (chunk, then slot) that the tile adds them in.  ``rows`` holds the
    rows that own a cell, ascending, and ``ptr`` (len(rows) + 1,) int32
    their runs' bounds."""
    value = np.asarray(value)
    chunks = value.shape[0]
    ptr = np.asarray(block_ptr, np.int64)
    block = np.full(chunks, -1, np.int64)      # a chunk of no block: none
    block[ptr[0]:ptr[-1]] = np.repeat(np.arange(ptr.size - 1), np.diff(ptr))
    group = np.asarray(rowmap).reshape(chunks, SUBLANE, LANE) \
        .astype(np.int64)
    rel = group - block[:, None, None] * out_rows
    row = group * LANE + np.arange(LANE, dtype=np.int64)
    loc = np.asarray(local_index).reshape(chunks, SUBLANE, LANE) \
        .astype(np.int64)
    a4 = np.asarray(anchor4).reshape(-1).astype(np.int64)[:, None, None]
    col = (a4 * d + (loc >> 7)) * LANE + (loc & (LANE - 1))
    keep = (rel >= 0) & (rel < out_rows) & (block >= 0)[:, None, None]
    row, col, v = row[keep], col[keep], value.reshape(chunks, SUBLANE,
                                                      LANE)[keep]
    if row.size and max(row.max(), col.max()) > np.iinfo(np.int32).max:
        raise MatrixError("pool_row_list: a row or column does not fit "
                          "int32")
    order = np.argsort(row, kind="stable")
    rows, counts = np.unique(row, return_counts=True)
    run = np.zeros(rows.size + 1, np.int64)
    np.cumsum(counts, out=run[1:])
    return (rows.astype(np.int32), run.astype(np.int32),
            col[order].astype(np.int32), v[order])


def csr_row_split(row_ptr, long_row: int, block_row: int) -> tuple:
    """The CSR kernels' split of a matrix's rows by length:
    ``(long_rows, num_block_rows, row_list)``.

    - ``long_rows``: the rows with more than ``long_row`` entries,
      longest first (ties by row), int32, or None where there is none;
    - ``num_block_rows``: how many of them, at the front, hold more than
      ``block_row`` entries (a block each; the rest a warp each);
    - ``row_list``: the rows with 1 to ``long_row`` entries, ascending,
      int32, or None where every row owns an entry."""
    lengths = np.diff(np.asarray(row_ptr, np.int64))
    long = np.flatnonzero(lengths > long_row)
    long_rows, num_block_rows = None, 0
    if long.size:
        long_rows = long[np.lexsort((long, -lengths[long]))].astype(np.int32)
        num_block_rows = int((lengths[long] > block_row).sum())
    owned = lengths > 0
    row_list = None if owned.all() else np.flatnonzero(
        owned & (lengths <= long_row)).astype(np.int32)
    return long_rows, num_block_rows, row_list


def sliced_row_list(rows, ptr, col, value, width: int = 32) -> tuple:
    """A row list (``pool_row_list``) as K4c reads it, a warp a slice of
    ``width`` rows: ``(rows, lengths, slices, col, value)``.

    The rows are ordered by their runs' lengths, longest first (ties by
    row), so the rows of one slice have runs of about one length and the
    longest runs (the zero-valued padding cells of a packed pool pile
    onto a few rows) spread over the card's first CTAs.  Slice k holds
    rows ``width k ..`` of that order; its cells start at ``slices[k]``
    and lie slot-major, cell i of the slice's row l at ``slices[k] +
    width i + l``, so the lanes of a warp read neighbouring cells.  Each
    row keeps its run in order; the places past a shorter run hold
    column -1 and value 0, which K4c does not read (it stops at the
    row's length).  ``slices`` (ceil(n / width) + 1,) int32."""
    n = np.diff(np.asarray(ptr, np.int64))
    order = np.lexsort((np.asarray(rows), -n))
    n = n[order]
    slices = -(-n.size // width)
    span = np.zeros(slices * width, np.int64)
    span[:n.size] = n
    span = span.reshape(slices, width).max(axis=1)
    start = np.zeros(slices + 1, np.int64)
    np.cumsum(span * width, out=start[1:])
    if start[-1] > np.iinfo(np.int32).max:
        raise MatrixError("sliced_row_list: the cells do not fit int32")
    out_col = np.full(start[-1], -1, np.int32)
    out_value = np.zeros(start[-1], np.asarray(value).dtype)
    t = np.repeat(np.arange(n.size), n)                 # cell -> slot
    i = np.arange(t.size) - np.repeat(np.cumsum(n) - n, n)
    where = start[t // width] + width * i + t % width
    src = np.repeat(np.asarray(ptr, np.int64)[:-1][order], n) + i
    out_col[where] = np.asarray(col)[src]
    out_value[where] = np.asarray(value)[src]
    return (np.asarray(rows)[order].astype(np.int32), n.astype(np.int32),
            start.astype(np.int32), out_col, out_value)


class DeviceCwMerged(torch.nn.Module):
    """The merged WELL-CW grid (kernel K3c): the single level's dense
    slots and the capped stage-1 pool of each 64-group output block in
    one run of ``kl = 64 * cap + pool_per_block`` chunks.

    - chunk kk < ``lvl_per_block`` of block b is a level chunk of group
      ``b * 64 + kk // cap``;
    - the rest are pool chunks, with the cell's row relative to the
      block in ``local_index`` bits 14 and up.

    Buffers, as in the JAX container: ``value`` and ``local_index``
    (num_blocks * kl, 8, 128), ``anchor4`` (num_blocks, 1, kl).  The
    chunk positions are static, so a CUDA grid needs no extra index.
    Derived on the host:

    - for K3c, which stages each block's part of x in shared memory,
      ``x_window`` (num_blocks, 2) int32: block b's cells of nonzero
      value read columns in [x_window[b, 0], x_window[b, 1]), the first
      rounded down to a multiple of 4 ([0, 0) for a block with none);
      ``max_window`` is the widest;
    - for K4a, one thread a row, the pool list (``merged_pool_list``),
      or None without pool chunks: ``pool_ptr`` (num_blocks * 128 * 64
      + 1,) int32 over the (block, lane, tile row) triples, so that row
      (b * 64 + r) * 128 + l owns entries ``[pool_ptr[i], pool_ptr[i +
      1])``, i = (b * 128 + l) * 64 + r, and per entry its column
      ``pool_col`` (int32) and ``pool_value``;
    - ``level_index16`` (num_blocks * 64 * cap, 8, 128) int16, the level
      chunks' ``local_index`` (< 1024 d, and a merged grid has d <= 16),
      which K4a's level part reads in place of ``local_index``.
    """

    def __init__(self, d, kl, cap, lvl_per_block, pool_per_block,
                 num_blocks, xr4, value, local_index, anchor4, dtype,
                 device=None):
        super().__init__()
        self.d = int(d)
        self.kl = int(kl)
        self.cap = int(cap)
        self.lvl_per_block = int(lvl_per_block)
        self.pool_per_block = int(pool_per_block)
        self.num_blocks = int(num_blocks)
        self.xr4 = int(xr4)
        self.register_buffer("value", _tensor(value, device, dtype))
        self.register_buffer("local_index",
                             _tensor(local_index.astype(np.int32), device))
        self.register_buffer("anchor4",
                             _tensor(anchor4.astype(np.int32), device))
        win = _x_windows(value, local_index, anchor4, self.d,
                         np.arange(self.num_blocks * self.kl) // self.kl,
                         self.num_blocks)
        self.max_window = int((win[:, 1] - win[:, 0]).max(initial=0))
        self.register_buffer("x_window", _tensor(win, device))
        pool = merged_pool_list(value, local_index, anchor4, self.d,
                                self.kl, self.lvl_per_block,
                                self.num_blocks)
        for name, a in zip(("pool_ptr", "pool_col", "pool_value"),
                           pool or (None,) * 3):
            self.register_buffer(name, None if a is None else _tensor(
                a, device, dtype if name == "pool_value" else None))
        level = np.asarray(local_index).reshape(
            self.num_blocks, self.kl, SUBLANE, LANE)[:, :self.lvl_per_block]
        self.register_buffer("level_index16", _tensor(_int16_copy(
            level.reshape(-1, SUBLANE, LANE), "DeviceCwMerged"), device))


def merged_pool_list(value, local_index, anchor4, d: int, kl: int,
                     lvl_per_block: int,
                     num_blocks: int) -> Optional[tuple]:
    """The pool cells of a merged grid as K4a adds them, one run a row:
    ``(ptr, col, value)`` numpy arrays, or None without pool chunks.

    Every cell of a pool chunk whose tile row (``local_index >> 14``)
    lies in [0, 64) is kept, values of 0 included; one of row r of block
    b, in lane l, belongs to row ``(b * 64 + r) * 128 + l`` and reads x
    at column ``(anchor4 * d + ((loc >> 7) & (8 d - 1))) * 128 + (loc &
    127)``.  The cells are sorted stably by (block, lane, tile row), so
    each row keeps the storage order (chunk, then slot) that the Pallas
    kernel adds them in, and the runs of a warp's 32 rows (32 lanes of
    one tile row) lie 64 runs apart; ``ptr`` (num_blocks * 8192 + 1,)
    int32 holds the runs' bounds in that order.  (Sorted by row, so that
    a warp's runs lie side by side, K4a measured slower.)"""
    S, P = int(num_blocks), int(kl) - int(lvl_per_block)
    if P == 0:
        return None
    shape = (S, int(kl), SUBLANE, LANE)
    v = np.asarray(value).reshape(shape)[:, lvl_per_block:]
    loc = np.asarray(local_index).reshape(shape)[:, lvl_per_block:] \
        .astype(np.int64)
    a4 = np.asarray(anchor4).reshape(S, int(kl))[:, lvl_per_block:] \
        .astype(np.int64)
    row = loc >> 14
    col = ((a4[:, :, None, None] * d + ((loc >> 7) & (8 * d - 1))) * LANE
           + (loc & (LANE - 1)))
    b = np.arange(S, dtype=np.int64)[:, None, None, None]
    lane = np.arange(LANE, dtype=np.int64)
    key = (b * LANE + lane) * 64 + row
    keep = (row >= 0) & (row < 64)
    key, col, v = key[keep], col[keep], v[keep]
    if col.size and col.max() > np.iinfo(np.int32).max:
        raise MatrixError("merged_pool_list: a column does not fit int32")
    order = np.argsort(key, kind="stable")
    ptr = np.zeros(S * 64 * LANE + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=S * 64 * LANE), out=ptr[1:])
    return (ptr.astype(np.int32), col[order].astype(np.int32),
            v[order])


def _x_windows(value, local_index, anchor4, d, block_of_chunk, num_blocks):
    """(num_blocks, 2) int32 [lo, hi): the columns of x that the cells of
    nonzero value of each block read (merged-grid addressing, w = (loc
    >> 7) & (8 d - 1)), lo rounded down to a multiple of 4; [0, 0) for a
    block with none."""
    step = 4096                # chunks at a time, to bound the host memory
    value, local_index = np.asarray(value), np.asarray(local_index)
    a4 = np.asarray(anchor4).reshape(-1).astype(np.int64)
    big = np.iinfo(np.int64).max
    cmin = np.full(a4.size, big)
    cmax = np.full(a4.size, -1)
    for c in range(0, a4.size, step):
        loc = local_index[c:c + step].astype(np.int64)
        col = ((a4[c:c + step, None, None] * d + ((loc >> 7) & (8 * d - 1)))
               * LANE + (loc & (LANE - 1)))
        nonzero = value[c:c + step] != 0
        cmin[c:c + step] = np.where(nonzero, col, big).min(axis=(1, 2))
        cmax[c:c + step] = np.where(nonzero, col, -1).max(axis=(1, 2))
    lo = np.full(num_blocks, big)
    hi = np.full(num_blocks, -1)
    np.minimum.at(lo, block_of_chunk, cmin)
    np.maximum.at(hi, block_of_chunk, cmax)
    empty = hi < 0
    return np.stack([np.where(empty, 0, lo // 4 * 4),
                     np.where(empty, 0, hi + 1)], axis=1).astype(np.int32)


class DeviceWellCw(torch.nn.Module):
    """WELL-CW (chunk-window WELL) on a device; see
    ``spmv_tpu.models.wellcw`` for the format.

    Two layouts, chosen as the JAX container chooses:

    - **merged**: ``merged`` holds the level and the stage-1 pool
      (``levels`` empty, ``pool`` None), when the host matrix has one
      level whose dense slots waste little;
    - **fallback**: ``levels`` and ``pool`` (``merged`` None), for
      multi-level specs, small matrices, or an explicit
      ``chunks_per_step``.

    ``tail_pools`` (wide pools) and ``remainder`` (a ``DeviceCsr``) add
    to either.  The product runs them in that order: merged, levels,
    pool, tail pools, remainder.
    """

    format_name = "wellcw"

    def __init__(self, num_rows, num_columns, num_entries, num_groups,
                 blocks_per_out, levels=(), pool=None, remainder=None,
                 merged=None, tail_pools=()):
        super().__init__()
        self.num_rows = int(num_rows)
        self.num_columns = int(num_columns)
        self.num_entries = int(num_entries)
        self.num_groups = int(num_groups)
        self.blocks_per_out = int(blocks_per_out)
        self.levels = torch.nn.ModuleList(levels)
        self.register_module("pool", pool)
        self.register_module("remainder", remainder)
        self.register_module("merged", merged)
        self.tail_pools = torch.nn.ModuleList(tail_pools)

    @property
    def value_dtype(self) -> torch.dtype:
        src = self.merged if self.merged is not None else self.levels[0]
        return src.value.dtype

    @classmethod
    def from_host(cls, m, dtype: Optional[torch.dtype] = None,
                  blocks_per_out: Optional[int] = None,
                  chunks_per_step: Optional[int] = None,
                  device=None) -> "DeviceWellCw":
        """Device conversion, as ``spmv_tpu``'s ``DeviceWellCw.from_host``:
        the same layout choice, K (chunks per step), B (8-group blocks
        per output block) and arrays."""
        dtype = dtype or default_value_dtype()
        _check_value_dtype(dtype, "DeviceWellCw")
        num_groups = m.num_groups
        has_pool = getattr(m, "pool", None) is not None
        if blocks_per_out is None:
            blocks_per_out = max(1, min(8, num_groups // SUBLANE))
            if has_pool:
                # pooled chunks span POOL_GROUPS=64 groups = one
                # 8-block output tile; the out block must cover them
                blocks_per_out = 8
        elif has_pool and int(blocks_per_out) != 8:
            raise MatrixError(
                "a pooled WELL-CW matrix requires blocks_per_out=8 "
                "(pool spans 64 groups)")
        b_out = int(blocks_per_out)
        out_rows = SUBLANE * b_out
        num_blocks = -(-num_groups // (SUBLANE * b_out))

        tails = []
        for tp in getattr(m, "tail_pools", ()):
            # step size from the actual run lengths (a deep catch-all
            # ladder may hold thin 2-chunk runs)
            counts = np.bincount(np.asarray(tp.pool_of_chunk))
            max_run = int(counts.max(initial=1))
            kp = 1 << int(np.ceil(np.log2(max(1, max_run))))
            kp = max(1, min(kp, 64))
            t_rows = int(tp.pool_groups)
            base_grp = np.asarray(tp.pool_of_chunk).astype(np.int64) * t_rows
            tv, tl, tws, _g, tblks, trm = _pad_cw_steps(
                np.asarray(tp.value), np.asarray(tp.local_index),
                np.asarray(tp.anchor4), base_grp, num_groups,
                k=kp, out_rows=t_rows, rowmap=np.asarray(tp.rowmap))
            tails.append(DeviceCwPool(
                tp.d, kp, _xr4(m, tp), tv, tl, tws, trm, tblks,
                num_groups, dtype, device, out_rows=t_rows))

        remainder = None
        if m.remainder is not None:
            remainder = DeviceCsr.from_host(m.remainder, dtype=dtype,
                                            device=device)

        merged = None
        if chunks_per_step is None:
            mg = _build_cw_merged(m)
            if mg is not None:
                merged = DeviceCwMerged(**mg, dtype=dtype, device=device)
        if merged is not None:
            return cls(m.num_rows, m.num_columns, m.num_entries,
                       num_groups, 8, remainder=remainder, merged=merged,
                       tail_pools=tails)

        levels = []
        for lv in m.levels:
            k = (_steps_for(lv.num_chunks, num_blocks)
                 if chunks_per_step is None else int(chunks_per_step))
            value, loc, ws, grp2, blks = _pad_cw_steps(
                np.asarray(lv.value), np.asarray(lv.local_index),
                np.asarray(lv.anchor4), np.asarray(lv.group_of_chunk),
                num_groups, k=k, out_rows=out_rows)
            levels.append(DeviceCwLevel(
                lv.d, k, _xr4(m, lv), value, loc, ws, grp2, blks,
                num_groups, dtype, device))
        pool = None
        if has_pool:
            pl_ = m.pool
            kp = (_steps_for(pl_.num_chunks, num_blocks)
                  if chunks_per_step is None else int(chunks_per_step))
            # pool_of_chunk indexes 64-group pools == output blocks, so
            # feeding base-group ids to the padder reuses its block-run
            # logic unchanged
            base_grp = np.asarray(pl_.pool_of_chunk).astype(np.int64) \
                * out_rows
            value, loc, ws, _grp2, blks, rm = _pad_cw_steps(
                np.asarray(pl_.value), np.asarray(pl_.local_index),
                np.asarray(pl_.anchor4), base_grp, num_groups, k=kp,
                out_rows=out_rows, rowmap=np.asarray(pl_.rowmap))
            pool = DeviceCwPool(pl_.d, kp, _xr4(m, pl_), value, loc, ws,
                                rm, blks, num_groups, dtype, device)
        return cls(m.num_rows, m.num_columns, m.num_entries, num_groups,
                   b_out, levels=levels, pool=pool, remainder=remainder,
                   tail_pools=tails)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x (the plain versions on the CPU, kernels K3a-c and
        the CSR kernel on CUDA)."""
        from spmv_tpu_torch.ops.dispatch import spmv

        return spmv(self, x)


def _steps_for(num_chunks: int, num_blocks: int) -> int:
    """Default chunks per step of a fallback level or pool, by the
    average chunks per output block."""
    avg = num_chunks / max(num_blocks, 1)
    return 64 if avg >= 32 else 32 if avg >= 16 else 16 if avg >= 8 else 8


def _xr4(m, lvl) -> int:
    """The JAX stride-table height of a level or pool: covers the whole
    column space and the largest anchor's 8-row slice."""
    a_max = int(np.asarray(lvl.anchor4).max(initial=0))
    return round_up(max(-(-m.num_columns // (LANE * lvl.d)),
                        a_max + SUBLANE), SUBLANE)


def _pad_cw_steps(value, loc, a4, grp, num_groups, k, out_rows,
                  rowmap=None):
    """Pad each output block's chunk run to a multiple of K with inert
    chunks (value 0, anchor 0) so one grid step never spans two output
    blocks; pad chunks carry the block's last group so group ids stay
    non-decreasing.  Returns step-staged (value, loc, ws, grp2,
    block_of_step[, rowmap]) — ``rowmap`` (pooled levels) is padded
    with each chunk's group id broadcast (inert cells scatter zero)."""
    # each output row of the (padded_groups, 128) result is one group,
    # so a block of out_rows output rows covers out_rows groups
    b_groups = out_rows
    blk = grp // out_rows
    num_blocks = -(-num_groups // b_groups)
    starts = np.searchsorted(blk, np.arange(num_blocks + 1))
    counts = np.diff(starts)
    padded = np.where(counts == 0, k, -(-counts // k) * k)
    out_start = np.concatenate([[0], np.cumsum(padded)])
    total = int(out_start[-1])
    value_o = np.zeros((total, SUBLANE, LANE), value.dtype)
    loc_o = np.zeros((total, SUBLANE, LANE), np.int32)
    a4_o = np.zeros(total, np.int32)
    gpad = np.minimum(
        np.arange(num_blocks) * b_groups + b_groups - 1,
        num_groups - 1).astype(np.int32)
    has = counts > 0
    gpad[has] = grp[starts[1:][has] - 1]
    grp_o = np.repeat(gpad, padded)
    pos = np.arange(value.shape[0]) - starts[:-1][blk] \
        + out_start[:-1][blk]
    value_o[pos] = value
    loc_o[pos] = loc
    a4_o[pos] = a4
    grp_o[pos] = grp
    blks = np.repeat(np.arange(num_blocks, dtype=np.int32),
                     padded // k)
    steps = total // k
    ws = a4_o.reshape(steps, 1, k)
    grp2 = grp_o.reshape(steps, 1, k)
    if rowmap is not None:
        rm_o = np.broadcast_to(
            grp_o[:, None, None], (total, SUBLANE, LANE)
        ).astype(np.int32).copy()
        rm_o[pos] = rowmap
        return value_o, loc_o, ws, grp2, blks, rm_o
    return value_o, loc_o, ws, grp2, blks


def _build_cw_merged(m):
    """The merged level+pool grid's arguments (the fields of
    ``DeviceCwMerged`` as numpy arrays) when the host matrix fits the
    dense-slot pattern, else None.

    Eligible iff: exactly one level with recorded ranks, pool (if any)
    shares the level's window width and pools 64 groups with a
    mergeable cap, and the dense slots (round_up(ng,64) * cap per block)
    would waste <= 15% extra chunks over the packed level.
    """
    levels = getattr(m, "levels", ())
    if len(levels) != 1:
        return None
    lvl = levels[0]
    if not lvl.cap or lvl.rank_of_chunk is None:
        return None
    pool = getattr(m, "pool", None)
    if pool is not None and (
        pool.d != lvl.d or pool.pool_groups != 64
        or not (0 < pool.cap <= 64)
    ):
        return None
    if lvl.d > 16:
        return None               # rowmap fold needs loc bits >= 14
    ng = m.num_groups
    ng_pad = round_up(ng, 64)
    cap = int(lvl.cap)
    lvl_per = 64 * cap
    pool_per = int(pool.cap) if pool is not None else 0
    kl = lvl_per + pool_per
    if kl > 256:
        return None               # the TPU kernel's unroll bound
    dense_total = ng_pad * cap
    if dense_total > max(lvl.num_chunks, 1) * 1.15:
        return None               # zero-filled slots would dominate
    S = ng_pad // 64

    value = np.zeros((S * kl, SUBLANE, LANE),
                     dtype=np.asarray(lvl.value).dtype)
    loc = np.zeros((S * kl, SUBLANE, LANE), dtype=np.int32)
    a4 = np.zeros(S * kl, dtype=np.int32)

    grp = np.asarray(lvl.group_of_chunk).astype(np.int64)
    rank = np.asarray(lvl.rank_of_chunk).astype(np.int64)
    didx = (grp // 64) * kl + (grp % 64) * cap + rank
    value[didx] = np.asarray(lvl.value)
    loc[didx] = np.asarray(lvl.local_index)
    a4[didx] = np.asarray(lvl.anchor4)
    a_max = int(np.asarray(lvl.anchor4).max(initial=0))

    if pool is not None:
        base_grp = np.asarray(pool.pool_of_chunk).astype(np.int64) * 64
        pv, plc, pws, _g, _blks, prm = _pad_cw_steps(
            np.asarray(pool.value), np.asarray(pool.local_index),
            np.asarray(pool.anchor4), base_grp, ng,
            k=pool_per, out_rows=64, rowmap=np.asarray(pool.rowmap))
        n_pool = pv.shape[0]
        if n_pool != S * pool_per:
            return None           # a pool run exceeded its cap
        blk_of = np.arange(n_pool) // pool_per
        rm_rel = prm - (blk_of * 64)[:, None, None]
        if rm_rel.min() < 0 or rm_rel.max() >= 64:
            return None
        if int(plc.max(initial=0)) >= (1 << 14):
            return None           # fold would clobber loc bits
        plc = (plc | (rm_rel.astype(np.int32) << 14)).astype(np.int32)
        pidx = blk_of * kl + lvl_per + np.arange(n_pool) % pool_per
        value[pidx] = pv
        loc[pidx] = plc
        a4[pidx] = pws.reshape(-1)
        a_max = max(a_max, int(np.asarray(pool.anchor4).max(initial=0)))

    xr4 = round_up(
        max(-(-m.num_columns // (LANE * lvl.d)), a_max + SUBLANE),
        SUBLANE)
    return dict(d=lvl.d, kl=kl, cap=cap, lvl_per_block=lvl_per,
                pool_per_block=pool_per, num_blocks=S, xr4=int(xr4),
                value=value, local_index=loc,
                anchor4=a4.reshape(S, 1, kl))


def live_slot_mask(value: torch.Tensor) -> np.ndarray:
    """(chunks,) uint8 of a (chunks, 8, 128) WELL ``value``: bit s set iff
    slot s holds a nonzero value."""
    live = (value != 0).any(dim=2).numpy()           # (chunks, 8)
    bits = (1 << np.arange(SUBLANE)).astype(np.uint8)
    return (live * bits).sum(axis=1, dtype=np.uint8)


def lane_ordered_spill(spill: "DeviceCsr", out_rows: int,
                       num_out_blocks: int) -> tuple:
    """The spill's entries as K5 adds them: ``(ptr, tile_row, column,
    value)`` with ``ptr`` (num_out_blocks * 128 + 1,) over the (output
    block, lane) pairs and the entries sorted by (block, lane, tile row,
    column), all on the CPU.  Row r lies in group ``r // 128``, lane ``r
    % 128``, output block ``group // out_rows`` and tile row ``group %
    out_rows``."""
    row_ptr = spill.row_ptr.cpu().numpy().astype(np.int64)
    col = spill.column_index.cpu().numpy()
    rows = np.repeat(np.arange(spill.num_rows, dtype=np.int64),
                     np.diff(row_ptr))
    group, lane = rows // LANE, rows % LANE
    tile_row = group % out_rows
    key = group // out_rows * LANE + lane
    order = np.lexsort((col, tile_row, key))
    ptr = np.zeros(num_out_blocks * LANE + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=num_out_blocks * LANE),
              out=ptr[1:])
    return (torch.from_numpy(ptr.astype(np.int32)),
            torch.from_numpy(tile_row[order].astype(np.int32)),
            torch.from_numpy(col[order].astype(np.int32)),
            spill.value.cpu()[torch.from_numpy(order)])


class DeviceWell(torch.nn.Module):
    """WELL (windowed sliced-ELL) on a device; see
    ``spmv_tpu_torch.models.well`` for the format.

    Buffers, as in the JAX container (kernels K5a and K5b):

    - ``value`` (chunks, 8, 128), the value dtype, and ``local_index``
      (chunks, 8, 128) int32: slot s of chunk c reads x at column
      ``(window_start + segment) * 128 + local_index`` for row
      ``group_of_chunk[c] * 128 + lane``;
    - ``window_start`` (steps, 8, K) int32, step-major as the TPU staged
      it: ``window_start[t, s, kk]`` belongs to chunk ``t * K + kk``;
      relative to the step's segment in segmented mode;
    - ``group_of_chunk`` (steps, 1, K) int32 and ``block_of_step``
      (steps,) int32, the output block of each step;
    - ``segment_of_step`` (steps,) int32, the x row each step's segment
      starts at, or None in whole-x mode; and
    - ``step_ptr`` (num_out_blocks + 1,) int32: output block b's steps
      are ``[step_ptr[b], step_ptr[b + 1])`` (the packer keeps a block's
      steps together), so one CUDA block per output block finds its run
      without the TPU's in-order grid.

    ``spill`` is the out-of-window remainder as a ``DeviceCsr`` (or
    None).  Metadata: ``num_rows``, ``num_columns``, ``num_entries``,
    ``window_rows``, ``num_chunks``, ``num_groups``, ``chunks_per_step``
    (K), ``blocks_per_out`` (B: 8-group blocks per output block) and
    ``segment_rows`` (None in whole-x mode).

    Buffers the JAX container has no use for, built on the host by the
    constructor for K5:

    - ``slot_mask`` (chunks,) uint8: bit s is set iff slot s of the chunk
      holds a nonzero value (``live_slot_mask``).  A slot the segment
      spill emptied, and an inert padding chunk, have their bits clear
      although they may keep a nonzero ``local_index``; K5 reads nothing
      of a slot whose bit is clear.
    - The spill in lane order (``lane_ordered_spill``), or None without a
      spill: ``spill_ptr`` (num_out_blocks * 128 + 1,) int32, so that
      lane l of output block b owns entries ``[spill_ptr[b * 128 + l],
      spill_ptr[b * 128 + l + 1])``, and per entry its tile row
      ``spill_row`` (int32, the group within the output block), its
      column ``spill_col`` (int32) and ``spill_value``, sorted by
      (block, lane, tile row, column).
    """

    format_name = "well"

    def __init__(self, num_rows, num_columns, num_entries, window_rows,
                 num_groups, chunks_per_step, blocks_per_out, segment_rows,
                 value, local_index, window_start, group_of_chunk,
                 block_of_step, segment_of_step=None, spill=None,
                 dtype=None, device=None):
        super().__init__()
        self.num_rows = int(num_rows)
        self.num_columns = int(num_columns)
        self.num_entries = int(num_entries)
        self.window_rows = int(window_rows)
        self.num_chunks = int(value.shape[0])
        self.num_groups = int(num_groups)
        self.chunks_per_step = int(chunks_per_step)
        self.blocks_per_out = int(blocks_per_out)
        self.segment_rows = (None if segment_rows is None
                             else int(segment_rows))
        self.out_rows = SUBLANE * self.blocks_per_out
        self.num_out_blocks = -(-self.num_groups // self.out_rows)
        blks = np.asarray(block_of_step).reshape(-1)
        if (np.diff(blks) < 0).any():
            raise MatrixError("DeviceWell: block_of_step must be "
                              "non-decreasing (one run of steps a block)")
        ptr = np.searchsorted(blks, np.arange(self.num_out_blocks + 1))
        host_value = _tensor(value, "cpu", dtype)
        self.register_buffer("value", host_value.to(device))
        self.register_buffer("slot_mask",
                             _tensor(live_slot_mask(host_value), device))
        for name, a in (("local_index", local_index),
                        ("window_start", window_start),
                        ("group_of_chunk", group_of_chunk),
                        ("block_of_step", block_of_step),
                        ("step_ptr", ptr)):
            self.register_buffer(
                name, _tensor(np.asarray(a).astype(np.int32), device))
        self.register_buffer("segment_of_step", None if segment_of_step is None
                             else _tensor(np.asarray(segment_of_step)
                                          .astype(np.int32), device))
        self.register_module("spill", spill)
        lane = (None,) * 4 if spill is None else lane_ordered_spill(
            spill, self.out_rows, self.num_out_blocks)
        for name, t in zip(("spill_ptr", "spill_row", "spill_col",
                            "spill_value"), lane):
            self.register_buffer(
                name, None if t is None else t.to(spill.value.device))

    @property
    def value_dtype(self) -> torch.dtype:
        return self.value.dtype

    @classmethod
    def from_host(
        cls, m: WellMatrix, dtype: Optional[torch.dtype] = None,
        chunks_per_step: int = 8, segment_rows: Optional[int] = None,
        blocks_per_out: int = 1, device=None,
    ) -> "DeviceWell":
        """Device conversion, as ``spmv_tpu``'s ``DeviceWell.from_host``:
        the same automatic switch to segmented mode, the same spill, step
        padding and arrays.

        ``segment_rows``: when set, each output block reads x through a
        segment of that many 128-wide rows, starting at the block's
        lowest window (on the TPU a sliding VMEM segment; here an offset
        added to the column); slots whose windows do not fit move to the
        CSR spill.
        """
        dtype = dtype or default_value_dtype()
        _check_value_dtype(dtype, "DeviceWell")
        if segment_rows is None:
            # the TPU's whole-x mode kept x resident in VMEM: the JAX
            # container switches to segments when it cannot fit, and the
            # port switches alike so that both hold the same arrays
            x_bytes = (-(-m.num_columns // LANE) + m.window_rows + 1) \
                * LANE * dtype.itemsize
            if x_bytes > 8 * 1024 * 1024:
                # large-x defaults: wider segments + folded output
                # blocks amortize the per-grid-step overhead
                segment_rows = 4096
                if blocks_per_out == 1 and chunks_per_step == 8:
                    blocks_per_out = 4
                    chunks_per_step = 32

        k = max(int(chunks_per_step), 1)
        b_out = max(int(blocks_per_out), 1)
        grp = np.asarray(m.group_of_chunk)
        ws_full = np.asarray(m.window_start).copy()   # (chunks, 8)
        value_full = np.asarray(m.value).copy()
        loc_full = np.asarray(m.local_index)

        sp_r, sp_c, sp_v = [], [], []
        seg_id = None
        if segment_rows is not None:
            seg = int(segment_rows)
            active = (value_full != 0).any(axis=2) | (
                loc_full != 0
            ).any(axis=2)                              # (chunks, 8)
            ws_act = np.where(
                active, ws_full, np.iinfo(np.int32).max
            )
            smin = ws_act.min(axis=1)
            has = active.any(axis=1)
            smin = np.where(has, smin, 0)
            smax = np.where(
                active, ws_full, np.iinfo(np.int32).min
            ).max(axis=1)
            smax = np.where(has, smax, 0)
            # One segment per 8-group OUTPUT BLOCK (so runs never
            # fragment and chunks_per_step stays effective), starting
            # at the block's minimum window row — segment starts need
            # no alignment, so any block whose windows span at most
            # seg rows fits entirely.
            blocks_of = np.asarray(m.group_of_chunk) // (
                SUBLANE * b_out
            )
            nblk = int(blocks_of.max()) + 1 if blocks_of.size else 1
            blk_min = np.full(nblk, np.iinfo(np.int64).max)
            np.minimum.at(
                blk_min, blocks_of,
                np.where(has, smin, np.iinfo(np.int64).max),
            )
            # blocks whose chunks are all inert never updated blk_min
            blk_min = np.where(
                blk_min == np.iinfo(np.int64).max, 0, blk_min
            )
            # Quantizing starts to a half-segment grid lets adjacent
            # blocks share a segment.  The lowered start costs up to
            # qs-1 rows of the window, so the guarantee is: spans <=
            # seg/2 always fit; wider spans may spill some slots to the
            # CSR path.
            qs = max(seg // 2, 1)
            seg_start = (blk_min[blocks_of] // qs) * qs
            seg_start = np.where(has, seg_start, 0)
            # slots whose window still escapes spill INDIVIDUALLY
            lo_ok = ws_full >= seg_start[:, None]
            hi_ok = ws_full <= (seg_start + seg)[:, None]
            bad = active & ~(lo_ok & hi_ok)
            for c in np.nonzero(bad.any(axis=1))[0]:
                for sl in np.nonzero(bad[c])[0]:
                    ln = np.nonzero(value_full[c, sl] != 0)[0]
                    sp_r.extend((grp[c] * LANE + ln).tolist())
                    sp_c.extend(
                        (int(ws_full[c, sl]) * LANE
                         + loc_full[c, sl, ln]).tolist()
                    )
                    sp_v.extend(value_full[c, sl, ln].tolist())
                    value_full[c, sl] = 0.0
            ws_full = np.where(
                active & ~bad,
                ws_full - seg_start[:, None],
                0,
            ).astype(np.int32)
            ws_full = np.maximum(ws_full, 0)
            seg_id = seg_start

        spill = None
        spill_host = m.spill
        if sp_r:
            rr, cc, vv = list(sp_r), list(sp_c), list(sp_v)
            if spill_host is not None:
                old_rows = np.repeat(
                    np.arange(spill_host.num_rows, dtype=np.int64),
                    np.diff(spill_host.row_ptr),
                )
                rr.extend(old_rows.tolist())
                cc.extend(
                    np.asarray(spill_host.column_index).tolist()
                )
                vv.extend(np.asarray(spill_host.value).tolist())
            order = np.lexsort((cc, rr))
            r = np.asarray(rr, dtype=np.int64)[order]
            c = np.asarray(cc, dtype=np.int64)[order]
            v = np.asarray(vv, dtype=np.float64)[order]
            lengths = np.bincount(r, minlength=m.num_rows)
            ptr = np.zeros(m.num_rows + 1, dtype=np.int64)
            np.cumsum(lengths, out=ptr[1:])
            spill_host = CsrMatrix(
                m.num_rows, m.num_columns, int(r.size), 1,
                ptr, c.astype(np.int32), v,
            )
        if spill_host is not None:
            spill = DeviceCsr.from_host(spill_host, dtype=dtype,
                                        device=device)

        # Pad each chunk run to a multiple of K with inert chunks so
        # one grid step never spans two output blocks, and (segmented
        # mode) never spans two x segments.
        blocks = grp // (SUBLANE * b_out)
        run_key = (
            blocks.astype(np.int64) if seg_id is None
            else blocks.astype(np.int64) * (int(seg_id.max()) + 2)
            + seg_id
        )  # seg_id holds per-chunk segment START rows in segmented mode
        val_parts, loc_parts, ws_parts, grp_parts = [], [], [], []
        blk_steps, seg_steps = [], []
        # run_key has block as the high digit: sorting by it keeps
        # blocks contiguous AND groups same-segment chunks within one
        idx = np.argsort(run_key, kind="stable")
        i = 0
        while i < idx.size:
            j = i
            while j < idx.size and run_key[idx[j]] == run_key[idx[i]]:
                j += 1
            sel = idx[i:j]
            c = sel.size
            pad = (-c) % k
            val_parts.append(value_full[sel])
            loc_parts.append(loc_full[sel])
            ws_parts.append(ws_full[sel])
            grp_parts.append(grp[sel])
            if pad:
                val_parts.append(np.zeros(
                    (pad,) + value_full.shape[1:], value_full.dtype
                ))
                loc_parts.append(np.zeros(
                    (pad,) + loc_full.shape[1:], np.int32
                ))
                ws_parts.append(np.zeros((pad, SUBLANE), np.int32))
                # Inert pad chunks carry the run's LAST real group so the
                # flattened group_of_chunk stays non-decreasing (whole-x
                # packing), as in the JAX container.
                grp_parts.append(np.full(
                    pad, int(grp[sel[-1]]), dtype=np.int32,
                ))
            nsteps = (c + pad) // k
            blk_steps.extend([int(blocks[sel[0]])] * nsteps)
            if seg_id is not None:
                seg_steps.extend([int(seg_id[sel[0]])] * nsteps)
            i = j

        value = np.concatenate(val_parts)
        local_index = np.concatenate(loc_parts)
        window_start = np.concatenate(ws_parts)        # (chunks, 8)
        group_of_chunk = np.concatenate(grp_parts)     # (chunks,)
        steps = value.shape[0] // k
        # step-major staging layout: [step, slot, chunk-in-step]
        window_start = np.ascontiguousarray(
            window_start.reshape(steps, k, SUBLANE).transpose(0, 2, 1)
        ).astype(np.int32)
        group_of_chunk = group_of_chunk.reshape(steps, 1, k)

        return cls(
            m.num_rows, m.num_columns, m.num_entries, m.window_rows,
            m.num_groups, k, b_out, segment_rows, value, local_index,
            window_start, group_of_chunk,
            np.asarray(blk_steps, dtype=np.int32),
            None if seg_id is None else np.asarray(seg_steps, np.int32),
            spill, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x (the plain version on the CPU, kernel K5a or K5b,
        the spill folded in, on CUDA)."""
        from spmv_tpu_torch.ops.dispatch import spmv

        return spmv(self, x)


class DeviceBsr(torch.nn.Module):
    """BSR on a device: dense (block_rows, 128) blocks (kernels K7a/K7b);
    see ``spmv_tpu_torch.models.bsr`` for the format.

    Buffers, as in the JAX container:

    - ``blocks`` (num_blocks, block_rows, 128) in float32, float64 or
      bfloat16: each block row's run padded with zero blocks to a
      multiple of ``blocks_per_step`` (1 on the port's own paths, which
      store the host's blocks and nothing else: ``BsrKernel``);
    - ``block_col`` (num_blocks,) int32, the block column of each block;
    - ``block_row`` (num_blocks // blocks_per_step,) int32, the block row
      of each step (non-decreasing); and
    - ``row_ptr`` (num_block_rows + 1,) int32: block row r's blocks are
      ``[row_ptr[r], row_ptr[r + 1])``, so one CUDA block per block row
      finds its run without the TPU's in-order grid.

    Metadata: ``num_rows``, ``num_columns``, ``num_entries``,
    ``num_blocks``, ``num_block_rows``, ``num_block_cols``,
    ``blocks_per_step`` and ``block_rows``.  Unlike WELL-CW and WELL it
    takes bfloat16 storage: the product accumulates in float32 and
    returns float32, as ``bsr_spmm`` does.
    """

    format_name = "bsr"

    def __init__(self, num_rows, num_columns, num_entries, num_block_rows,
                 blocks_per_step, blocks: torch.Tensor, block_col,
                 block_row, device=None):
        super().__init__()
        if blocks.dtype not in (torch.float32, torch.float64,
                                torch.bfloat16):
            raise MatrixError(
                "DeviceBsr takes float32, float64 or bfloat16 blocks; got "
                f"{str(blocks.dtype).replace('torch.', '')}.")
        self.num_rows = int(num_rows)
        self.num_columns = int(num_columns)
        self.num_entries = int(num_entries)
        self.num_blocks = int(blocks.shape[0])
        self.num_block_rows = int(num_block_rows)
        self.num_block_cols = -(-self.num_columns // BLOCK)
        self.blocks_per_step = int(blocks_per_step)
        self.block_rows = int(blocks.shape[1])
        step_row = np.asarray(block_row).reshape(-1)
        if (np.diff(step_row) < 0).any():
            raise MatrixError("DeviceBsr: block_row must be non-decreasing")
        ptr = np.searchsorted(step_row, np.arange(self.num_block_rows + 1)) \
            * self.blocks_per_step
        self.register_buffer("blocks", blocks.to(device).contiguous())
        for name, a in (("block_col", block_col), ("block_row", step_row),
                        ("row_ptr", ptr)):
            self.register_buffer(
                name, _tensor(np.asarray(a).astype(np.int32), device))

    @classmethod
    def from_host(cls, m: BsrMatrix, dtype: Optional[torch.dtype] = None,
                  blocks_per_step: int = 8, device=None) -> "DeviceBsr":
        """Device conversion, as ``spmv_tpu``'s ``DeviceBsr.from_host``:
        each block row's run padded with zero blocks to a multiple of
        ``blocks_per_step``, and the same arrays."""
        dtype = dtype or default_value_dtype()
        kb = max(int(blocks_per_step), 1)

        bh = int(getattr(m, "block_rows", BLOCK))
        counts = np.diff(m.block_rowptr)
        pads = (-counts) % kb
        nb_padded = int((counts + pads).sum())
        blocks = np.zeros((nb_padded, bh, BLOCK), m.blocks.dtype)
        bcol = np.zeros(nb_padded, dtype=np.int32)
        step_row = []
        pos = 0
        for br in range(m.num_block_rows):
            s, e = int(m.block_rowptr[br]), int(m.block_rowptr[br + 1])
            c = e - s
            blocks[pos:pos + c] = m.blocks[s:e]
            bcol[pos:pos + c] = m.block_col[s:e]
            total = c + int(pads[br])
            step_row.extend([br] * (total // kb))
            pos += total

        return cls(m.num_rows, m.num_columns, m.num_entries,
                   m.num_block_rows, kb,
                   torch.from_numpy(blocks).to(device=device, dtype=dtype),
                   bcol, np.asarray(step_row, dtype=np.int32), device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x (the plain version on the CPU, kernel K7 on CUDA)."""
        from spmv_tpu_torch.ops.dispatch import spmv

        return spmv(self, x)


def device_put_matrix(m, dtype: Optional[torch.dtype] = None, device=None,
                      **kw):
    """Convert any host format to its device counterpart (``spmv_tpu``'s
    ``device_put_matrix``): COO to a ``DeviceCsr`` sorted by row."""
    for host, dev in ((CsrMatrix, DeviceCsr.from_host),
                      (CooMatrix, DeviceCsr.from_coo_host),
                      (EllMatrix, DeviceEll.from_host),
                      (HybridMatrix, DeviceHybrid.from_host),
                      (DiaMatrix, DeviceDia.from_host),
                      (WellMatrix, DeviceWell.from_host),
                      (WellCwMatrix, DeviceWellCw.from_host),
                      (BsrMatrix, DeviceBsr.from_host)):
        if isinstance(m, host):
            return dev(m, dtype=dtype, device=device, **kw)
    raise TypeError(f"unsupported host matrix type: {type(m)!r}")

"""Memory reference string generators (vectorized).

Each generator reproduces, reference-for-reference, the address trace
the corresponding reference kernel emits for one thread:

- triad:      3 refs/element: b[k], c[k], a[k]
              (src/kernels/triad.cpp:57-80)
- csr:        1 + per row (row_ptr[i+1]; per nnz: col[k], val[k], x[j];
              y[i]) = 3*nnz + 2*rows + 1  (csr-matrix.cpp:97-143)
- ell:        per row (per slot: col[k], val[k], x[j]; y[i])
              = 3*rows*L + rows  (ell-matrix.cpp:102-143)
- coo:        5 refs/entry (row[k], col[k], val[k], x[j],
              workspace[thread*rows+i]) over an equal-nnz split, then a
              reduction phase of 2 refs per (row, thread):
              workspace[j*rows+i], y[i]  (coo-matrix.cpp:81-141)
- coo-atomic: 5 refs/entry (row, col, val, x[j], y[i]) with y
              attributed to the owner of y[i]  (coo-matrix.cpp:143-185)
- hybrid:     ELL-part string followed by COO-part string
              (hybrid-matrix.cpp:231-249)

Every generator is a pure numpy function over a VirtualLayout — no
device, no host arrays; x-references (and coo-atomic's y-references)
carry the NUMA domain of the owning thread's pages via the
page-ownership model, all others the issuing thread's domain
(SURVEY.md section 5, "Tracing").

A reference string is a pair of equal-length arrays
``(addresses: uint64, numa_domains: int32)``.

The port's copy of ``spmv_tpu/perfmodel/refstring.py``: the same code,
importing the port's copies instead of the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from spmv_tpu_torch.models.coo import CooMatrix
from spmv_tpu_torch.models.csr import CsrMatrix
from spmv_tpu_torch.models.ell import EllMatrix, ELL_PAD_SENTINEL
from spmv_tpu_torch.models.dia import DiaMatrix
from spmv_tpu_torch.models.hybrid import HybridMatrix
from spmv_tpu_torch.perfmodel.layout import (
    PAGE_SIZE_DEFAULT,
    VirtualLayout,
    thread_of_index,
)

__all__ = [
    "RefString",
    "triad_refstring",
    "csr_spmv_refstring",
    "ell_spmv_refstring",
    "coo_spmv_refstring",
    "coo_atomic_spmv_refstring",
    "hybrid_spmv_refstring",
    "dia_spmv_refstring",
    "well_spmv_refstring",
    "wellcw_spmv_refstring",
]

RefString = Tuple[np.ndarray, np.ndarray]

IDX = 4   # bytes per int32 index
VAL = 8   # bytes per float64 value


def _equal_block(n: int, num_threads: int, thread: int) -> Tuple[int, int]:
    """ceil-block [start, end) like the reference partitions."""
    per = -(-n // num_threads) if n else 0
    return min(n, thread * per), min(n, (thread + 1) * per)


def triad_refstring(
    num_elements: int,
    layout: VirtualLayout,
    thread: int,
    num_threads: int,
    numa_domains: np.ndarray,
    page_size: int = PAGE_SIZE_DEFAULT,
) -> RefString:
    """Requires arrays 'a', 'b', 'c' of float64 in the layout."""
    a, b, c = layout["a"], layout["b"], layout["c"]
    lo, hi = _equal_block(num_elements, num_threads, thread)
    k = np.arange(lo, hi, dtype=np.int64)
    addrs = np.empty(3 * k.size, dtype=np.uint64)
    addrs[0::3] = b.addresses(k)
    addrs[1::3] = c.addresses(k)
    addrs[2::3] = a.addresses(k)
    numas = np.full(addrs.size, numa_domains[thread], dtype=np.int32)
    return addrs, numas


def csr_spmv_refstring(
    m: CsrMatrix,
    layout: VirtualLayout,
    thread: int,
    num_threads: int,
    numa_domains: np.ndarray,
    page_size: int = PAGE_SIZE_DEFAULT,
) -> RefString:
    """Requires arrays 'row_ptr' (int32/8?), 'column_index' (int32),
    'value' (f64), 'x' (f64), 'y' (f64) in the layout.

    Layout of the string (csr-matrix.cpp:108-141): row_ptr[start_row],
    then for each row i: row_ptr[i+1], (col[k], val[k], x[col[k]]) per
    stored entry, y[i].
    """
    row_ptr_a = layout["row_ptr"]
    col_a = layout["column_index"]
    val_a = layout["value"]
    x_a = layout["x"]
    y_a = layout["y"]

    lo_row, hi_row = _equal_block(m.num_rows, num_threads, thread)
    rows = hi_row - lo_row
    lo_nz, hi_nz = int(m.row_ptr[lo_row]), int(m.row_ptr[hi_row])
    nnz = hi_nz - lo_nz

    lengths = np.diff(m.row_ptr[lo_row:hi_row + 1]).astype(np.int64)
    total = 3 * nnz + 2 * rows + 1
    addrs = np.empty(total, dtype=np.uint64)
    numas = np.full(total, numa_domains[thread], dtype=np.int32)

    addrs[0] = row_ptr_a.addresses(lo_row)
    if rows == 0:
        # an empty ceil-block partition (trailing threads when
        # num_threads > rows) still reads row_ptr[start_row] — the
        # reference emits exactly that one reference
        # (csr-matrix.cpp:108)
        return addrs, numas

    # Row block base positions: after the initial ref, each row block
    # occupies 2 + 3*len slots.
    row_base = 1 + np.concatenate(
        ([0], np.cumsum(2 + 3 * lengths)[:-1])
    )
    addrs[row_base] = row_ptr_a.addresses(
        np.arange(lo_row + 1, hi_row + 1, dtype=np.int64)
    )
    y_pos = row_base + 1 + 3 * lengths
    addrs[y_pos] = y_a.addresses(np.arange(lo_row, hi_row, dtype=np.int64))

    if nnz:
        k = np.arange(lo_nz, hi_nz, dtype=np.int64)
        local_off = k - np.repeat(
            m.row_ptr[lo_row:hi_row].astype(np.int64), lengths
        )
        entry_pos = np.repeat(row_base, lengths) + 1 + 3 * local_off
        cols = m.column_index[lo_nz:hi_nz].astype(np.int64)
        addrs[entry_pos] = col_a.addresses(k)
        addrs[entry_pos + 1] = val_a.addresses(k)
        addrs[entry_pos + 2] = x_a.addresses(cols)
        numas[entry_pos + 2] = numa_domains[
            thread_of_index(x_a, cols, num_threads, page_size)
        ]
    return addrs, numas


def ell_spmv_refstring(
    m: EllMatrix,
    layout: VirtualLayout,
    thread: int,
    num_threads: int,
    numa_domains: np.ndarray,
    page_size: int = PAGE_SIZE_DEFAULT,
) -> RefString:
    """Requires 'column_index' (int32), 'value' (f64), 'x', 'y'.

    All L slots of each row are referenced, including padding
    (ell-matrix.cpp:123-135) — padded slots read x[pad_col], which is
    the point of the repeat-last-column padding.  Sentinel slots
    (skip_padding) are *not* referenced, matching the skip-padding
    kernel's early exit (ell-matrix.cpp:275-307).
    """
    col_a = layout["column_index"]
    val_a = layout["value"]
    x_a = layout["x"]
    y_a = layout["y"]
    L = m.row_length

    lo_row, hi_row = _equal_block(m.num_rows, num_threads, thread)
    rows = hi_row - lo_row

    cols2d = m.column_index[lo_row:hi_row]  # (rows, L)
    if m.skip_padding:
        keep = cols2d != ELL_PAD_SENTINEL
    else:
        keep = np.ones_like(cols2d, dtype=bool)
    lengths = keep.sum(axis=1).astype(np.int64)
    nnz = int(lengths.sum())

    total = 3 * nnz + rows
    addrs = np.empty(total, dtype=np.uint64)
    numas = np.full(total, numa_domains[thread], dtype=np.int32)

    row_base = np.concatenate(([0], np.cumsum(3 * lengths + 1)[:-1]))
    y_pos = row_base + 3 * lengths
    addrs[y_pos] = y_a.addresses(np.arange(lo_row, hi_row, dtype=np.int64))

    if nnz:
        r, s = np.nonzero(keep)  # row-major order == slot order
        k = (lo_row + r).astype(np.int64) * L + s  # flat slot index
        local_off = (
            np.arange(nnz, dtype=np.int64)
            - np.repeat(np.concatenate(([0], np.cumsum(lengths)[:-1])),
                        lengths)
        )
        entry_pos = np.repeat(row_base, lengths) + 3 * local_off
        cols = cols2d[r, s].astype(np.int64)
        addrs[entry_pos] = col_a.addresses(k)
        addrs[entry_pos + 1] = val_a.addresses(k)
        addrs[entry_pos + 2] = x_a.addresses(cols)
        numas[entry_pos + 2] = numa_domains[
            thread_of_index(x_a, cols, num_threads, page_size)
        ]
    return addrs, numas


def coo_spmv_refstring(
    m: CooMatrix,
    layout: VirtualLayout,
    thread: int,
    num_threads: int,
    numa_domains: np.ndarray,
    page_size: int = PAGE_SIZE_DEFAULT,
) -> RefString:
    """Workspace-variant COO (coo-matrix.cpp:81-141).

    Requires 'row_index', 'column_index' (int32), 'value', 'x', 'y',
    'workspace' (f64, num_threads*rows elements).
    Phase 1: equal-nnz split, 5 refs/entry.  Phase 2: for each owned
    row i and each thread j: workspace[j*rows+i] (attributed to the
    workspace page owner), y[i].
    """
    row_a = layout["row_index"]
    col_a = layout["column_index"]
    val_a = layout["value"]
    x_a = layout["x"]
    y_a = layout["y"]
    w_a = layout["workspace"]

    lo, hi = _equal_block(m.num_entries, num_threads, thread)
    k = np.arange(lo, hi, dtype=np.int64)
    nnz = k.size

    lo_row, hi_row = _equal_block(m.num_rows, num_threads, thread)
    rows = hi_row - lo_row

    total = 5 * nnz + 2 * rows * num_threads
    addrs = np.empty(total, dtype=np.uint64)
    numas = np.full(total, numa_domains[thread], dtype=np.int32)

    if nnz:
        i = m.row_index[lo:hi].astype(np.int64)
        j = m.column_index[lo:hi].astype(np.int64)
        addrs[0:5 * nnz:5] = row_a.addresses(k)
        addrs[1:5 * nnz:5] = col_a.addresses(k)
        addrs[2:5 * nnz:5] = val_a.addresses(k)
        addrs[3:5 * nnz:5] = x_a.addresses(j)
        numas[3:5 * nnz:5] = numa_domains[
            thread_of_index(x_a, j, num_threads, page_size)
        ]
        addrs[4:5 * nnz:5] = w_a.addresses(thread * m.num_rows + i)

    if rows:
        i = np.arange(lo_row, hi_row, dtype=np.int64)
        # (row, thread) pairs in the loop order i outer, j inner
        # (coo-matrix.cpp:128-139).
        jj = np.tile(np.arange(num_threads, dtype=np.int64), rows)
        ii = np.repeat(i, num_threads)
        widx = jj * m.num_rows + ii
        base = 5 * nnz
        addrs[base::2] = w_a.addresses(widx)
        # Reference-exact attribution (coo-matrix.cpp:128-136, same in
        # hybrid-matrix.cpp:215-224): ownership is computed over a
        # FICTIONAL workspace of num_threads*thread_num_rows elements
        # — not the real num_threads*rows — with indices past its end
        # clamped to its last page.  Verified bit-for-bit against the
        # reference binary (tests/test_reference_diff.py).
        numas[base::2] = numa_domains[
            _fictional_thread_of_index(
                num_threads * rows, w_a.itemsize, widx, num_threads,
                page_size,
            )
        ]
        addrs[base + 1::2] = y_a.addresses(ii)
    return addrs, numas


def _fictional_thread_of_index(
    num_elements: int,
    itemsize: int,
    indices,
    num_threads: int,
    page_size: int,
) -> np.ndarray:
    """aligned-allocator.hpp:156-211 over an array *claimed* to have
    ``num_elements`` elements (page-aligned base): page_of_index clamps
    out-of-range indices to the claimed last page; thread_of_page
    returns the first thread whose equal-block byte range contains the
    page start, falling back to the last thread."""
    idx = np.asarray(indices, dtype=np.int64)
    total_bytes = num_elements * itemsize
    npages = max(-(-total_bytes // page_size), 1)
    pages = np.minimum((idx * itemsize) // page_size, npages - 1)
    per = -(-num_elements // num_threads) if num_elements else 0
    starts = np.minimum(
        np.arange(num_threads + 1, dtype=np.int64) * per, num_elements
    ) * itemsize
    owner = np.searchsorted(starts[1:-1], pages * page_size,
                            side="right")
    return np.clip(owner, 0, num_threads - 1).astype(np.int32)


def coo_atomic_spmv_refstring(
    m: CooMatrix,
    layout: VirtualLayout,
    thread: int,
    num_threads: int,
    numa_domains: np.ndarray,
    page_size: int = PAGE_SIZE_DEFAULT,
) -> RefString:
    """Atomic-variant COO (coo-matrix.cpp:143-185): 5 refs/entry, y
    attributed to its page owner."""
    row_a = layout["row_index"]
    col_a = layout["column_index"]
    val_a = layout["value"]
    x_a = layout["x"]
    y_a = layout["y"]

    lo, hi = _equal_block(m.num_entries, num_threads, thread)
    k = np.arange(lo, hi, dtype=np.int64)
    nnz = k.size
    addrs = np.empty(5 * nnz, dtype=np.uint64)
    numas = np.full(5 * nnz, numa_domains[thread], dtype=np.int32)
    if nnz:
        i = m.row_index[lo:hi].astype(np.int64)
        j = m.column_index[lo:hi].astype(np.int64)
        addrs[0::5] = row_a.addresses(k)
        addrs[1::5] = col_a.addresses(k)
        addrs[2::5] = val_a.addresses(k)
        addrs[3::5] = x_a.addresses(j)
        numas[3::5] = numa_domains[
            thread_of_index(x_a, j, num_threads, page_size)
        ]
        addrs[4::5] = y_a.addresses(i)
        numas[4::5] = numa_domains[
            thread_of_index(y_a, i, num_threads, page_size)
        ]
    return addrs, numas


def hybrid_spmv_refstring(
    m: HybridMatrix,
    layout: VirtualLayout,
    thread: int,
    num_threads: int,
    numa_domains: np.ndarray,
    page_size: int = PAGE_SIZE_DEFAULT,
) -> RefString:
    """ELL-part string then COO-part string (hybrid-matrix.cpp:231-249).

    Requires 'ell_column_index', 'ell_value', 'coo_row_index',
    'coo_column_index', 'coo_value', 'x', 'y', 'workspace'.
    """
    ell = EllMatrix(
        m.num_rows, m.num_columns, m.num_ell_entries,
        m.ell_row_length, m.ell_column_index, m.ell_value,
        m.ell_skip_padding,
    )
    # Present the hybrid sub-arrays under the generic names the
    # per-format generators expect.
    ell_layout = _AliasLayout(layout, {
        "column_index": "ell_column_index",
        "value": "ell_value",
    })
    coo = CooMatrix(
        m.num_rows, m.num_columns, m.num_coo_entries,
        m.coo_row_index, m.coo_column_index, m.coo_value,
    )
    coo_layout = _AliasLayout(layout, {
        "row_index": "coo_row_index",
        "column_index": "coo_column_index",
        "value": "coo_value",
    })
    if m.ell_row_length > 0:
        a0, n0 = ell_spmv_refstring(
            ell, ell_layout, thread, num_threads, numa_domains, page_size
        )
    else:
        a0 = np.empty(0, np.uint64)
        n0 = np.empty(0, np.int32)
    a1, n1 = coo_spmv_refstring(
        coo, coo_layout, thread, num_threads, numa_domains, page_size
    )
    return np.concatenate([a0, a1]), np.concatenate([n0, n1])


class _AliasLayout:
    """View of a VirtualLayout with renamed arrays."""

    def __init__(self, layout: VirtualLayout, aliases: dict):
        self._layout = layout
        self._aliases = aliases
        self.page_size = layout.page_size

    def __getitem__(self, name: str):
        return self._layout[self._aliases.get(name, name)]


def dia_spmv_refstring(
    m: DiaMatrix,
    layout: VirtualLayout,
    thread: int,
    num_threads: int,
    numa_domains: np.ndarray,
    page_size: int = PAGE_SIZE_DEFAULT,
) -> RefString:
    """Reference string for the DIA kernel (TPU-native format; no
    reference counterpart — modeled after the CSR string's attribution
    rules, csr-matrix.cpp:97-143).

    Requires arrays 'data' (D*rows f64), 'x', 'y'.  Per row i of the
    thread's block, per diagonal k: data[k,i], then x[i+off_k] when in
    bounds; finally y[i].  x refs are attributed to the NUMA domain of
    the owning thread of that x element, others to the issuing thread.
    """
    data_a = layout["data"]
    x_a = layout["x"]
    y_a = layout["y"]

    lo, hi = _equal_block(m.num_rows, num_threads, thread)
    rows = hi - lo
    d = m.offsets.size
    if rows <= 0:
        e = np.empty(0)
        return e.astype(np.uint64), e.astype(np.int32)

    i = np.arange(lo, hi, dtype=np.int64)[:, None]      # (rows, 1)
    off = m.offsets.astype(np.int64)[None, :]           # (1, D)
    xcol = i + off                                      # (rows, D)
    valid = (xcol >= 0) & (xcol < m.num_columns)

    # Interleaved grid: per row, [data_0, x_0, data_1, x_1, ..., y].
    width = 2 * d + 1
    grid_addr = np.zeros((rows, width), dtype=np.uint64)
    grid_mask = np.zeros((rows, width), dtype=bool)
    grid_numa = np.full(
        (rows, width), numa_domains[thread], dtype=np.int32
    )

    k = np.arange(d, dtype=np.int64)[None, :]
    grid_addr[:, 0:2 * d:2] = data_a.addresses(k * m.num_rows + i)
    grid_mask[:, 0:2 * d:2] = True
    xc = np.clip(xcol, 0, max(m.num_columns - 1, 0))
    grid_addr[:, 1:2 * d:2] = x_a.addresses(xc)
    grid_mask[:, 1:2 * d:2] = valid
    grid_numa[:, 1:2 * d:2] = numa_domains[
        thread_of_index(x_a, xc, num_threads, page_size)
    ]
    grid_addr[:, -1] = y_a.addresses(i[:, 0])
    grid_mask[:, -1] = True

    flat = grid_mask.reshape(-1)
    return grid_addr.reshape(-1)[flat], grid_numa.reshape(-1)[flat]


def well_spmv_refstring(
    m,  # WellMatrix
    layout: VirtualLayout,
    thread: int,
    num_threads: int,
    numa_domains: np.ndarray,
    page_size: int = PAGE_SIZE_DEFAULT,
) -> RefString:
    """Reference string for the WELL kernel (TPU-native format; string
    layout modeled after the ELL generator, ell-matrix.cpp:102-143).

    Requires 'value' (chunks*8*128 f64), 'local_index' (same, int32),
    'window_start' (chunks*8 int32), 'x', 'y', and — when the matrix
    has a CSR spill — 'spill_row_ptr', 'spill_column_index',
    'spill_value'.

    The kernel's DMA sequence is deterministic per chunk: read the 8
    per-slot window starts, then slot-major over the (8, 128) tile read
    local_index / value and shuffle-gather x[ws[s]*128 + loc], then
    accumulate the 128 output lanes of the chunk's group.  Every slot
    lane is referenced (padding included) exactly as the vectorized
    kernel processes it — the same convention as ELL without
    skip_padding.  The CSR spill's string is appended, as the hybrid
    kernel appends its COO part (hybrid-matrix.cpp:231-249).

    Work is partitioned by equal chunk blocks (chunks are sorted by
    group, so this is the row-block partition in chunk units); the
    spill part uses the CSR generator's equal row blocks.
    """
    val_a = layout["value"]
    loc_a = layout["local_index"]
    ws_a = layout["window_start"]
    x_a = layout["x"]
    y_a = layout["y"]

    S, R = 8, 128  # slots per chunk, lanes per group
    lo_c, hi_c = _equal_block(m.num_chunks, num_threads, thread)
    chunks = hi_c - lo_c

    # Per chunk: 8 window starts + 3*1024 slot refs + 128 y refs.
    per_chunk = S + 3 * S * R + R
    addrs = np.empty(chunks * per_chunk, dtype=np.uint64)
    numas = np.full(addrs.size, numa_domains[thread], dtype=np.int32)

    if chunks:
        c = np.arange(lo_c, hi_c, dtype=np.int64)
        grid_a = addrs.reshape(chunks, per_chunk)
        grid_n = numas.reshape(chunks, per_chunk)

        # window_start[c, s]
        ws_idx = c[:, None] * S + np.arange(S, dtype=np.int64)
        grid_a[:, :S] = ws_a.addresses(ws_idx)

        # slot-major (s outer, r inner): local_index, value, x
        flat = (
            c[:, None] * (S * R)
            + np.arange(S * R, dtype=np.int64)[None, :]
        )                                             # (chunks, 1024)
        body = grid_a[:, S:S + 3 * S * R].reshape(chunks, S * R, 3)
        body[:, :, 0] = loc_a.addresses(flat)
        body[:, :, 1] = val_a.addresses(flat)
        ws = np.asarray(m.window_start, dtype=np.int64)[lo_c:hi_c]
        loc = np.asarray(m.local_index, dtype=np.int64)[lo_c:hi_c]
        xcol = (ws[:, :, None] * R + loc).reshape(chunks, S * R)
        xcol = np.clip(xcol, 0, max(m.num_columns - 1, 0))
        body[:, :, 2] = x_a.addresses(xcol)
        grid_n[:, S:S + 3 * S * R].reshape(chunks, S * R, 3)[:, :, 2] = (
            numa_domains[
                thread_of_index(x_a, xcol, num_threads, page_size)
            ]
        )

        # y[group*128 + r]
        grp = np.asarray(m.group_of_chunk, dtype=np.int64)[lo_c:hi_c]
        y_idx = grp[:, None] * R + np.arange(R, dtype=np.int64)
        y_idx = np.clip(y_idx, 0, max(m.num_rows - 1, 0))
        grid_a[:, -R:] = y_a.addresses(y_idx)

    if m.spill is not None:
        sp_layout = _AliasLayout(layout, {
            "row_ptr": "spill_row_ptr",
            "column_index": "spill_column_index",
            "value": "spill_value",
        })
        a1, n1 = csr_spmv_refstring(
            m.spill, sp_layout, thread, num_threads, numa_domains,
            page_size,
        )
        return np.concatenate([addrs, a1]), np.concatenate([numas, n1])
    return addrs, numas


def wellcw_spmv_refstring(
    m,  # WellCwMatrix
    layout: VirtualLayout,
    thread: int,
    num_threads: int,
    numa_domains: np.ndarray,
    page_size: int = PAGE_SIZE_DEFAULT,
) -> RefString:
    """Reference string for the WELL-CW kernel (chunk-window WELL,
    models.wellcw; string layout modeled after the ELL generator,
    ell-matrix.cpp:102-143, like the WELL generator above).

    Requires per-level arenas 'value{i}' (chunks*8*128 f64),
    'local_index{i}' (same, int32), 'anchor{i}' (chunks int32), plus
    'x', 'y', and — when the matrix has a remainder — the CSR arenas
    'rem_row_ptr', 'rem_column_index', 'rem_value'.

    Per chunk the kernel reads its anchor scalar, the (8, 128)
    local_index/value tiles slot-major, the gathered x cells
    (column = (anchor*d + w)*128 + lane offset), and accumulates the
    chunk's 128 output lanes.  Levels are concatenated; the remainder
    appends the CSR generator's string, as the hybrid kernel appends
    its COO part (hybrid-matrix.cpp:231-249).

    Work is partitioned by equal chunk blocks per level (chunks are
    group-sorted, so this is the row-block partition in chunk units).
    """
    x_a = layout["x"]
    y_a = layout["y"]
    S, R = 8, 128

    parts_a, parts_n = [], []
    for i, lv in enumerate(m.levels):
        val_a = layout[f"value{i}"]
        loc_a = layout[f"local_index{i}"]
        anc_a = layout[f"anchor{i}"]
        lo_c, hi_c = _equal_block(lv.num_chunks, num_threads, thread)
        chunks = hi_c - lo_c
        per_chunk = 1 + 3 * S * R + R
        addrs = np.empty(chunks * per_chunk, dtype=np.uint64)
        numas = np.full(addrs.size, numa_domains[thread],
                        dtype=np.int32)
        if chunks:
            c = np.arange(lo_c, hi_c, dtype=np.int64)
            grid_a = addrs.reshape(chunks, per_chunk)
            grid_n = numas.reshape(chunks, per_chunk)
            grid_a[:, 0] = anc_a.addresses(c)
            flat = (
                c[:, None] * (S * R)
                + np.arange(S * R, dtype=np.int64)[None, :]
            )
            body = grid_a[:, 1:1 + 3 * S * R].reshape(chunks, S * R, 3)
            body[:, :, 0] = loc_a.addresses(flat)
            body[:, :, 1] = val_a.addresses(flat)
            a4 = np.asarray(lv.anchor4, dtype=np.int64)[lo_c:hi_c]
            loc = np.asarray(
                lv.local_index, dtype=np.int64
            )[lo_c:hi_c].reshape(chunks, S * R)
            xcol = (a4[:, None] * lv.d + (loc >> 7)) * R + (
                loc & (R - 1)
            )
            xcol = np.clip(xcol, 0, max(m.num_columns - 1, 0))
            body[:, :, 2] = x_a.addresses(xcol)
            grid_n[:, 1:1 + 3 * S * R].reshape(
                chunks, S * R, 3
            )[:, :, 2] = numa_domains[
                thread_of_index(x_a, xcol, num_threads, page_size)
            ]
            grp = np.asarray(
                lv.group_of_chunk, dtype=np.int64
            )[lo_c:hi_c]
            y_idx = grp[:, None] * R + np.arange(R, dtype=np.int64)
            y_idx = np.clip(y_idx, 0, max(m.num_rows - 1, 0))
            grid_a[:, -R:] = y_a.addresses(y_idx)
        parts_a.append(addrs)
        parts_n.append(numas)

    for j, pv in enumerate(m._pools()):
        # pooled tail chunks (models.wellcw CwPoolLevel): one extra
        # rowmap read per cell, and y refs go to the rowmap's rows
        val_a = layout[f"pool{j}_value"]
        loc_a = layout[f"pool{j}_local_index"]
        anc_a = layout[f"pool{j}_anchor"]
        rm_a = layout[f"pool{j}_rowmap"]
        lo_c, hi_c = _equal_block(pv.num_chunks, num_threads, thread)
        chunks = hi_c - lo_c
        per_chunk = 1 + 5 * S * R
        addrs = np.empty(chunks * per_chunk, dtype=np.uint64)
        numas = np.full(addrs.size, numa_domains[thread],
                        dtype=np.int32)
        if chunks:
            c = np.arange(lo_c, hi_c, dtype=np.int64)
            grid_a = addrs.reshape(chunks, per_chunk)
            grid_n = numas.reshape(chunks, per_chunk)
            grid_a[:, 0] = anc_a.addresses(c)
            flat = (
                c[:, None] * (S * R)
                + np.arange(S * R, dtype=np.int64)[None, :]
            )
            body = grid_a[:, 1:1 + 4 * S * R].reshape(chunks, S * R, 4)
            body[:, :, 0] = loc_a.addresses(flat)
            body[:, :, 1] = rm_a.addresses(flat)
            body[:, :, 2] = val_a.addresses(flat)
            a4 = np.asarray(pv.anchor4, dtype=np.int64)[lo_c:hi_c]
            loc = np.asarray(
                pv.local_index, dtype=np.int64
            )[lo_c:hi_c].reshape(chunks, S * R)
            xcol = (a4[:, None] * pv.d + (loc >> 7)) * R + (
                loc & (R - 1)
            )
            xcol = np.clip(xcol, 0, max(m.num_columns - 1, 0))
            body[:, :, 3] = x_a.addresses(xcol)
            grid_n[:, 1:1 + 4 * S * R].reshape(
                chunks, S * R, 4
            )[:, :, 3] = numa_domains[
                thread_of_index(x_a, xcol, num_threads, page_size)
            ]
            rm = np.asarray(
                pv.rowmap, dtype=np.int64
            )[lo_c:hi_c].reshape(chunks, S * R)
            lane = np.arange(S * R, dtype=np.int64) % R
            y_idx = np.clip(rm * R + lane[None, :], 0,
                            max(m.num_rows - 1, 0))
            grid_a[:, 1 + 4 * S * R:] = y_a.addresses(y_idx)
        parts_a.append(addrs)
        parts_n.append(numas)

    if m.remainder is not None:
        rem_layout = _AliasLayout(layout, {
            "row_ptr": "rem_row_ptr",
            "column_index": "rem_column_index",
            "value": "rem_value",
        })
        a1, n1 = csr_spmv_refstring(
            m.remainder, rem_layout, thread, num_threads, numa_domains,
            page_size,
        )
        parts_a.append(a1)
        parts_n.append(n1)
    return np.concatenate(parts_a), np.concatenate(parts_n)


def bsr_spmv_refstring(
    m,
    layout: VirtualLayout,
    thread: int,
    num_threads: int,
    numa_domains: np.ndarray,
    page_size: int = PAGE_SIZE_DEFAULT,
) -> RefString:
    """Reference string for the BSR kernel (TPU-native block format;
    no reference counterpart — modeled after the CSR string's
    structure and attribution rules, csr-matrix.cpp:97-143, with the
    row loop lifted to block rows).

    Requires 'blocks' (NB*bh*128 f64), 'block_col' (int32),
    'block_rowptr' (int64), 'x' (padded to ncb*128 f64), 'y' (padded
    to nbr*bh f64).  Layout: block_rowptr[start], then per block row
    br: block_rowptr[br+1], per block (block_col, the bh*128 stored
    values, the 128-element x tile), then the bh y outputs.  x refs
    attribute to the owning thread's NUMA domain.
    """
    from spmv_tpu_torch.models.bsr import BLOCK

    blocks_a = layout["blocks"]
    bc_a = layout["block_col"]
    rp_a = layout["block_rowptr"]
    x_a = layout["x"]
    y_a = layout["y"]

    nbr = m.num_block_rows
    bh = int(m.block_rows)
    lo, hi = _equal_block(nbr, num_threads, thread)
    rows = hi - lo
    if rows <= 0:
        addrs = np.array([rp_a.addresses(lo)], dtype=np.uint64)
        return addrs, np.full(1, numa_domains[thread], dtype=np.int32)

    rp = np.asarray(m.block_rowptr, np.int64)
    lengths = np.diff(rp[lo:hi + 1])
    nb_t = int(lengths.sum())
    per_block = 1 + bh * BLOCK + BLOCK
    total = 1 + rows * (1 + bh) + nb_t * per_block
    addrs = np.empty(total, dtype=np.uint64)
    numas = np.full(total, numa_domains[thread], dtype=np.int32)

    addrs[0] = rp_a.addresses(lo)
    row_base = 1 + np.concatenate(
        ([0], np.cumsum(1 + bh + lengths * per_block)[:-1])
    )
    addrs[row_base] = rp_a.addresses(
        np.arange(lo + 1, hi + 1, dtype=np.int64))
    y_pos = row_base + 1 + lengths * per_block
    y_rows = (np.arange(lo, hi, dtype=np.int64)[:, None] * bh
              + np.arange(bh, dtype=np.int64)[None, :])
    addrs[(y_pos[:, None] + np.arange(bh)[None, :]).reshape(-1)] = \
        y_a.addresses(y_rows.reshape(-1))

    if nb_t:
        t = np.arange(rp[lo], rp[hi], dtype=np.int64)
        local_b = t - np.repeat(rp[lo:hi], lengths)
        pos = np.repeat(row_base, lengths) + 1 + local_b * per_block
        addrs[pos] = bc_a.addresses(t)
        # stored block values, element order
        val_idx = (t[:, None] * (bh * BLOCK)
                   + np.arange(bh * BLOCK, dtype=np.int64)[None, :])
        val_pos = pos[:, None] + 1 + np.arange(bh * BLOCK)[None, :]
        addrs[val_pos.reshape(-1)] = blocks_a.addresses(
            val_idx.reshape(-1))
        # the 128-wide x tile of the block column
        bcols = np.asarray(m.block_col, np.int64)[rp[lo]:rp[hi]]
        x_idx = (bcols[:, None] * BLOCK
                 + np.arange(BLOCK, dtype=np.int64)[None, :])
        x_pos = pos[:, None] + 1 + bh * BLOCK \
            + np.arange(BLOCK)[None, :]
        addrs[x_pos.reshape(-1)] = x_a.addresses(x_idx.reshape(-1))
        numas[x_pos.reshape(-1)] = numa_domains[
            thread_of_index(x_a, x_idx.reshape(-1), num_threads,
                            page_size)
        ]
    return addrs, numas

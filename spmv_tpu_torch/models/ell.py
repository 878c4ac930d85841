"""ELLPACK format.

Host-side counterpart of the reference's ell_matrix::Matrix
(src/matrix/ell-matrix.hpp:22-65): every row padded to
``row_length = max_row_length``; storage is 2-D ``(rows, row_length)``
column indices and values (the reference stores them flattened row-major,
which is the same memory layout).

Padding semantics (ell-matrix.cpp:190-238):

- default: a padding slot repeats the column index of the most recently
  stored entry (``column_indices[k-1]``), or 0 when no entry has been
  stored yet, with value 0.0 — so padded reads are in-bounds and
  contribute nothing;
- ``skip_padding=True``: padding slots get the sentinel ``INT32_MAX``
  and the SpMV breaks out of the row at the first sentinel
  (ell-matrix.cpp:275-307).

This 2-D regular layout is the TPU-native sweet spot: a dense
``(rows, L)`` gather + row-sum maps directly onto (8,128) vector tiles.

The port's copy of ``spmv_tpu/models/ell.py``: the same code, importing
the port's copies instead of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.io.matrix_market import MatrixMarket, INDEX_DTYPE, VALUE_DTYPE
from spmv_tpu_torch.models._convert import sorted_entries_0based

__all__ = ["EllMatrix", "ELL_PAD_SENTINEL"]

ELL_PAD_SENTINEL = np.iinfo(np.int32).max


def _ell_arrays(mm, row_length, skip_padding):
    """Build (rows, L) column-index and value arrays, reference padding."""
    rows, cols, vals, row_ptr = sorted_entries_0based(mm)
    m = mm.num_rows
    lengths = np.diff(row_ptr)
    if row_length < (lengths.max(initial=0)):
        raise MatrixError("row_length smaller than max row length")

    cols2d = np.zeros((m, row_length), dtype=INDEX_DTYPE)
    vals2d = np.zeros((m, row_length), dtype=VALUE_DTYPE)

    if skip_padding:
        cols2d[:] = ELL_PAD_SENTINEL
    else:
        # Reference padding repeats the most recently stored column index
        # (ell-matrix.cpp:226-233): for each row, that is its own last
        # entry's column; for an empty row, the last entry of the nearest
        # preceding nonempty row; 0 if there is none.
        last_col = np.zeros(m, dtype=INDEX_DTYPE)
        nonempty = lengths > 0
        if cols.size:
            last_col[nonempty] = cols[row_ptr[1:][nonempty] - 1]
            # forward-fill over empty rows
            idx = np.where(nonempty, np.arange(m), -1)
            np.maximum.accumulate(idx, out=idx)
            filled = idx >= 0
            last_col[filled] = last_col[idx[filled]]
            last_col[~filled] = 0
        cols2d[:] = last_col[:, None]

    if cols.size:
        offs = np.arange(cols.size, dtype=np.int64) - np.repeat(
            row_ptr[:-1], lengths
        )
        cols2d[rows, offs] = cols
        vals2d[rows, offs] = vals
    return cols2d, vals2d


@dataclasses.dataclass
class EllMatrix:
    num_rows: int
    num_columns: int
    num_entries: int           # real nonzeros, excluding padding
    row_length: int
    column_index: np.ndarray   # (rows, row_length) int32
    value: np.ndarray          # (rows, row_length) float64
    skip_padding: bool = False

    format_name = "ell"

    @classmethod
    def from_matrix_market(
        cls,
        mm: MatrixMarket,
        skip_padding: bool = False,
        row_length: int = None,
    ) -> "EllMatrix":
        L = mm.max_row_length() if row_length is None else row_length
        cols2d, vals2d = _ell_arrays(mm, L, skip_padding)
        return cls(
            mm.num_rows, mm.num_columns, mm.num_entries,
            L, cols2d, vals2d, skip_padding,
        )

    @property
    def num_padding_entries(self) -> int:
        # Reference: value.size() - num_entries (ell-matrix.cpp:67-80).
        return self.value.size - self.num_entries

    def memory_usage_bytes(self) -> int:
        return self.column_index.nbytes + self.value.nbytes

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """y = A @ x, numpy reference semantics (fp64 ground truth)."""
        x = np.asarray(x)
        if x.shape[0] != self.num_columns:
            raise MatrixError(
                f"dimension mismatch: matrix has {self.num_columns} "
                f"columns, x has {x.shape[0]}"
            )
        if self.skip_padding:
            mask = self.column_index != ELL_PAD_SENTINEL
            safe = np.where(mask, self.column_index, 0)
            contrib = np.where(mask, self.value * x[safe], 0.0)
            return contrib.sum(axis=1)
        return (self.value * x[self.column_index]).sum(axis=1)

    def to_dense(self) -> np.ndarray:
        d = np.zeros((self.num_rows, self.num_columns), dtype=VALUE_DTYPE)
        mask = (
            self.column_index != ELL_PAD_SENTINEL
            if self.skip_padding
            else np.ones_like(self.column_index, dtype=bool)
        )
        r, k = np.nonzero(mask)
        np.add.at(d, (r, self.column_index[r, k]), self.value[r, k])
        return d

"""Compressed Sparse Row (CSR) format.

Host-side counterpart of the reference's csr_matrix::Matrix
(src/matrix/csr-matrix.hpp:22-65): ``row_ptr`` (rows+1), column indices
and values sorted row-major, with optional per-row *alignment padding*:
each row's entry count is rounded up to a multiple of ``row_alignment``
and the padding entries get column index 0 and value 0.0
(from_matrix_market_row_aligned, csr-matrix.cpp:193-243).

``num_entries`` counts only the real (unpadded) nonzeros, as in the
reference; padded storage size is ``row_ptr[-1]``.

The port's copy of ``spmv_tpu/models/csr.py``: the same code, importing
the port's copies instead of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.io.matrix_market import MatrixMarket, INDEX_DTYPE, VALUE_DTYPE
from spmv_tpu_torch.models._convert import sorted_entries_0based

__all__ = ["CsrMatrix"]


@dataclasses.dataclass
class CsrMatrix:
    num_rows: int
    num_columns: int
    num_entries: int           # real nonzeros, excluding padding
    row_alignment: int
    row_ptr: np.ndarray        # (rows+1,) int64 offsets into padded arrays
    column_index: np.ndarray   # (row_ptr[-1],) int32, 0-based
    value: np.ndarray          # (row_ptr[-1],) float64

    format_name = "csr"

    @classmethod
    def from_matrix_market(
        cls, mm: MatrixMarket, row_alignment: int = 1
    ) -> "CsrMatrix":
        if row_alignment < 1:
            raise MatrixError("row_alignment must be >= 1")
        rows, cols, vals, row_ptr = sorted_entries_0based(mm)

        if row_alignment == 1:
            return cls(
                mm.num_rows, mm.num_columns, mm.num_entries,
                1, row_ptr, cols, vals,
            )

        lengths = np.diff(row_ptr)
        padded_lengths = (
            (lengths + row_alignment - 1) // row_alignment
        ) * row_alignment
        padded_ptr = np.zeros(mm.num_rows + 1, dtype=np.int64)
        np.cumsum(padded_lengths, out=padded_ptr[1:])

        total = int(padded_ptr[-1])
        # Padding entries: column index 0, value 0.0
        # (csr-matrix.cpp:232-236).
        pcols = np.zeros(total, dtype=INDEX_DTYPE)
        pvals = np.zeros(total, dtype=VALUE_DTYPE)
        # Destination index of each real entry: padded row start + offset
        # within its row.
        offs = np.arange(mm.num_entries, dtype=np.int64) - np.repeat(
            row_ptr[:-1], lengths
        )
        dest = np.repeat(padded_ptr[:-1], lengths) + offs
        pcols[dest] = cols
        pvals[dest] = vals
        return cls(
            mm.num_rows, mm.num_columns, mm.num_entries,
            row_alignment, padded_ptr, pcols, pvals,
        )

    @property
    def num_padding_entries(self) -> int:
        return int(self.row_ptr[-1]) - self.num_entries

    def memory_usage_bytes(self) -> int:
        return (
            self.row_ptr.nbytes
            + self.column_index.nbytes
            + self.value.nbytes
        )

    def row_ids(self) -> np.ndarray:
        """Expand row_ptr to a per-stored-entry row index (COO-style).

        Device kernels consume this instead of row_ptr: on TPU the
        segment-sum formulation wants explicit segment ids.
        """
        lengths = np.diff(self.row_ptr)
        return np.repeat(
            np.arange(self.num_rows, dtype=INDEX_DTYPE), lengths
        )

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """y = A @ x, numpy reference semantics (fp64 ground truth)."""
        x = np.asarray(x)
        if x.shape[0] != self.num_columns:
            raise MatrixError(
                f"dimension mismatch: matrix has {self.num_columns} "
                f"columns, x has {x.shape[0]}"
            )
        # Padding entries have value 0, so they contribute nothing.
        prod = self.value * x[self.column_index]
        y = np.zeros(self.num_rows, dtype=prod.dtype)
        np.add.at(y, self.row_ids(), prod)
        return y

    def to_dense(self) -> np.ndarray:
        d = np.zeros((self.num_rows, self.num_columns), dtype=VALUE_DTYPE)
        np.add.at(d, (self.row_ids(), self.column_index), self.value)
        return d

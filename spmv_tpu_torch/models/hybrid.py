"""Hybrid ELL + COO format.

Host-side counterpart of the reference's hybrid_matrix::Matrix
(src/matrix/hybrid-matrix.hpp:22-134).  Split semantics reproduce
hybrid-matrix.cpp:316-417:

- The ELL width is the "2/3 median" of the row-length histogram: the
  loop ``while num < (2*rows)/3: num += hist[L]; L += 1`` then ``L-1``
  (hybrid-matrix.cpp:337-344).
- Rows with fewer than ``ell_row_length`` entries go entirely to the ELL
  part (padded with the most recent column index, or the INT32_MAX
  sentinel under ``skip_padding``); rows with at least that many entries
  put their first ``ell_row_length`` entries in ELL and spill the rest to
  a row-major COO part (hybrid-matrix.cpp:378-410).

Note the reference's split is asymmetric at equality: a row with exactly
``ell_row_length`` entries takes the COO branch (which spills nothing),
identical in effect to the ELL branch.

The port's copy of ``spmv_tpu/models/hybrid.py``: the same code, importing
the port's copies instead of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.io.matrix_market import MatrixMarket, INDEX_DTYPE, VALUE_DTYPE
from spmv_tpu_torch.models._convert import sorted_entries_0based
from spmv_tpu_torch.models.ell import ELL_PAD_SENTINEL

__all__ = ["HybridMatrix", "two_thirds_median_row_length"]


def two_thirds_median_row_length(row_lengths: np.ndarray) -> int:
    """The reference's 2/3-median ELL width (hybrid-matrix.cpp:337-344)."""
    num_rows = len(row_lengths)
    if num_rows == 0:
        return 0
    max_len = int(np.max(row_lengths, initial=0))
    hist = np.bincount(row_lengths, minlength=max_len + 1)
    median = 0
    num_less = 0
    while num_less < (2 * num_rows) // 3:
        num_less += int(hist[median])
        median += 1
    return max(median - 1, 0)


@dataclasses.dataclass
class HybridMatrix:
    num_rows: int
    num_columns: int
    num_entries: int               # real nonzeros over both parts
    ell_row_length: int
    num_ell_entries: int           # real nonzeros stored in the ELL part
    ell_column_index: np.ndarray   # (rows, ell_row_length) int32
    ell_value: np.ndarray          # (rows, ell_row_length) float64
    ell_skip_padding: bool
    num_coo_entries: int
    coo_row_index: np.ndarray      # (num_coo_entries,) int32
    coo_column_index: np.ndarray   # (num_coo_entries,) int32
    coo_value: np.ndarray          # (num_coo_entries,) float64

    format_name = "hybrid"

    @classmethod
    def from_matrix_market(
        cls,
        mm: MatrixMarket,
        ell_skip_padding: bool = False,
        ell_row_length: int = None,
    ) -> "HybridMatrix":
        rows, cols, vals, row_ptr = sorted_entries_0based(mm)
        m = mm.num_rows
        lengths = np.diff(row_ptr)

        L = (
            two_thirds_median_row_length(lengths)
            if ell_row_length is None
            else ell_row_length
        )

        # Slot of each entry within its row.
        offs = np.arange(cols.size, dtype=np.int64) - np.repeat(
            row_ptr[:-1], lengths
        )
        to_ell = offs < L
        to_coo = ~to_ell

        ell_cols = np.zeros((m, max(L, 0)), dtype=INDEX_DTYPE)
        ell_vals = np.zeros((m, max(L, 0)), dtype=VALUE_DTYPE)
        if L > 0:
            if ell_skip_padding:
                ell_cols[:] = ELL_PAD_SENTINEL
            else:
                # Most-recent-column padding as in the reference
                # (hybrid-matrix.cpp:390-393): for a padded row, the last
                # of its own entries, else the nearest preceding row's
                # last stored entry, else 0.
                stored = np.minimum(lengths, L)
                last_k = row_ptr[:-1] + stored  # one past row's last stored
                nonempty = stored > 0
                last_col = np.zeros(m, dtype=INDEX_DTYPE)
                if cols.size:
                    last_col[nonempty] = cols[last_k[nonempty] - 1]
                    idx = np.where(nonempty, np.arange(m), -1)
                    np.maximum.accumulate(idx, out=idx)
                    filled = idx >= 0
                    last_col[filled] = last_col[idx[filled]]
                    last_col[~filled] = 0
                ell_cols[:] = last_col[:, None]
            ell_cols[rows[to_ell], offs[to_ell]] = cols[to_ell]
            ell_vals[rows[to_ell], offs[to_ell]] = vals[to_ell]

        return cls(
            num_rows=m,
            num_columns=mm.num_columns,
            num_entries=mm.num_entries,
            ell_row_length=L,
            num_ell_entries=int(to_ell.sum()),
            ell_column_index=ell_cols,
            ell_value=ell_vals,
            ell_skip_padding=ell_skip_padding,
            num_coo_entries=int(to_coo.sum()),
            coo_row_index=rows[to_coo].astype(INDEX_DTYPE),
            coo_column_index=cols[to_coo].astype(INDEX_DTYPE),
            coo_value=vals[to_coo].astype(VALUE_DTYPE),
        )

    @property
    def num_padding_entries(self) -> int:
        return self.ell_value.size - self.num_ell_entries

    def memory_usage_bytes(self) -> int:
        return (
            self.ell_column_index.nbytes
            + self.ell_value.nbytes
            + self.coo_row_index.nbytes
            + self.coo_column_index.nbytes
            + self.coo_value.nbytes
        )

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """y = A @ x: ELL pass + COO pass (hybrid-matrix.cpp:535-567)."""
        x = np.asarray(x)
        if x.shape[0] != self.num_columns:
            raise MatrixError(
                f"dimension mismatch: matrix has {self.num_columns} "
                f"columns, x has {x.shape[0]}"
            )
        if self.ell_row_length > 0:
            if self.ell_skip_padding:
                mask = self.ell_column_index != ELL_PAD_SENTINEL
                safe = np.where(mask, self.ell_column_index, 0)
                y = np.where(mask, self.ell_value * x[safe], 0.0).sum(axis=1)
            else:
                y = (self.ell_value * x[self.ell_column_index]).sum(axis=1)
        else:
            y = np.zeros(self.num_rows, dtype=np.result_type(x, VALUE_DTYPE))
        np.add.at(
            y,
            self.coo_row_index,
            self.coo_value * x[self.coo_column_index],
        )
        return y

    def to_dense(self) -> np.ndarray:
        d = np.zeros((self.num_rows, self.num_columns), dtype=VALUE_DTYPE)
        if self.ell_row_length > 0:
            mask = (
                self.ell_column_index != ELL_PAD_SENTINEL
                if self.ell_skip_padding
                else self.ell_value != 0.0
            )
            r, k = np.nonzero(mask)
            np.add.at(d, (r, self.ell_column_index[r, k]), self.ell_value[r, k])
        np.add.at(
            d, (self.coo_row_index, self.coo_column_index), self.coo_value
        )
        return d

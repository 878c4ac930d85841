"""Coordinate (COO) sparse matrix format.

Host-side counterpart of the reference's coo_matrix::Matrix
(src/matrix/coo-matrix.hpp:22-70): entry-list storage with int32 row and
column indices and float64 values.  Conversion from Matrix Market keeps
the file's entry order and converts 1-based to 0-based indices
(coo-matrix.cpp:220-243); it does NOT sort.

The reference has two parallel SpMV strategies (both reproduced on
device in spmv_tpu.ops):

- workspace: equal-nnz chunks per thread accumulate into per-thread
  workspaces, then a row-parallel reduction (coo-matrix.cpp:248-285);
- atomic scatter (coo-matrix.cpp:287-309), which has no TPU analogue and
  is re-expressed as a sort-by-row + segment-sum.

The numpy ``spmv`` here is the sequential reference semantics used as
ground truth in tests.

The port's copy of ``spmv_tpu/models/coo.py``: the same code, importing
the port's copies instead of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.io.matrix_market import MatrixMarket, INDEX_DTYPE, VALUE_DTYPE
from spmv_tpu_torch.models._convert import require_coordinate

__all__ = ["CooMatrix"]


@dataclasses.dataclass
class CooMatrix:
    num_rows: int
    num_columns: int
    num_entries: int
    row_index: np.ndarray      # (nnz,) int32, 0-based
    column_index: np.ndarray   # (nnz,) int32, 0-based
    value: np.ndarray          # (nnz,) float64

    format_name = "coo"

    @classmethod
    def from_matrix_market(cls, mm: MatrixMarket) -> "CooMatrix":
        require_coordinate(mm)
        return cls(
            num_rows=mm.num_rows,
            num_columns=mm.num_columns,
            num_entries=mm.num_entries,
            row_index=(mm.rows_1based - 1).astype(INDEX_DTYPE),
            column_index=(mm.cols_1based - 1).astype(INDEX_DTYPE),
            value=mm.values.astype(VALUE_DTYPE),
        )

    @property
    def num_padding_entries(self) -> int:
        return 0

    def memory_usage_bytes(self) -> int:
        """Bytes of matrix storage (indices + values)."""
        return (
            self.row_index.nbytes
            + self.column_index.nbytes
            + self.value.nbytes
        )

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """y = A @ x, numpy reference semantics (fp64 ground truth)."""
        x = np.asarray(x)
        if x.shape[0] != self.num_columns:
            raise MatrixError(
                f"dimension mismatch: matrix has {self.num_columns} "
                f"columns, x has {x.shape[0]}"
            )
        y = np.zeros(self.num_rows, dtype=np.result_type(self.value, x))
        np.add.at(y, self.row_index, self.value * x[self.column_index])
        return y

    def to_dense(self) -> np.ndarray:
        d = np.zeros((self.num_rows, self.num_columns), dtype=VALUE_DTYPE)
        np.add.at(d, (self.row_index, self.column_index), self.value)
        return d

"""Shared conversion helpers for format constructors.

The port's copy of ``spmv_tpu/models/_convert.py``: the same code,
importing the port's copies instead of the JAX package.
"""

from __future__ import annotations

import numpy as np

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.io.matrix_market import MatrixMarket, INDEX_DTYPE, VALUE_DTYPE

__all__ = ["sorted_entries_0based", "require_coordinate"]


def require_coordinate(mm: MatrixMarket) -> None:
    if mm.format != "coordinate":
        # Reference: "Expected matrix in coordinate format"
        # (csr-matrix.cpp:198, ell-matrix.cpp:195, coo-matrix.cpp:223).
        raise MatrixError("Expected matrix in coordinate format")


def sorted_entries_0based(mm: MatrixMarket):
    """Row-major sorted, 0-based (rows, cols, vals, row_ptr).

    ``row_ptr`` is the unpadded CSR row pointer (int64 cumulative
    lengths) used by all padded-format constructors.
    """
    require_coordinate(mm)
    from spmv_tpu_torch.models import _cw_native

    # native stable radix sort when available (lexsort is ~4 s at
    # 8.4M entries; the radix core is ~6x faster and bit-identical —
    # tests/test_cw_native.py); lexsort otherwise
    if mm.rows_1based.size >= (1 << 20) and _cw_native.available():
        order = _cw_native.sort_perm(mm.rows_1based, mm.cols_1based)
    else:
        order = np.lexsort((mm.cols_1based, mm.rows_1based))
    rows = (mm.rows_1based[order] - 1).astype(INDEX_DTYPE)
    cols = (mm.cols_1based[order] - 1).astype(INDEX_DTYPE)
    vals = mm.values[order].astype(VALUE_DTYPE)
    lengths = np.bincount(rows, minlength=mm.num_rows)
    row_ptr = np.zeros(mm.num_rows + 1, dtype=np.int64)
    np.cumsum(lengths, out=row_ptr[1:])
    return rows, cols, vals, row_ptr

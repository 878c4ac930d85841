"""Row partitioners (the port's copy of ``spmv_tpu/models/partition.py``).

The same code, numpy only.

The reference's only partitioner is the static equal-rows block split
``rows_per_thread = ceil(rows / threads)`` (csr-matrix.cpp:77-95,
ell-matrix.cpp:82-100).  We reproduce it (``rows_partition_equal``) and
add the nnz-balanced partitioner the TPU build uses instead: contiguous
row blocks with (approximately) equal nonzero counts, computed from the
row pointer by binary search — the classic 1-D balanced chains-on-chains
split.

A partition over P workers is represented as ``bounds``: an int64 array
of P+1 row offsets with ``bounds[0]==0`` and ``bounds[P]==num_rows``;
worker p owns rows ``[bounds[p], bounds[p+1])``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "rows_partition_equal",
    "rows_partition_balanced_nnz",
    "partition_bounds_to_sizes",
    "nnz_per_part",
]


def rows_partition_equal(num_rows: int, num_parts: int) -> np.ndarray:
    """Reference semantics: blocks of ceil(rows/parts), clipped.

    (csr-matrix.cpp:77-95: start = min(rows, p*ceil), end = min(rows,
    (p+1)*ceil) — trailing workers can own zero rows.)
    """
    if num_parts < 1:
        raise ValueError("num_parts must be >= 1")
    rows_per_part = -(-num_rows // num_parts) if num_rows else 0
    bounds = np.minimum(
        np.arange(num_parts + 1, dtype=np.int64) * rows_per_part, num_rows
    )
    bounds[-1] = num_rows
    return bounds

def rows_partition_balanced_nnz(
    row_ptr: np.ndarray, num_parts: int
) -> np.ndarray:
    """Contiguous row blocks with balanced nonzero counts.

    Splits at the rows where the cumulative nnz crosses k * nnz/P,
    k = 1..P-1 (binary search on row_ptr).  Guarantees monotone bounds;
    a worker may own zero rows only when there are more workers than
    rows.
    """
    if num_parts < 1:
        raise ValueError("num_parts must be >= 1")
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    num_rows = row_ptr.size - 1
    total = int(row_ptr[-1])
    targets = (np.arange(1, num_parts, dtype=np.int64) * total) // num_parts
    cuts = np.searchsorted(row_ptr[1:-1], targets, side="left").astype(
        np.int64
    )
    # searchsorted over row_ptr[1:-1] yields cut rows in [0, num_rows-1];
    # shift so each part is [bound, next_bound).
    bounds = np.empty(num_parts + 1, dtype=np.int64)
    bounds[0] = 0
    bounds[1:-1] = cuts + 1 if num_rows > 0 else 0
    bounds[-1] = num_rows
    np.maximum.accumulate(bounds, out=bounds)
    np.minimum(bounds, num_rows, out=bounds)
    return bounds


def partition_bounds_to_sizes(bounds: np.ndarray) -> np.ndarray:
    return np.diff(np.asarray(bounds, dtype=np.int64))


def nnz_per_part(row_ptr: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """Nonzeros owned by each part (csr spmv_nonzeros_per_thread analogue,
    csr-matrix.cpp:87-95)."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    b = np.asarray(bounds, dtype=np.int64)
    return row_ptr[b[1:]] - row_ptr[b[:-1]]

"""Matrix ingestion: Matrix Market files, gzip, SuiteSparse tarballs.

The port's copy of ``spmv_tpu/io/__init__.py``: the same code, importing
the port's copies instead of the JAX package.
"""

from spmv_tpu_torch.io.matrix_market import (
    MatrixMarket,
    parse_matrix_market,
    load_matrix,
    write_matrix_market,
)

__all__ = [
    "MatrixMarket",
    "parse_matrix_market",
    "load_matrix",
    "write_matrix_market",
]

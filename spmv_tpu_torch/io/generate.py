"""Synthetic matrix generators.

The reference ships the SuiteSparse FEMLAB/poisson2D matrix as an
embedded test fixture (test/poisson2D.hpp) and benchmarks on SuiteSparse
downloads.  This image has no network egress, so the framework generates
its own structurally equivalent inputs:

- ``poisson2d``: the 5-point finite-difference Laplacian on an
  nx-by-ny grid (the same matrix family as FEMLAB/poisson2D and the
  BASELINE "poisson2D 5-point stencil" configs),
- ``random_sparse``: uniformly random pattern with a target nnz/row,
- ``banded``: a diagonal band, the post-RCM shape,
- ``powerlaw``: skewed row lengths (stress for hybrid's 2/3-median
  split and nnz-balanced partitioning).

All return ``MatrixMarket`` objects so every downstream path (format
conversion, kernels, perf model) exercises the real ingestion types.

The port's copy of ``spmv_tpu/io/generate.py``: the same code, importing
the port's copies instead of the JAX package.
"""

from __future__ import annotations

import numpy as np

from spmv_tpu_torch.io.matrix_market import MatrixMarket, INDEX_DTYPE, VALUE_DTYPE

__all__ = ["poisson2d", "random_sparse", "banded", "powerlaw", "from_coo_arrays"]


def from_coo_arrays(
    num_rows: int,
    num_columns: int,
    rows0: np.ndarray,
    cols0: np.ndarray,
    values: np.ndarray,
    symmetry: str = "general",
) -> MatrixMarket:
    """Wrap 0-based COO arrays as a coordinate MatrixMarket object."""
    rows0 = np.asarray(rows0)
    return MatrixMarket(
        object="matrix",
        format="coordinate",
        field="real",
        symmetry=symmetry,
        num_rows=int(num_rows),
        num_columns=int(num_columns),
        num_entries=int(rows0.size),
        rows_1based=(rows0 + 1).astype(INDEX_DTYPE, copy=False),
        cols_1based=(np.asarray(cols0) + 1).astype(INDEX_DTYPE,
                                                   copy=False),
        values=np.asarray(values, dtype=VALUE_DTYPE),
    )


def poisson2d(nx: int, ny: int = None) -> MatrixMarket:
    """5-point Laplacian on an nx-by-ny grid: n = nx*ny rows.

    Row-major grid numbering; stencil (4, -1, -1, -1, -1).
    """
    if ny is None:
        ny = nx
    n = nx * ny
    # int32 indices: nnz-length arrays dominate generation cost at
    # large n (first-touch page faults; see bench.py).  Guarded so
    # the documented assumption fails loudly instead of wrapping.
    if n >= (1 << 31):
        raise ValueError(
            f"poisson2d grid {nx}x{ny} has {n} rows; int32 index "
            "generation caps at 2^31-1")
    idx = np.arange(n, dtype=np.int32)
    ix = idx % np.int32(nx)
    iy = idx // np.int32(nx)

    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 4.0)]

    def neighbor(mask, offset):
        r = idx[mask]
        rows.append(r)
        cols.append(r + np.int32(offset))
        vals.append(np.full(r.size, -1.0))

    neighbor(ix > 0, -1)
    neighbor(ix < nx - 1, +1)
    neighbor(iy > 0, -nx)
    neighbor(iy < ny - 1, +nx)

    return from_coo_arrays(
        n, n,
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        symmetry="general",
    )


def anisotropic2d(nx: int, ny: int = None,
                  epsilon: float = 100.0) -> MatrixMarket:
    """Anisotropic 5-point Laplacian: stencil
    (2 + 2*epsilon, -1, -1, -epsilon, -epsilon).

    SPD like :func:`poisson2d` but with condition number growing with
    ``epsilon`` — the standard stress case for preconditioners (plain
    CG iteration counts blow up; incomplete factorizations couple the
    strong direction and cut them disproportionately).
    """
    if ny is None:
        ny = nx
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = idx // nx

    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 2.0 + 2.0 * epsilon)]

    def neighbor(mask, offset, w):
        r = idx[mask]
        rows.append(r)
        cols.append(r + offset)
        vals.append(np.full(r.size, -w))

    neighbor(ix > 0, -1, 1.0)
    neighbor(ix < nx - 1, +1, 1.0)
    neighbor(iy > 0, -nx, epsilon)
    neighbor(iy < ny - 1, +nx, epsilon)

    return from_coo_arrays(
        n, n,
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        symmetry="general",
    )


def random_sparse(
    num_rows: int,
    num_columns: int,
    nnz_per_row: int,
    seed: int = 0,
) -> MatrixMarket:
    """Uniformly random pattern, ~nnz_per_row entries per row, no dups."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(num_rows, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, num_columns, size=rows.size, dtype=np.int64)
    # Deduplicate (r, c) pairs.
    key = rows * num_columns + cols
    _, unique_idx = np.unique(key, return_index=True)
    rows, cols = rows[unique_idx], cols[unique_idx]
    vals = rng.standard_normal(rows.size)
    return from_coo_arrays(num_rows, num_columns, rows, cols, vals)


def banded_random(
    num_rows: int,
    half_bandwidth: int,
    nnz_per_row: int,
    seed: int = 0,
) -> MatrixMarket:
    """~nnz_per_row entries per row scattered uniformly inside a band.

    The irregular-matrix stress case (probes 12/26-28): columns are
    spread across the whole band instead of clustering, which defeats
    per-slot-window packing and exercises the WELL-CW format."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(num_rows, dtype=np.int64), nnz_per_row)
    off = rng.integers(-half_bandwidth, half_bandwidth + 1, rows.size)
    cols = np.clip(rows + off, 0, num_rows - 1)
    key = np.unique(rows * num_rows + cols)
    rows, cols = key // num_rows, key % num_rows
    vals = rng.standard_normal(rows.size)
    return from_coo_arrays(num_rows, num_rows, rows, cols, vals)


def block_random(
    num_rows: int,
    num_columns: int,
    blocks_per_block_row: int,
    block: int = 128,
    seed: int = 0,
) -> MatrixMarket:
    """Random block-structured pattern: dense block x block tiles at
    random block-column positions — the SuiteSparse-style structure
    (multi-DOF FEM / circuit matrices) where BSR's MXU path wins for
    SpMM workloads."""
    rng = np.random.default_rng(seed)
    nbr = max(num_rows // block, 1)
    nbc = max(num_columns // block, 1)
    bi = np.repeat(np.arange(nbr, dtype=np.int64),
                   blocks_per_block_row)
    bj = rng.integers(0, nbc, size=bi.size, dtype=np.int64)
    key = np.unique(bi * nbc + bj)
    bi, bj = key // nbc, key % nbc
    # int32 expansion: the nnz-length index arrays dominate the cost
    # of generation on hosts where first-touch page faults are
    # expensive.  Guarded: row/col values must fit int32.
    if max(num_rows, num_columns) >= (1 << 31):
        raise ValueError(
            "block_random dimensions must fit int32 (< 2^31)")
    within = np.arange(block * block, dtype=np.int32)
    rows = (bi[:, None].astype(np.int32) * np.int32(block)
            + (within[None] // block)).reshape(-1)
    cols = (bj[:, None].astype(np.int32) * np.int32(block)
            + (within[None] % block)).reshape(-1)
    vals = rng.standard_normal(rows.size)
    return from_coo_arrays(num_rows, num_columns, rows, cols, vals)


def banded(num_rows: int, half_bandwidth: int, seed: int = 0) -> MatrixMarket:
    """Full band of width 2*half_bandwidth+1 around the diagonal."""
    rng = np.random.default_rng(seed)
    offsets = np.arange(-half_bandwidth, half_bandwidth + 1)
    rows = np.repeat(np.arange(num_rows, dtype=np.int64), offsets.size)
    cols = rows + np.tile(offsets, num_rows)
    ok = (cols >= 0) & (cols < num_rows)
    rows, cols = rows[ok], cols[ok]
    vals = rng.standard_normal(rows.size)
    return from_coo_arrays(num_rows, num_rows, rows, cols, vals)


def powerlaw(
    num_rows: int,
    num_columns: int,
    mean_nnz_per_row: float = 8.0,
    alpha: float = 1.5,
    seed: int = 0,
) -> MatrixMarket:
    """Skewed (Pareto-ish) row lengths; a few very long rows."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, size=num_rows) + 1.0
    lengths = np.minimum(
        (raw * mean_nnz_per_row / raw.mean()).astype(np.int64) + 1,
        num_columns,
    )
    rows = np.repeat(np.arange(num_rows, dtype=np.int64), lengths)
    cols = rng.integers(0, num_columns, size=rows.size, dtype=np.int64)
    key = rows * num_columns + cols
    _, unique_idx = np.unique(key, return_index=True)
    rows, cols = rows[unique_idx], cols[unique_idx]
    vals = rng.standard_normal(rows.size)
    return from_coo_arrays(num_rows, num_columns, rows, cols, vals)

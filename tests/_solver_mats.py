"""Matrices of the solver tests, made with numpy from a seed and handed
to both packages as the same COO arrays (``(n, rows, cols, vals)``,
0-based, row-major, no duplicates)."""

import numpy as np


def _coo(n, rows, cols, vals):
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    return n, rows[order], cols[order], np.asarray(vals, np.float64)[order]


def banded_nonsym(n=400, half_bandwidth=12, per_row=5, seed=11):
    """banded_random's pattern (entries scattered in a band, standard
    normal values) with a dominant diagonal: non-symmetric, and every
    solver converges on it."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    off = rng.integers(-half_bandwidth, half_bandwidth + 1, rows.size)
    cols = np.clip(rows + off, 0, n - 1)
    key = np.unique(rows * n + cols)
    rows, cols = key // n, key % n
    vals = rng.standard_normal(rows.size)
    keep = rows != cols
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    dom = np.bincount(rows, weights=np.abs(vals), minlength=n) + 1.0
    return _coo(n, np.concatenate([rows, np.arange(n)]),
                np.concatenate([cols, np.arange(n)]),
                np.concatenate([vals, dom]))


def convection_diffusion(nx=20, ny=16, wind=0.4):
    """A 5-point convection-diffusion stencil: the Laplacian's (4, -1,
    -1, -1, -1) plus central differences of a wind along x and half of
    it along y, non-symmetric (-1 -+ wind on the x neighbours)."""
    n = nx * ny
    i = np.arange(n, dtype=np.int64)
    x, y = i % nx, i // nx
    rows, cols, vals = [i], [i], [np.full(n, 4.0)]
    for dx, dy, v in ((1, 0, -1.0 + wind), (-1, 0, -1.0 - wind),
                      (0, 1, -1.0 + wind / 2), (0, -1, -1.0 - wind / 2)):
        ok = (x + dx >= 0) & (x + dx < nx) & (y + dy >= 0) & (y + dy < ny)
        rows.append(i[ok])
        cols.append(i[ok] + dx + dy * nx)
        vals.append(np.full(int(ok.sum()), v))
    return _coo(n, np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals))


def poisson(nx=16, ny=12):
    """The 5-point Laplacian of an nx x ny grid (poisson2d's stencil)."""
    return convection_diffusion(nx, ny, wind=0.0)


def renumber(coo, new_order):
    """The COO arrays with row and column i renamed new_order[i]
    (``MatrixMarket.permute``'s convention)."""
    n, rows, cols, vals = coo
    return _coo(n, new_order[rows], new_order[cols], vals)


def csr_of(coo, CsrMatrix):
    """The COO arrays as a package's unpadded host ``CsrMatrix``."""
    n, rows, cols, vals = coo
    rp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=rp[1:])
    return CsrMatrix(n, n, rows.size, 1, rp, cols.astype(np.int32),
                     vals.copy())


def dense_of(coo):
    n, rows, cols, vals = coo
    A = np.zeros((n, n))
    A[rows, cols] = vals
    return A

"""A plain numpy walk of a CSR product in the order the CSR kernels add
(``spmv_tpu_torch/csrc/csr_rows.cuh``), for the CPU tests and the card
tests alike (it imports no JAX).

- A short row (at most ``long_row`` entries) is summed in storage order
  by one thread, each step ``fma(value, x, acc)`` (the card fuses the
  multiply-add; the default here rounds twice, ``value * x + acc``).
- A long row, in a warp (32 lanes) or, past ``block_row`` entries, in a
  block (256 threads): thread t sums entries t, t + S, t + 2S, ... in
  storage order, each product rounded and then added; a column outside
  [0, m) adds nothing.  The lanes of a warp go through a fixed tree,
  ``a[:off] += a[off:2 off]`` for off = 16, 8, 4, 2, 1, and in a block
  the eight warps' totals through one for off = 4, 2, 1.
- With ``out`` each written row gets ``out[i] + sum`` (an empty row is
  left alone), else ``sum``.
"""

import numpy as np

from spmv_tpu_torch.models.device import csr_row_split

WARP = 32
BLOCK = 256


def _plain_fma(a, b, c):
    return a * b + c


def _long_row_sum(col, val, X, S):
    """A long row's sum in the kernels' order: lanes, warp tree, block
    tree; ``X`` (m, k)."""
    m, k = X.shape
    rounds = -(-col.size // S)
    c = np.full(rounds * S, -1, np.int64)
    c[:col.size] = col
    v = np.zeros(rounds * S, X.dtype)
    v[:col.size] = val
    c, v = c.reshape(rounds, S), v.reshape(rounds, S)
    acc = np.zeros((S, k), X.dtype)
    for q in range(rounds):
        ok = (c[q] >= 0) & (c[q] < m)
        prod = v[q][:, None] * X[np.where(ok, c[q], 0)]
        acc = np.where(ok[:, None], acc + prod, acc)
    lanes = acc.reshape(S // WARP, WARP, k)
    off = WARP // 2
    while off:
        lanes[:, :off] = lanes[:, :off] + lanes[:, off:2 * off]
        off //= 2
    warps = lanes[:, 0]
    off = warps.shape[0] // 2
    while off:
        warps[:off] = warps[:off] + warps[off:2 * off]
        off //= 2
    return warps[0]


def csr_walk(row_ptr, col, val, X, long_row, block_row, out=None,
             fma=_plain_fma):
    """y = A x (x of shape (m,)) or Y = A X ((m, k)) in the kernels'
    order, in X's dtype; ``out`` (optional) is added to."""
    row_ptr = np.asarray(row_ptr, np.int64)
    col = np.asarray(col, np.int64)
    X = np.asarray(X)
    vec = X.ndim == 1
    X2 = X.reshape(X.shape[0], -1)
    dt = X2.dtype
    val = np.asarray(val, dt)
    n, m, k = row_ptr.size - 1, X2.shape[0], X2.shape[1]
    add = out is not None
    Y = (np.array(out, dt).reshape(n, k) if add else np.zeros((n, k), dt))
    long_rows, num_block, _ = csr_row_split(row_ptr, long_row, block_row)
    lengths = np.diff(row_ptr)
    for i in np.flatnonzero(lengths <= long_row):
        s, e = row_ptr[i], row_ptr[i + 1]
        if add and s == e:
            continue
        acc = np.zeros(k, dt)
        for j in range(s, e):
            if 0 <= col[j] < m:
                acc = fma(val[j], X2[col[j]], acc)
        Y[i] = Y[i] + acc if add else acc
    for r, i in enumerate(() if long_rows is None else long_rows):
        s, e = row_ptr[i], row_ptr[i + 1]
        tot = _long_row_sum(col[s:e], val[s:e], X2,
                            BLOCK if r < num_block else WARP)
        Y[i] = Y[i] + tot if add else tot
    return Y[:, 0] if vec else Y

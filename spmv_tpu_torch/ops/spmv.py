"""Plain PyTorch versions of the port's kernels: DIA, CSR and WELL-CW.

They are the semantic specification of the CUDA kernels in
``spmv_tpu_torch/csrc``, written after the JAX package's XLA
formulation (``spmv_tpu/ops/spmv.py``).  The CPU tests run them; on the
card ``chip_smoke.py`` holds the kernels against them.

- ``dia_spmv_reference`` / ``dia_spmm_reference`` (K1 / K2), after
  ``_dia_padded`` and the DIA branch of ``spmm``:

      y[i] = sum_k data[k, i] * x[i + offsets[k]]

  with the terms whose column falls outside [0, num_columns) left out.
  Storage narrower than 32 bits (bfloat16) accumulates in float32, as
  the Pallas kernel does, and rounds once at the end.
- ``csr_spmv_reference``, after ``_csr_padded``: each row's products
  summed with ``index_add_``.
- ``cw_merged_reference`` (K3c), ``cw_level_reference`` (K3a) and
  ``cw_pool_reference`` (K3b), after ``_wellcw_merged_xla`` and
  ``_wellcw_gathered``: each returns its part's contribution to y, and
  ``wellcw_spmv_reference`` (after ``_wellcw_padded``) adds the parts in
  stream order (merged, levels, pool, tail pools, remainder).  A cell
  reads x at column ``(anchor4 * d + w) * 128 + (loc & 127)``, with
  ``w = loc >> 7`` (levels and pools) or ``(loc >> 7) & (8 d - 1)``
  (merged chunks, whose bits 14 and up carry the pool row).  A column
  past the end reads 0, as the Pallas kernels' zero-padded x tables
  do (XLA's ``mode="clip"`` reads the last entry instead; the two
  differ only where that entry is not finite).

The public entry points ``spmv`` and ``spmm`` are in
``spmv_tpu_torch.ops.dispatch``: they pick the wrapper by container
type, and each wrapper picks by the tensor's device (a CPU tensor takes
the plain version here, a CUDA tensor the kernel, anything else raises).
"""

from __future__ import annotations

import torch

__all__ = [
    "accumulate_dtype",
    "dia_spmv_reference",
    "dia_spmm_reference",
    "csr_spmv_reference",
    "cw_merged_reference",
    "cw_level_reference",
    "cw_pool_reference",
    "wellcw_spmv_reference",
]

LANE = 128


def accumulate_dtype(dtype: torch.dtype) -> torch.dtype:
    """The accumulator type of the DIA kernels: the storage type when it
    is at least 32 bits wide, float32 otherwise."""
    return dtype if dtype.itemsize >= 4 else torch.float32


def _accumulate(A, x: torch.Tensor) -> torch.Tensor:
    """Sum over the diagonals in the accumulator type.  ``x`` is (m,) or
    (m, k); the result is (n,) or (n, k)."""
    acc = accumulate_dtype(A.data.dtype)
    n, m = A.num_rows, A.num_columns
    xs = x.to(A.data.dtype).to(acc)
    y = torch.zeros((n,) + tuple(xs.shape[1:]), dtype=acc,
                    device=A.data.device)
    for k, off in enumerate(A.offsets):
        lo, hi = max(0, -off), min(n, m - off)
        if hi <= lo:
            continue
        d = A.data[k, lo:hi].to(acc)
        if xs.dim() == 2:
            d = d[:, None]
        y[lo:hi] += d * xs[lo + off:hi + off]
    return y


def dia_spmv_reference(A, x: torch.Tensor, with_dot: bool = False):
    """y = A @ x; with ``with_dot`` also <x, A x> in the accumulator type
    (the plain version of K1's fused dot, summed over the rows that have
    an x entry)."""
    y = _accumulate(A, x)
    out = y.to(A.data.dtype)
    if not with_dot:
        return out
    r = min(A.num_rows, A.num_columns)
    xs = x.to(A.data.dtype).to(y.dtype)
    return out, torch.dot(xs[:r], y[:r])


def dia_spmm_reference(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for X of shape (num_columns, k)."""
    return _accumulate(A, X).to(A.data.dtype)


def csr_spmv_reference(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a ``DeviceCsr``, in the value dtype."""
    dev = A.value.device
    xs = x.to(A.value.dtype)
    counts = (A.row_ptr[1:] - A.row_ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(A.num_rows, device=dev), counts,
        output_size=A.value.numel())
    prod = A.value * xs[A.column_index.long()]
    y = torch.zeros(A.num_rows, dtype=A.value.dtype, device=dev)
    return y.index_add_(0, rows, prod)


def _cw_products(src, x: torch.Tensor, merged: bool = False):
    """(chunks, 8, 128) products value * x[column] of a level, pool or
    merged grid; a column past the end reads 0."""
    loc = src.local_index.long()
    w = loc >> 7
    if merged:
        w = w & (8 * src.d - 1)
    a4 = src.anchor4.reshape(-1, 1, 1).long()
    col = (a4 * src.d + w) * LANE + (loc & (LANE - 1))
    xz = torch.cat([x, x.new_zeros(1)])
    return src.value * xz[col.clamp_(max=x.numel())]


def cw_level_reference(lvl, x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K3a's contribution: each chunk's 8 slots summed into its group
    row."""
    num_groups = lvl.group_ptr.numel() - 1
    contrib = _cw_products(lvl, x).sum(dim=1)          # (chunks, 128)
    y = torch.zeros((num_groups, LANE), dtype=contrib.dtype,
                    device=contrib.device)
    y.index_add_(0, lvl.group_of_chunk.reshape(-1).long(), contrib)
    return y.reshape(-1)[:num_rows]


def cw_pool_reference(pool, x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K3b's contribution: each cell scattered to its ``rowmap`` row."""
    prod = _cw_products(pool, x).reshape(-1)
    lanes = torch.arange(LANE, device=prod.device)
    flat = (pool.rowmap.long() * LANE + lanes).reshape(-1)
    keep = flat < num_rows
    y = torch.zeros(num_rows, dtype=prod.dtype, device=prod.device)
    return y.index_add_(0, flat[keep], prod[keep])


def cw_merged_reference(mg, x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K3c's contribution: level chunk kk of block b sums into group
    ``b * 64 + kk // cap``; pool cells scatter to row ``b * 64 +
    (loc >> 14)``."""
    S, kl, lvl_per = mg.num_blocks, mg.kl, mg.lvl_per_block
    prod = _cw_products(mg, x, merged=True).reshape(S, kl, 8, LANE)
    dev = prod.device
    y = torch.zeros((S * 64, LANE), dtype=prod.dtype, device=dev)
    contrib = prod[:, :lvl_per].sum(dim=2).reshape(-1, LANE)
    groups = torch.arange(S * lvl_per, device=dev) // mg.cap
    y.index_add_(0, groups, contrib)
    if mg.pool_per_block:
        ploc = mg.local_index.reshape(S, kl, 8, LANE)[:, lvl_per:].long()
        base = (torch.arange(S, device=dev) * 64).reshape(S, 1, 1, 1)
        lanes = torch.arange(LANE, device=dev)
        flat = ((base + (ploc >> 14)) * LANE + lanes).reshape(-1)
        y.reshape(-1).index_add_(0, flat, prod[:, lvl_per:].reshape(-1))
    return y.reshape(-1)[:num_rows]


def wellcw_spmv_reference(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a ``DeviceWellCw``: the parts added in stream
    order, in the value dtype."""
    xf = x.to(A.value_dtype)
    n = A.num_rows
    parts = []
    if A.merged is not None:
        parts.append(cw_merged_reference(A.merged, xf, n))
    parts += [cw_level_reference(lv, xf, n) for lv in A.levels]
    pools = ([] if A.pool is None else [A.pool]) + list(A.tail_pools)
    parts += [cw_pool_reference(p, xf, n) for p in pools]
    if A.remainder is not None:
        parts.append(csr_spmv_reference(A.remainder, xf))
    y = parts[0]
    for p in parts[1:]:
        y = y + p
    return y

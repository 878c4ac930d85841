"""Plain PyTorch versions of the port's kernels: DIA, CSR, ELL, hybrid,
WELL-CW, WELL and BSR.

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
- ``ell_spmv_reference`` (the ELL SpMV and SpMM), after ``_ell_padded``
  and the ELL branch of ``spmm``: slot s of every row adds
  ``value[s, i] * x[column_index[s, i]]``, the slots 0..L-1 in order, in
  the accumulator type; ``hybrid_spmv_reference``, after the hybrid
  branches of ``spmv_padded`` and ``spmm``: the ELL part, then the COO
  part (a ``DeviceCsr``) through ``csr_spmv_reference``.
- ``cw_merged_reference`` (K3c / K4a), ``cw_level_reference`` (K3a /
  K4b) and ``cw_pool_reference`` (K3b / K4c), after
  ``_wellcw_merged_xla`` and ``_wellcw_gathered``: each returns its
  part's contribution to y, and ``wellcw_spmv_reference`` (after
  ``_wellcw_padded``) adds the parts in stream order (merged, levels,
  pool, tail pools, remainder).  A cell
  reads x at column ``(anchor4 * d + w) * 128 + (loc & 127)``, with
  ``w = loc >> 7`` (levels and pools) or ``(loc >> 7) & (8 d - 1)``
  (merged chunks, whose bits 14 and up carry the pool row).  A column
  past the end reads 0, as the Pallas kernels' zero-padded x tables
  do (XLA's ``mode="clip"`` reads the last entry instead; the two
  differ only where that entry is not finite).

- ``well_spmv_reference`` (K5a / K5b and K6a / K6b, the spill folded
  in) and ``well_chunks_reference``, after ``_well_padded``: slot s
  of chunk c gathers x at column ``(window_start + segment) * 128 +
  local_index`` (segment 0 in whole-x mode), the 8 slots are summed,
  each chunk adds into its ``group_of_chunk`` rows, and
  ``well_spmv_reference`` adds the spill through
  ``csr_spmv_reference``.  A column at or past the end reads 0, as the
  Pallas kernels' zero-padded x does (XLA clips to the last entry, as
  for WELL-CW).  K5 and K6 read no slot whose ``slot_mask`` bit is
  clear (all its values are zero), so ``well_spmv_reference`` counts
  such a slot as exactly 0 (``torch.where``), even where x holds inf or
  NaN under it; the JAX kernels read it (0 * inf = NaN), and so does
  ``well_chunks_reference(..., masked=False)``, which states that
  reading for the tests.  For finite x the two agree.
- ``bsr_spmm_reference`` (K7a / K7b), after the ``DeviceBsr`` branch of
  ``spmm``: X zero-padded to ``num_block_cols * 128`` rows, each block's
  128 X rows gathered, one product per block, the products summed into
  their block rows with ``index_add_``.  X is first cast to the blocks'
  dtype (a bf16 block rounds X to bf16); bf16 blocks accumulate in float32
  and return float32, as ``bsr_spmm`` does; float32 and float64 blocks
  stay in their own type.

The traffic-isolation variants (``--traffic-split``), after
``spmv_tpu/ops/traffic.py``: each sums the stored layout the product
reads with one stream left out.  The stream-only (regular) versions sum
the values a row holds and read no index and no x:
``csr_regular_reference`` (``_csr_regular``), ``ell_regular_reference``
(``_ell_regular``, the slots in order) and ``well_regular_reference``
(``_well_regular``: the live slots, then the spill).  The gather-only
(irregular) versions sum x at the indices and read no value:
``csr_irregular_reference``, ``ell_irregular_reference`` and
``well_irregular_reference``, where a column outside [0, num_columns)
reads 0, as in the products.  The WELL ones read the live slots alone,
as K5 does: JAX's ``_well_irregular`` gathers every stored slot, so the
port's gather-only sum leaves out the all-zero slots' gathers (a stated
deviation).  They are SpMV only (x of shape (m,)).

The CSR, ELL, hybrid, WELL-CW and WELL versions take x of shape (m,)
or X of shape (m, k) and return (n,) or (n, k): the same code specifies the SpMV
kernels and their SpMM counterparts (K4a-c, K6a-b and the CSR SpMM),
after the WELL-CW, WELL and ``DeviceCsr`` branches of JAX's ``spmm``.
Column j of the SpMM is the SpMV of column j.

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
    "ell_spmv_reference",
    "hybrid_spmv_reference",
    "cw_merged_reference",
    "cw_level_reference",
    "cw_pool_reference",
    "wellcw_spmv_reference",
    "well_chunks_reference",
    "well_spmv_reference",
    "bsr_spmm_reference",
    "csr_regular_reference",
    "csr_irregular_reference",
    "ell_regular_reference",
    "ell_irregular_reference",
    "well_regular_reference",
    "well_irregular_reference",
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
    """y = A @ x for a ``DeviceCsr``, in the value dtype; x (m,) or
    (m, k)."""
    dev = A.value.device
    xs = x.to(A.value.dtype)
    counts = (A.row_ptr[1:] - A.row_ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(A.num_rows, device=dev), counts,
        output_size=A.value.numel())
    prod = _cols(A.value, xs) * xs[A.column_index.long()]
    y = torch.zeros((A.num_rows,) + tuple(xs.shape[1:]),
                    dtype=A.value.dtype, device=dev)
    return y.index_add_(0, rows, prod)


def ell_spmv_reference(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (x (m,)) or Y = A @ X (X (m, k)) for a ``DeviceEll``, in
    the value dtype: the slots added in order 0..L-1, each over every
    row at once, in the accumulator type (``accumulate_dtype``)."""
    acc = accumulate_dtype(A.value.dtype)
    xs = x.to(A.value.dtype).to(acc)
    y = torch.zeros((A.num_rows,) + tuple(xs.shape[1:]), dtype=acc,
                    device=A.value.device)
    for s in range(A.padded_row_length):
        y = y + _cols(A.value[s].to(acc), xs) * xs[A.column_index[s].long()]
    return y.to(A.value.dtype)


def hybrid_spmv_reference(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x or Y = A @ X for a ``DeviceHybrid``: the ELL part, then
    the COO part added (none where it holds no entry)."""
    y = ell_spmv_reference(A.ell, x)
    if A.coo.value.numel() == 0:
        return y
    return y + csr_spmv_reference(A.coo, x)


def _cols(value: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``value`` with a trailing column axis when x has one."""
    return value if x.dim() == 1 else value[..., None]


def _cw_products(src, x: torch.Tensor, merged: bool = False):
    """(chunks, 8, 128[, k]) products value * x[column] of a level, pool
    or merged grid; a column past the end reads 0."""
    loc = src.local_index.long()
    w = loc >> 7
    if merged:
        w = w & (8 * src.d - 1)
    a4 = src.anchor4.reshape(-1, 1, 1).long()
    col = (a4 * src.d + w) * LANE + (loc & (LANE - 1))
    m = x.shape[0]
    xz = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return _cols(src.value, x) * xz[col.clamp_(max=m)]


def cw_level_reference(lvl, x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K3a's (K4b's) contribution: each chunk's 8 slots summed into its
    group row."""
    num_groups = lvl.group_ptr.numel() - 1
    contrib = _cw_products(lvl, x).sum(dim=1)     # (chunks, 128[, k])
    y = torch.zeros((num_groups,) + tuple(contrib.shape[1:]),
                    dtype=contrib.dtype, device=contrib.device)
    y.index_add_(0, lvl.group_of_chunk.reshape(-1).long(), contrib)
    return y.reshape((-1,) + tuple(x.shape[1:]))[:num_rows]


def cw_pool_reference(pool, x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K3b's (K4c's) contribution: each cell scattered to its ``rowmap``
    row."""
    tail = tuple(x.shape[1:])
    prod = _cw_products(pool, x).reshape((-1,) + tail)
    lanes = torch.arange(LANE, device=prod.device)
    flat = (pool.rowmap.long() * LANE + lanes).reshape(-1)
    keep = flat < num_rows
    y = torch.zeros((num_rows,) + tail, dtype=prod.dtype,
                    device=prod.device)
    return y.index_add_(0, flat[keep], prod[keep])


def cw_merged_reference(mg, x: torch.Tensor, num_rows: int) -> torch.Tensor:
    """K3c's (K4a's) contribution: level chunk kk of block b sums into
    group ``b * 64 + kk // cap``; pool cells scatter to row ``b * 64 +
    (loc >> 14)``."""
    S, kl, lvl_per = mg.num_blocks, mg.kl, mg.lvl_per_block
    tail = tuple(x.shape[1:])
    prod = _cw_products(mg, x, merged=True).reshape((S, kl, 8, LANE) + tail)
    dev = prod.device
    y = torch.zeros((S * 64, LANE) + tail, dtype=prod.dtype, device=dev)
    contrib = prod[:, :lvl_per].sum(dim=2).reshape((-1, LANE) + tail)
    groups = torch.arange(S * lvl_per, device=dev) // mg.cap
    y.index_add_(0, groups, contrib)
    y = y.reshape((-1,) + tail)
    if mg.pool_per_block:
        ploc = mg.local_index.reshape(S, kl, 8, LANE)[:, lvl_per:].long()
        base = (torch.arange(S, device=dev) * 64).reshape(S, 1, 1, 1)
        lanes = torch.arange(LANE, device=dev)
        flat = ((base + (ploc >> 14)) * LANE + lanes).reshape(-1)
        y.index_add_(0, flat, prod[:, lvl_per:].reshape((-1,) + tail))
    return y[:num_rows]


def wellcw_spmv_reference(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a ``DeviceWellCw``, x (m,) or (m, k): the parts
    added in stream order, in the value dtype."""
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


def _well_gathers(A, x: torch.Tensor) -> torch.Tensor:
    """(chunks, 8, 128[, k]) x at each WELL slot cell's column, 0 at or
    past the end."""
    k = A.chunks_per_step
    ws = A.window_start.transpose(1, 2).reshape(A.num_chunks, 8).long()
    if A.segment_of_step is not None:
        ws = ws + A.segment_of_step.long().repeat_interleave(k)[:, None]
    col = ws[:, :, None] * LANE + A.local_index.long()
    m = x.shape[0]
    xz = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return xz[col.clamp_(max=m)]


def well_chunks_reference(A, x: torch.Tensor,
                          masked: bool = True) -> torch.Tensor:
    """The WELL chunks of a ``DeviceWell``, without the spill, in the
    value dtype; x (m,) or (m, k).  With ``masked`` a slot whose
    ``slot_mask`` bit is clear adds exactly 0 (K5's and K6's reading);
    without, every slot is read (the JAX kernels' reading)."""
    prod = _cols(A.value, x) * _well_gathers(A, x)  # (chunks, 8, 128[, k])
    return _well_group_sums(A, prod, masked)


def _well_group_sums(A, prod: torch.Tensor, masked: bool) -> torch.Tensor:
    """Sum (chunks, 8, 128[, k]) slot terms over the slots (a slot whose
    ``slot_mask`` bit is clear adding exactly 0 with ``masked``) and each
    chunk into its ``group_of_chunk`` rows."""
    tail = tuple(prod.shape[3:])
    if masked:
        bits = 1 << torch.arange(8, device=prod.device)
        live = (A.slot_mask.long()[:, None] & bits) != 0     # (chunks, 8)
        live = live.reshape(live.shape + (1,) * (prod.dim() - 2))
        prod = torch.where(live, prod, prod.new_zeros(()))
    contrib = prod.sum(dim=1)                        # (chunks, 128[, k])
    y = torch.zeros((A.num_groups, LANE) + tail, dtype=contrib.dtype,
                    device=contrib.device)
    y.index_add_(0, A.group_of_chunk.reshape(-1).long(), contrib)
    return y.reshape((-1,) + tail)[: A.num_rows]


def well_spmv_reference(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (x (m,)) or Y = A @ X (X (m, k)) for a ``DeviceWell``:
    the live slots of the chunks, then the spill, in the value dtype
    (the whole product of K5a and K5b, and of K6a and K6b)."""
    xf = x.to(A.value_dtype)
    y = well_chunks_reference(A, xf)
    if A.spill is not None:
        y = y + csr_spmv_reference(A.spill, xf)
    return y


def _gather0(x: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """x[col], 0 where col lies outside [0, len(x))."""
    m = x.shape[0]
    col = col.long()
    xz = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return xz[torch.where((col < 0) | (col >= m), m, col)]


def _csr_row_sums(A, terms: torch.Tensor) -> torch.Tensor:
    """Each row's sum of its entries' ``terms``, for a ``DeviceCsr``."""
    dev = terms.device
    counts = (A.row_ptr[1:] - A.row_ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(A.num_rows, device=dev), counts,
        output_size=terms.shape[0])
    y = torch.zeros(A.num_rows, dtype=terms.dtype, device=dev)
    return y.index_add_(0, rows, terms)


def csr_regular_reference(A) -> torch.Tensor:
    """The stream-only variant for a ``DeviceCsr``: each row's sum of its
    stored values, in the value dtype."""
    return _csr_row_sums(A, A.value)


def csr_irregular_reference(A, x: torch.Tensor) -> torch.Tensor:
    """The gather-only variant for a ``DeviceCsr``: each row's sum of x at
    its stored columns (0 outside the columns), in the value dtype."""
    return _csr_row_sums(A, _gather0(x.to(A.value.dtype), A.column_index))


def ell_regular_reference(A) -> torch.Tensor:
    """The stream-only variant for a ``DeviceEll``: each row's slot
    values added in slot order, in the value dtype."""
    y = torch.zeros(A.num_rows, dtype=A.value.dtype, device=A.value.device)
    for s in range(A.padded_row_length):
        y = y + A.value[s]
    return y


def ell_irregular_reference(A, x: torch.Tensor) -> torch.Tensor:
    """The gather-only variant for a ``DeviceEll``: each row's x at its
    slot columns (0 outside the columns) added in slot order."""
    xs = x.to(A.value.dtype)
    y = torch.zeros(A.num_rows, dtype=A.value.dtype, device=A.value.device)
    for s in range(A.padded_row_length):
        y = y + _gather0(xs, A.column_index[s])
    return y


def well_regular_reference(A) -> torch.Tensor:
    """The stream-only variant for a ``DeviceWell``: the live slots'
    values summed into their rows, then the spill's values."""
    y = _well_group_sums(A, A.value, masked=True)
    if A.spill is not None:
        y = y + csr_regular_reference(A.spill)
    return y


def well_irregular_reference(A, x: torch.Tensor) -> torch.Tensor:
    """The gather-only variant for a ``DeviceWell``: x at the live slots'
    columns summed into their rows, then x at the spill's columns (0 at
    or past the end)."""
    xf = x.to(A.value_dtype)
    y = _well_group_sums(A, _well_gathers(A, xf), masked=True)
    if A.spill is not None:
        y = y + csr_irregular_reference(A.spill, xf)
    return y


def bsr_spmm_reference(A, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a ``DeviceBsr``, X of shape (num_columns, k): Y is
    (num_rows, k) in the accumulator type (float32 for bf16 blocks)."""
    acc = accumulate_dtype(A.blocks.dtype)
    k = X.shape[1]
    xp = X.new_zeros((A.num_block_cols * LANE, k), dtype=A.blocks.dtype)
    xp[: X.shape[0]] = X.to(A.blocks.dtype)
    gathered = xp.reshape(A.num_block_cols, LANE, k)[A.block_col.long()]
    prods = torch.bmm(A.blocks.to(acc), gathered.to(acc))  # (NB, bh, k)
    block_row = A.block_row.long().repeat_interleave(A.blocks_per_step)
    y = torch.zeros((A.num_block_rows, A.block_rows, k), dtype=acc,
                    device=prods.device)
    y.index_add_(0, block_row, prods)
    return y.reshape(-1, k)[: A.num_rows]

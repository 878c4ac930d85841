"""Device-side containers: DIA, CSR and WELL-CW.

The counterparts of ``spmv_tpu.models.device``'s ``DeviceDia``,
``DeviceCsr`` and ``DeviceWellCw`` (with its ``DeviceCwLevel``,
``DeviceCwPool`` and ``DeviceCwMerged``).

- DIA: the TPU container folds each diagonal into (rows/128, 128) lanes
  and pads rows to a multiple of 1024 for the Pallas kernel's DMA
  windows; a CUDA kernel addresses memory linearly, so here each
  diagonal is one contiguous row of ``data`` with exactly ``num_rows``
  entries.
- CSR: the plain unpadded ``row_ptr`` / ``column_index`` / ``value``
  triple.  The TPU container pads entries and rows for its segment sum
  and carries the expanded row ids; the CUDA kernel walks ``row_ptr``.
- WELL-CW: the very arrays the JAX container holds, packed by the same
  numpy code (``_pad_cw_steps`` and ``_build_cw_merged`` are copied
  from ``spmv_tpu/models/device.py``, whose module imports JAX), plus
  the chunk pointers a CUDA grid needs to find a group's or an output
  block's chunks, which the TPU's sequential grid did not.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spmv_tpu.errors import MatrixError
from spmv_tpu.models.csr import CsrMatrix
from spmv_tpu.models.dia import DiaMatrix

__all__ = ["DeviceDia", "DeviceCsr", "DeviceCwLevel", "DeviceCwPool",
           "DeviceCwMerged", "DeviceWellCw", "default_device",
           "default_value_dtype"]

LANE = 128
SUBLANE = 8


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _tensor(a, device, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


def default_device() -> torch.device:
    """The first CUDA device when one is present, else the CPU.  The CPU
    serves the tests; once a card is present nothing switches to it."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def default_value_dtype() -> torch.dtype:
    """float64 when torch's default dtype is float64 (the tests' analogue
    of JAX's x64 mode), else float32."""
    if torch.get_default_dtype() == torch.float64:
        return torch.float64
    return torch.float32


class DeviceDia(torch.nn.Module):
    """DIA matrix on a device: ``data[k, i] = A[i, i + offsets[k]]``.

    Buffers (moved by ``.to(device)``):

    - ``data``: (D, num_rows), the value dtype (float32, float64 or
      bfloat16 storage);
    - ``offsets_dev``: (D,) int32, the diagonal offsets the kernels read.

    Metadata (plain Python values): ``num_rows``, ``num_columns``,
    ``num_entries`` and ``offsets``, a tuple of ints as in the JAX
    container, which the plain versions loop over.  Entries of ``data``
    whose column ``i + offsets[k]`` falls outside [0, num_columns) are
    zero and never read by the kernels.
    """

    format_name = "dia"

    def __init__(self, num_rows: int, num_columns: int, num_entries: int,
                 offsets, data: torch.Tensor):
        super().__init__()
        offsets = tuple(int(o) for o in offsets)
        if data.dim() != 2 or tuple(data.shape) != (len(offsets),
                                                    num_rows):
            raise ValueError(
                f"data has shape {tuple(data.shape)}, expected "
                f"{(len(offsets), num_rows)}")
        self.num_rows = int(num_rows)
        self.num_columns = int(num_columns)
        self.num_entries = int(num_entries)
        self.offsets = offsets
        self.register_buffer("data", data.contiguous())
        self.register_buffer("offsets_dev", torch.tensor(
            offsets, dtype=torch.int32, device=data.device))

    @property
    def num_diagonals(self) -> int:
        return len(self.offsets)

    @classmethod
    def from_host(cls, m: DiaMatrix, dtype: Optional[torch.dtype] = None,
                  device=None) -> "DeviceDia":
        dtype = dtype or default_value_dtype()
        data = torch.from_numpy(np.ascontiguousarray(m.data,
                                                     dtype=np.float64))
        return cls(m.num_rows, m.num_columns, m.num_entries, m.offsets,
                   data.to(device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x (the plain version on the CPU, kernel K1 on CUDA)."""
        from spmv_tpu_torch.ops.dispatch import spmv

        return spmv(self, x)


class DeviceCsr(torch.nn.Module):
    """CSR on a device, unpadded: row i holds
    ``column_index[row_ptr[i]:row_ptr[i + 1]]`` and the same slice of
    ``value``.

    Buffers: ``row_ptr`` (num_rows + 1,) int32, ``column_index``
    (stored,) int32 and ``value`` (stored,) in the value dtype.  The JAX
    container's padded entries, overflow row and expanded row ids serve
    its segment sum; the CUDA kernel walks ``row_ptr`` and needs none of
    them.
    """

    format_name = "csr"

    def __init__(self, num_rows: int, num_columns: int, num_entries: int,
                 row_ptr: torch.Tensor, column_index: torch.Tensor,
                 value: torch.Tensor):
        super().__init__()
        if tuple(row_ptr.shape) != (num_rows + 1,):
            raise ValueError(f"row_ptr has shape {tuple(row_ptr.shape)}, "
                             f"expected {(num_rows + 1,)}")
        if column_index.shape != value.shape or column_index.dim() != 1:
            raise ValueError("column_index and value must be 1-D and of "
                             "one length")
        self.num_rows = int(num_rows)
        self.num_columns = int(num_columns)
        self.num_entries = int(num_entries)
        self.register_buffer("row_ptr", row_ptr.to(torch.int32).contiguous())
        self.register_buffer("column_index",
                             column_index.to(torch.int32).contiguous())
        self.register_buffer("value", value.contiguous())

    @classmethod
    def from_host(cls, m: CsrMatrix, dtype: Optional[torch.dtype] = None,
                  device=None) -> "DeviceCsr":
        dtype = dtype or default_value_dtype()
        stored = int(m.row_ptr[-1])
        return cls(
            m.num_rows, m.num_columns, m.num_entries,
            _tensor(np.asarray(m.row_ptr, np.int32), device),
            _tensor(np.asarray(m.column_index[:stored], np.int32), device),
            _tensor(np.asarray(m.value[:stored], np.float64), device, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x (the plain version on the CPU, the CSR kernel on
        CUDA)."""
        from spmv_tpu_torch.ops.dispatch import spmv

        return spmv(self, x)


def _check_cw_dtype(dtype: torch.dtype) -> None:
    if dtype.itemsize < 4 or not dtype.is_floating_point:
        raise MatrixError(
            "DeviceWellCw requires a >=32-bit value dtype; got "
            f"{str(dtype).replace('torch.', '')}.")


class DeviceCwLevel(torch.nn.Module):
    """One WELL-CW level of the fallback layout (kernel K3a).

    Buffers, as in the JAX container: ``value`` (chunks, 8, 128),
    ``local_index`` (chunks, 8, 128) int32, ``anchor4`` and
    ``group_of_chunk`` (steps, 1, K) int32, ``block_of_step`` (steps,)
    int32; and

    - ``group_ptr`` (num_groups + 1,) int32: group g's chunks are
      ``[group_ptr[g], group_ptr[g + 1])`` (``group_of_chunk`` is
      non-decreasing), so one CUDA thread per (group, lane) finds its
      run without the TPU's in-order grid.

    Metadata: ``d``, ``num_chunks``, ``chunks_per_step`` (K) and ``xr4``
    (the JAX stride-table height, kept for parity; no table is built).
    """

    def __init__(self, d, chunks_per_step, xr4, value, local_index,
                 anchor4, group_of_chunk, block_of_step, num_groups,
                 dtype, device=None):
        super().__init__()
        self.d = int(d)
        self.num_chunks = int(value.shape[0])
        self.chunks_per_step = int(chunks_per_step)
        self.xr4 = int(xr4)
        grp = np.asarray(group_of_chunk).reshape(-1)
        ptr = np.searchsorted(grp, np.arange(num_groups + 1))
        self.register_buffer("value", _tensor(value, device, dtype))
        self.register_buffer("local_index",
                             _tensor(local_index.astype(np.int32), device))
        self.register_buffer("anchor4",
                             _tensor(anchor4.astype(np.int32), device))
        self.register_buffer("group_of_chunk",
                             _tensor(group_of_chunk.astype(np.int32), device))
        self.register_buffer("block_of_step",
                             _tensor(block_of_step.astype(np.int32), device))
        self.register_buffer("group_ptr",
                             _tensor(ptr.astype(np.int32), device))


class DeviceCwPool(torch.nn.Module):
    """A pooled WELL-CW level (kernel K3b): the fallback layout's
    stage-1 pool, or a tail pool of either layout.  Chunks are shared
    across the ``out_rows`` groups of one output block; ``rowmap`` holds
    each cell's global group.

    Buffers, as in the JAX container: ``value``, ``local_index`` and
    ``rowmap`` (chunks, 8, 128), ``anchor4`` (steps, 1, K),
    ``block_of_step`` (steps,); and

    - ``block_ptr`` (num_blocks + 1,) int32: output block b's chunks are
      ``[block_ptr[b], block_ptr[b + 1])``, so one CUDA block per output
      block finds its run.

    Metadata: ``d``, ``num_chunks``, ``chunks_per_step``, ``xr4`` and
    ``out_rows`` (64 for the stage-1 pool, the pool width for a tail).
    """

    def __init__(self, d, chunks_per_step, xr4, value, local_index,
                 anchor4, rowmap, block_of_step, num_groups, dtype,
                 device=None, out_rows: int = 64):
        super().__init__()
        self.d = int(d)
        self.num_chunks = int(value.shape[0])
        self.chunks_per_step = int(chunks_per_step)
        self.xr4 = int(xr4)
        self.out_rows = int(out_rows)
        self.num_blocks = -(-int(num_groups) // self.out_rows)
        blks = np.asarray(block_of_step).reshape(-1)
        ptr = np.searchsorted(blks, np.arange(self.num_blocks + 1)) \
            * self.chunks_per_step
        self.register_buffer("value", _tensor(value, device, dtype))
        self.register_buffer("local_index",
                             _tensor(local_index.astype(np.int32), device))
        self.register_buffer("anchor4",
                             _tensor(anchor4.astype(np.int32), device))
        self.register_buffer("rowmap", _tensor(rowmap.astype(np.int32), device))
        self.register_buffer("block_of_step",
                             _tensor(block_of_step.astype(np.int32), device))
        self.register_buffer("block_ptr",
                             _tensor(ptr.astype(np.int32), device))


class DeviceCwMerged(torch.nn.Module):
    """The merged WELL-CW grid (kernel K3c): the single level's dense
    slots and the capped stage-1 pool of each 64-group output block in
    one run of ``kl = 64 * cap + pool_per_block`` chunks.

    - chunk kk < ``lvl_per_block`` of block b is a level chunk of group
      ``b * 64 + kk // cap``;
    - the rest are pool chunks, with the cell's row relative to the
      block in ``local_index`` bits 14 and up.

    Buffers, as in the JAX container: ``value`` and ``local_index``
    (num_blocks * kl, 8, 128), ``anchor4`` (num_blocks, 1, kl).  The
    chunk positions are static, so a CUDA grid needs no extra index.
    """

    def __init__(self, d, kl, cap, lvl_per_block, pool_per_block,
                 num_blocks, xr4, value, local_index, anchor4, dtype,
                 device=None):
        super().__init__()
        self.d = int(d)
        self.kl = int(kl)
        self.cap = int(cap)
        self.lvl_per_block = int(lvl_per_block)
        self.pool_per_block = int(pool_per_block)
        self.num_blocks = int(num_blocks)
        self.xr4 = int(xr4)
        self.register_buffer("value", _tensor(value, device, dtype))
        self.register_buffer("local_index",
                             _tensor(local_index.astype(np.int32), device))
        self.register_buffer("anchor4",
                             _tensor(anchor4.astype(np.int32), device))


class DeviceWellCw(torch.nn.Module):
    """WELL-CW (chunk-window WELL) on a device; see
    ``spmv_tpu.models.wellcw`` for the format.

    Two layouts, chosen as the JAX container chooses:

    - **merged**: ``merged`` holds the level and the stage-1 pool
      (``levels`` empty, ``pool`` None), when the host matrix has one
      level whose dense slots waste little;
    - **fallback**: ``levels`` and ``pool`` (``merged`` None), for
      multi-level specs, small matrices, or an explicit
      ``chunks_per_step``.

    ``tail_pools`` (wide pools) and ``remainder`` (a ``DeviceCsr``) add
    to either.  The product runs them in that order: merged, levels,
    pool, tail pools, remainder.
    """

    format_name = "wellcw"

    def __init__(self, num_rows, num_columns, num_entries, num_groups,
                 blocks_per_out, levels=(), pool=None, remainder=None,
                 merged=None, tail_pools=()):
        super().__init__()
        self.num_rows = int(num_rows)
        self.num_columns = int(num_columns)
        self.num_entries = int(num_entries)
        self.num_groups = int(num_groups)
        self.blocks_per_out = int(blocks_per_out)
        self.levels = torch.nn.ModuleList(levels)
        self.register_module("pool", pool)
        self.register_module("remainder", remainder)
        self.register_module("merged", merged)
        self.tail_pools = torch.nn.ModuleList(tail_pools)

    @property
    def value_dtype(self) -> torch.dtype:
        src = self.merged if self.merged is not None else self.levels[0]
        return src.value.dtype

    @classmethod
    def from_host(cls, m, dtype: Optional[torch.dtype] = None,
                  blocks_per_out: Optional[int] = None,
                  chunks_per_step: Optional[int] = None,
                  device=None) -> "DeviceWellCw":
        """Device conversion, as ``spmv_tpu``'s ``DeviceWellCw.from_host``:
        the same layout choice, K (chunks per step), B (8-group blocks
        per output block) and arrays."""
        dtype = dtype or default_value_dtype()
        _check_cw_dtype(dtype)
        num_groups = m.num_groups
        has_pool = getattr(m, "pool", None) is not None
        if blocks_per_out is None:
            blocks_per_out = max(1, min(8, num_groups // SUBLANE))
            if has_pool:
                # pooled chunks span POOL_GROUPS=64 groups = one
                # 8-block output tile; the out block must cover them
                blocks_per_out = 8
        elif has_pool and int(blocks_per_out) != 8:
            raise MatrixError(
                "a pooled WELL-CW matrix requires blocks_per_out=8 "
                "(pool spans 64 groups)")
        b_out = int(blocks_per_out)
        out_rows = SUBLANE * b_out
        num_blocks = -(-num_groups // (SUBLANE * b_out))

        tails = []
        for tp in getattr(m, "tail_pools", ()):
            # step size from the actual run lengths (a deep catch-all
            # ladder may hold thin 2-chunk runs)
            counts = np.bincount(np.asarray(tp.pool_of_chunk))
            max_run = int(counts.max(initial=1))
            kp = 1 << int(np.ceil(np.log2(max(1, max_run))))
            kp = max(1, min(kp, 64))
            t_rows = int(tp.pool_groups)
            base_grp = np.asarray(tp.pool_of_chunk).astype(np.int64) * t_rows
            tv, tl, tws, _g, tblks, trm = _pad_cw_steps(
                np.asarray(tp.value), np.asarray(tp.local_index),
                np.asarray(tp.anchor4), base_grp, num_groups,
                k=kp, out_rows=t_rows, rowmap=np.asarray(tp.rowmap))
            tails.append(DeviceCwPool(
                tp.d, kp, _xr4(m, tp), tv, tl, tws, trm, tblks,
                num_groups, dtype, device, out_rows=t_rows))

        remainder = None
        if m.remainder is not None:
            remainder = DeviceCsr.from_host(m.remainder, dtype=dtype,
                                            device=device)

        merged = None
        if chunks_per_step is None:
            mg = _build_cw_merged(m)
            if mg is not None:
                merged = DeviceCwMerged(**mg, dtype=dtype, device=device)
        if merged is not None:
            return cls(m.num_rows, m.num_columns, m.num_entries,
                       num_groups, 8, remainder=remainder, merged=merged,
                       tail_pools=tails)

        levels = []
        for lv in m.levels:
            k = (_steps_for(lv.num_chunks, num_blocks)
                 if chunks_per_step is None else int(chunks_per_step))
            value, loc, ws, grp2, blks = _pad_cw_steps(
                np.asarray(lv.value), np.asarray(lv.local_index),
                np.asarray(lv.anchor4), np.asarray(lv.group_of_chunk),
                num_groups, k=k, out_rows=out_rows)
            levels.append(DeviceCwLevel(
                lv.d, k, _xr4(m, lv), value, loc, ws, grp2, blks,
                num_groups, dtype, device))
        pool = None
        if has_pool:
            pl_ = m.pool
            kp = (_steps_for(pl_.num_chunks, num_blocks)
                  if chunks_per_step is None else int(chunks_per_step))
            # pool_of_chunk indexes 64-group pools == output blocks, so
            # feeding base-group ids to the padder reuses its block-run
            # logic unchanged
            base_grp = np.asarray(pl_.pool_of_chunk).astype(np.int64) \
                * out_rows
            value, loc, ws, _grp2, blks, rm = _pad_cw_steps(
                np.asarray(pl_.value), np.asarray(pl_.local_index),
                np.asarray(pl_.anchor4), base_grp, num_groups, k=kp,
                out_rows=out_rows, rowmap=np.asarray(pl_.rowmap))
            pool = DeviceCwPool(pl_.d, kp, _xr4(m, pl_), value, loc, ws,
                                rm, blks, num_groups, dtype, device)
        return cls(m.num_rows, m.num_columns, m.num_entries, num_groups,
                   b_out, levels=levels, pool=pool, remainder=remainder,
                   tail_pools=tails)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x (the plain versions on the CPU, kernels K3a-c and
        the CSR kernel on CUDA)."""
        from spmv_tpu_torch.ops.dispatch import spmv

        return spmv(self, x)


def _steps_for(num_chunks: int, num_blocks: int) -> int:
    """Default chunks per step of a fallback level or pool, by the
    average chunks per output block."""
    avg = num_chunks / max(num_blocks, 1)
    return 64 if avg >= 32 else 32 if avg >= 16 else 16 if avg >= 8 else 8


def _xr4(m, lvl) -> int:
    """The JAX stride-table height of a level or pool: covers the whole
    column space and the largest anchor's 8-row slice."""
    a_max = int(np.asarray(lvl.anchor4).max(initial=0))
    return round_up(max(-(-m.num_columns // (LANE * lvl.d)),
                        a_max + SUBLANE), SUBLANE)


def _pad_cw_steps(value, loc, a4, grp, num_groups, k, out_rows,
                  rowmap=None):
    """Pad each output block's chunk run to a multiple of K with inert
    chunks (value 0, anchor 0) so one grid step never spans two output
    blocks; pad chunks carry the block's last group so group ids stay
    non-decreasing.  Returns step-staged (value, loc, ws, grp2,
    block_of_step[, rowmap]) — ``rowmap`` (pooled levels) is padded
    with each chunk's group id broadcast (inert cells scatter zero)."""
    # each output row of the (padded_groups, 128) result is one group,
    # so a block of out_rows output rows covers out_rows groups
    b_groups = out_rows
    blk = grp // out_rows
    num_blocks = -(-num_groups // b_groups)
    starts = np.searchsorted(blk, np.arange(num_blocks + 1))
    counts = np.diff(starts)
    padded = np.where(counts == 0, k, -(-counts // k) * k)
    out_start = np.concatenate([[0], np.cumsum(padded)])
    total = int(out_start[-1])
    value_o = np.zeros((total, SUBLANE, LANE), value.dtype)
    loc_o = np.zeros((total, SUBLANE, LANE), np.int32)
    a4_o = np.zeros(total, np.int32)
    gpad = np.minimum(
        np.arange(num_blocks) * b_groups + b_groups - 1,
        num_groups - 1).astype(np.int32)
    has = counts > 0
    gpad[has] = grp[starts[1:][has] - 1]
    grp_o = np.repeat(gpad, padded)
    pos = np.arange(value.shape[0]) - starts[:-1][blk] \
        + out_start[:-1][blk]
    value_o[pos] = value
    loc_o[pos] = loc
    a4_o[pos] = a4
    grp_o[pos] = grp
    blks = np.repeat(np.arange(num_blocks, dtype=np.int32),
                     padded // k)
    steps = total // k
    ws = a4_o.reshape(steps, 1, k)
    grp2 = grp_o.reshape(steps, 1, k)
    if rowmap is not None:
        rm_o = np.broadcast_to(
            grp_o[:, None, None], (total, SUBLANE, LANE)
        ).astype(np.int32).copy()
        rm_o[pos] = rowmap
        return value_o, loc_o, ws, grp2, blks, rm_o
    return value_o, loc_o, ws, grp2, blks


def _build_cw_merged(m):
    """The merged level+pool grid's arguments (the fields of
    ``DeviceCwMerged`` as numpy arrays) when the host matrix fits the
    dense-slot pattern, else None.

    Eligible iff: exactly one level with recorded ranks, pool (if any)
    shares the level's window width and pools 64 groups with a
    mergeable cap, and the dense slots (round_up(ng,64) * cap per block)
    would waste <= 15% extra chunks over the packed level.
    """
    levels = getattr(m, "levels", ())
    if len(levels) != 1:
        return None
    lvl = levels[0]
    if not lvl.cap or lvl.rank_of_chunk is None:
        return None
    pool = getattr(m, "pool", None)
    if pool is not None and (
        pool.d != lvl.d or pool.pool_groups != 64
        or not (0 < pool.cap <= 64)
    ):
        return None
    if lvl.d > 16:
        return None               # rowmap fold needs loc bits >= 14
    ng = m.num_groups
    ng_pad = round_up(ng, 64)
    cap = int(lvl.cap)
    lvl_per = 64 * cap
    pool_per = int(pool.cap) if pool is not None else 0
    kl = lvl_per + pool_per
    if kl > 256:
        return None               # the TPU kernel's unroll bound
    dense_total = ng_pad * cap
    if dense_total > max(lvl.num_chunks, 1) * 1.15:
        return None               # zero-filled slots would dominate
    S = ng_pad // 64

    value = np.zeros((S * kl, SUBLANE, LANE),
                     dtype=np.asarray(lvl.value).dtype)
    loc = np.zeros((S * kl, SUBLANE, LANE), dtype=np.int32)
    a4 = np.zeros(S * kl, dtype=np.int32)

    grp = np.asarray(lvl.group_of_chunk).astype(np.int64)
    rank = np.asarray(lvl.rank_of_chunk).astype(np.int64)
    didx = (grp // 64) * kl + (grp % 64) * cap + rank
    value[didx] = np.asarray(lvl.value)
    loc[didx] = np.asarray(lvl.local_index)
    a4[didx] = np.asarray(lvl.anchor4)
    a_max = int(np.asarray(lvl.anchor4).max(initial=0))

    if pool is not None:
        base_grp = np.asarray(pool.pool_of_chunk).astype(np.int64) * 64
        pv, plc, pws, _g, _blks, prm = _pad_cw_steps(
            np.asarray(pool.value), np.asarray(pool.local_index),
            np.asarray(pool.anchor4), base_grp, ng,
            k=pool_per, out_rows=64, rowmap=np.asarray(pool.rowmap))
        n_pool = pv.shape[0]
        if n_pool != S * pool_per:
            return None           # a pool run exceeded its cap
        blk_of = np.arange(n_pool) // pool_per
        rm_rel = prm - (blk_of * 64)[:, None, None]
        if rm_rel.min() < 0 or rm_rel.max() >= 64:
            return None
        if int(plc.max(initial=0)) >= (1 << 14):
            return None           # fold would clobber loc bits
        plc = (plc | (rm_rel.astype(np.int32) << 14)).astype(np.int32)
        pidx = blk_of * kl + lvl_per + np.arange(n_pool) % pool_per
        value[pidx] = pv
        loc[pidx] = plc
        a4[pidx] = pws.reshape(-1)
        a_max = max(a_max, int(np.asarray(pool.anchor4).max(initial=0)))

    xr4 = round_up(
        max(-(-m.num_columns // (LANE * lvl.d)), a_max + SUBLANE),
        SUBLANE)
    return dict(d=lvl.d, kl=kl, cap=cap, lvl_per_block=lvl_per,
                pool_per_block=pool_per, num_blocks=S, xr4=int(xr4),
                value=value, local_index=loc,
                anchor4=a4.reshape(S, 1, kl))

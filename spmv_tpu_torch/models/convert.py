"""Carry device state across from the JAX package.

``dia_from_spmv_tpu`` takes the fields of a ``spmv_tpu`` ``DeviceDia``
as numpy arrays (the caller does the ``np.asarray``, so this module needs
no JAX) and builds the port's ``DeviceDia`` holding the very same
values, so that both packages compute on identical inputs.
``wellcw_from_spmv_tpu``, ``well_from_spmv_tpu``, ``bsr_from_spmv_tpu``
and ``csr_from_spmv_tpu`` take the JAX container itself and read each of its arrays with ``np.asarray`` (which
needs no JAX import here either).
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_tpu_torch.models.device import (
    DeviceBsr,
    DeviceCsr,
    DeviceCwLevel,
    DeviceCwMerged,
    DeviceCwPool,
    DeviceDia,
    DeviceWell,
    DeviceWellCw,
)

__all__ = ["dia_from_spmv_tpu", "csr_from_spmv_tpu", "wellcw_from_spmv_tpu",
           "well_from_spmv_tpu", "bsr_from_spmv_tpu"]


def _to_torch(a: np.ndarray) -> torch.Tensor:
    # numpy has no bfloat16 of its own: JAX hands out ml_dtypes'
    # bfloat16, which torch cannot wrap.  bf16 -> f32 -> bf16 is exact.
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def dia_from_spmv_tpu(arrays: dict, meta: dict, device=None) -> DeviceDia:
    """Port a JAX ``DeviceDia``.

    ``arrays["data"]`` has the TPU layout (D, padded_rows // 128, 128);
    ``meta`` holds ``offsets``, ``num_rows``, ``num_columns`` and
    ``num_entries``.  The lane fold and the padding rows (all zero) are
    dropped: the result's ``data`` is (D, num_rows).
    """
    data = np.asarray(arrays["data"])
    num_rows = int(meta["num_rows"])
    d = data.shape[0]
    flat = data.reshape(d, -1)[:, :num_rows]
    return DeviceDia(
        num_rows,
        int(meta["num_columns"]),
        int(meta["num_entries"]),
        tuple(int(o) for o in meta["offsets"]),
        _to_torch(np.ascontiguousarray(flat)).to(device),
    )


def csr_from_spmv_tpu(Aj, device=None) -> DeviceCsr:
    """Port a JAX ``DeviceCsr``: its first ``num_rows + 1`` row pointers
    and the entries they cover.  The padding entries, the overflow row
    and the expanded row ids are dropped."""
    n = int(Aj.num_rows)
    row_ptr = np.asarray(Aj.row_ptr)[: n + 1]
    stored = int(row_ptr[-1])
    return DeviceCsr(
        n, int(Aj.num_columns), int(Aj.num_entries),
        _to_torch(row_ptr.astype(np.int32)).to(device),
        _to_torch(np.asarray(Aj.column_index)[:stored]).to(device),
        _to_torch(np.asarray(Aj.value)[:stored]).to(device))


def _cw_pool(p, num_groups, device) -> DeviceCwPool:
    return DeviceCwPool(
        p.d, p.chunks_per_step, p.xr4, np.asarray(p.value),
        np.asarray(p.local_index), np.asarray(p.anchor4),
        np.asarray(p.rowmap), np.asarray(p.block_of_step), num_groups,
        None, device, out_rows=p.out_rows)


def wellcw_from_spmv_tpu(Aj, device=None) -> DeviceWellCw:
    """Port a JAX ``DeviceWellCw`` with every array as it is (the
    stored dtype included); the chunk pointers the CUDA grids need are
    derived from the same arrays."""
    ng = int(Aj.num_groups)
    merged = None
    if Aj.merged is not None:
        mg = Aj.merged
        merged = DeviceCwMerged(
            mg.d, mg.kl, mg.cap, mg.lvl_per_block, mg.pool_per_block,
            mg.num_blocks, mg.xr4, np.asarray(mg.value),
            np.asarray(mg.local_index), np.asarray(mg.anchor4), None,
            device)
    levels = [
        DeviceCwLevel(lv.d, lv.chunks_per_step, lv.xr4,
                      np.asarray(lv.value), np.asarray(lv.local_index),
                      np.asarray(lv.anchor4),
                      np.asarray(lv.group_of_chunk),
                      np.asarray(lv.block_of_step), ng, None, device)
        for lv in Aj.levels]
    return DeviceWellCw(
        Aj.num_rows, Aj.num_columns, Aj.num_entries, ng,
        Aj.blocks_per_out, levels=levels,
        pool=None if Aj.pool is None else _cw_pool(Aj.pool, ng, device),
        remainder=(None if Aj.remainder is None
                   else csr_from_spmv_tpu(Aj.remainder, device)),
        merged=merged,
        tail_pools=[_cw_pool(p, ng, device) for p in Aj.tail_pools])


def well_from_spmv_tpu(Aj, device=None) -> DeviceWell:
    """Port a JAX ``DeviceWell`` with every array as it is (the stored
    dtype included); the spill goes through ``csr_from_spmv_tpu`` and the
    step pointers the CUDA grid needs are derived from
    ``block_of_step``."""
    seg = Aj.segment_of_step
    return DeviceWell(
        Aj.num_rows, Aj.num_columns, Aj.num_entries, Aj.window_rows,
        Aj.num_groups, Aj.chunks_per_step, Aj.blocks_per_out,
        Aj.segment_rows, np.asarray(Aj.value), np.asarray(Aj.local_index),
        np.asarray(Aj.window_start), np.asarray(Aj.group_of_chunk),
        np.asarray(Aj.block_of_step),
        None if seg is None else np.asarray(seg),
        None if Aj.spill is None else csr_from_spmv_tpu(Aj.spill, device),
        device=device)


def bsr_from_spmv_tpu(Aj, device=None) -> DeviceBsr:
    """Port a JAX ``DeviceBsr`` with every array as it is (bfloat16
    blocks included); the block-row pointers the CUDA grid needs are
    derived from ``block_row``."""
    return DeviceBsr(
        Aj.num_rows, Aj.num_columns, Aj.num_entries, Aj.num_block_rows,
        Aj.blocks_per_step, _to_torch(np.asarray(Aj.blocks)),
        np.asarray(Aj.block_col), np.asarray(Aj.block_row), device=device)

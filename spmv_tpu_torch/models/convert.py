"""Carry device state across from the JAX package.

``dia_from_spmv_tpu`` takes the fields of a ``spmv_tpu`` ``DeviceDia``
as numpy arrays (the caller does the ``np.asarray``, so this module needs
no JAX) and builds the port's ``DeviceDia`` holding the very same
values, so that both packages compute on identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_tpu_torch.models.device import DeviceDia

__all__ = ["dia_from_spmv_tpu"]


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

"""On-device traffic-split measurement.

The counterpart of ``spmv_tpu/profile/traffic.py``: times the full SpMV
against its stream-only (regular) and gather-only (irregular) variants
(``spmv_tpu_torch.ops.traffic``) with the timing harness's chained slope
(``profile.harness.time_kernel``) and prices each leg with the byte model
``traffic_variant_bytes``, so that the split a roofline assumes can be
checked on the card for the user's own matrix.

- The full leg runs ``ops.dispatch.spmv`` (the hand-written kernel on the
  card), as JAX's runs its generic ``spmv``, and feeds y back as the next
  x; the irregular leg does the same.
- The regular leg reads no x, so it simply relaunches: the JAX package
  scales the values by a loop-carried scalar to keep XLA from hoisting
  the loop-invariant read out of its timing loop, and a CUDA launch is
  never hoisted.
- ``roofline_fraction`` prices each leg at the machine model's memory
  rate: on the card the port's measured triad (``perfmodel.machine``).
"""

from __future__ import annotations

from typing import Optional

import torch

from spmv_tpu_torch.kernels import _chain_output
from spmv_tpu_torch.ops.traffic import (
    check_traffic_format,
    spmv_irregular_traffic,
    spmv_regular_traffic,
    traffic_variant_bytes,
    value_dtype_of,
)

__all__ = ["measure_traffic_split"]


def measure_traffic_split(
    A,
    x: Optional[torch.Tensor] = None,
    spmv_fn=None,
    runs: int = 5,
    machine=None,
) -> dict:
    """Time the full, regular and irregular SpMV legs of the device
    matrix ``A`` and report seconds and achieved GB/s against the byte
    model, in the JAX function's shape.

    ``spmv_fn(A, x)`` is the full product (default ``ops.spmv``); ``x``
    defaults to ones in the value dtype.  ``A`` must be a container the
    variants cover (``KernelError`` with JAX's message otherwise, before
    anything is timed).
    """
    from spmv_tpu_torch.ops.dispatch import spmv
    from spmv_tpu_torch.profile.harness import time_kernel

    check_traffic_format(A)
    if spmv_fn is None:
        spmv_fn = spmv
    dt = value_dtype_of(A)
    dev = (A.ell if hasattr(A, "ell") else A).value.device
    if x is None:
        x = torch.ones(A.num_columns, dtype=dt, device=dev)

    def step_full(v, A):
        return _chain_output(spmv_fn(A, v[: A.num_columns]), v)

    def step_irregular(v, A):
        return _chain_output(spmv_irregular_traffic(A, v[: A.num_columns]),
                             v)

    def step_regular(y, A):
        return spmv_regular_traffic(A)

    t_full = time_kernel(step_full, (x, A), runs=runs)
    t_irr = time_kernel(step_irregular, (x, A), runs=runs)
    y0 = torch.zeros(A.num_rows, dtype=dt, device=dev)
    t_reg = time_kernel(step_regular, (y0, A), runs=runs)

    bytes_model = traffic_variant_bytes(A, x.dtype)
    tf = t_full.seconds_per_iteration
    tr = t_reg.seconds_per_iteration
    ti = t_irr.seconds_per_iteration
    out = {
        "format": getattr(A, "format_name", type(A).__name__),
        "rows": A.num_rows,
        "columns": A.num_columns,
        "stored_entries": bytes_model["stored_entries"],
        "seconds_full": tf,
        "seconds_regular": tr,
        "seconds_irregular": ti,
        "regular_fraction_of_full": tr / tf,
        "irregular_fraction_of_full": ti / tf,
        "additivity": (tr + ti) / tf,
        "analytic": bytes_model,
        "achieved_gbps": {
            "full": bytes_model["full_bytes"] / tf / 1e9,
            "regular": bytes_model["regular_bytes"] / tr / 1e9,
            "irregular": bytes_model["irregular_bytes"] / ti / 1e9,
        },
    }
    if machine is not None:
        # each leg at the machine model's streaming rate
        rate = getattr(machine, "hbm_gbps", None)
        if rate:
            out["roofline_fraction"] = {
                "full": bytes_model["full_bytes"] / 1e9 / rate / tf,
                "regular": bytes_model["regular_bytes"] / 1e9 / rate / tr,
                "irregular":
                    bytes_model["irregular_bytes"] / 1e9 / rate / ti,
            }
    return out

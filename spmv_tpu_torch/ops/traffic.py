"""Traffic-isolation SpMV variants: stream-only and gather-only.

The counterpart of ``spmv_tpu/ops/traffic.py``.  The reference tool ships
variants of its CSR SpMV that separate the regular (streamed: row
structure and values) from the irregular (gathered: x[j[k]]) memory
traffic, so that each can be timed on its own; the JAX package extends
them to ELL, the hybrid and WELL, and so does the port:

- ``spmv_regular_traffic(A, x)``: ``y[i] = sum_k a[k]`` over the stored
  row; streams the values and the row structure and never reads x (x is
  accepted for the signature and ignored, as in JAX).
- ``spmv_irregular_traffic(A, x)``: ``y[i] = sum_k x[j[k]]`` over the
  stored row; issues the full kernel's gathers and never reads a value.

On CUDA tensors each is one launch of a hand-written variant, a mode of
the kernel of the format's product (``csrc/csr_spmv.cu``,
``csrc/ell_spmv.cu``, ``csrc/well_spmv.cu``): the same walk with one
stream left out, so that the full leg minus a variant's leg is the left
out stream.  On CPU tensors each takes its plain version
(``ops/spmv.py``).  Covered: ``DeviceCsr`` (``-s coo`` and ``coo-atomic``
too, through ``DeviceCsr.from_coo_host``), ``DeviceEll``,
``DeviceHybrid`` (the ELL variant, then the CSR variant adding the COO
part into y, as ``hybrid_spmv_core`` runs the product) and ``DeviceWell``
(K5a's or K5b's mode, the spill folded in).  ``DeviceDia``,
``DeviceWellCw`` and ``DeviceBsr`` raise ``KernelError`` with JAX's
message.

Where the port differs from JAX (stated deviations):

- WELL's variants read the live slots only, as K5 does: JAX's
  ``_well_irregular`` gathers every stored slot, so the port's
  gather-only result is JAX's minus the all-zero slots' gathers.
- ``traffic_variant_bytes`` prices what the port's containers hold and
  its variants read, under JAX's keys: CSR has no device row padding or
  overflow row (its long-row list is structure), ELL no sublane row
  padding, and WELL its live slots (a window start each), ``slot_mask``,
  a group a live chunk, the step pointers and the lane-ordered spill.  A
  hybrid's empty COO part is priced at nothing: no variant reads it.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.models.device import (
    LANE,
    DeviceCsr,
    DeviceEll,
    DeviceHybrid,
    DeviceWell,
)
from spmv_tpu_torch.ops.csr_kernels import (
    csr_irregular_core,
    csr_regular_core,
)
from spmv_tpu_torch.ops.ell_kernels import (
    ell_irregular_core,
    ell_regular_core,
    hybrid_irregular_core,
    hybrid_regular_core,
)
from spmv_tpu_torch.ops.well_kernels import (
    well_irregular_core,
    well_regular_core,
)

__all__ = [
    "spmv_regular_traffic",
    "spmv_irregular_traffic",
    "traffic_variant_bytes",
    "check_traffic_format",
    "value_dtype_of",
]

IDX = 4     # bytes of a stored int32 index

_FORMATS = (DeviceCsr, DeviceEll, DeviceHybrid, DeviceWell)


def check_traffic_format(A) -> None:
    """Raise JAX's ``KernelError`` for a container with no variants."""
    if not isinstance(A, _FORMATS):
        raise KernelError(
            f"traffic-isolation variants are not defined for "
            f"{type(A).__name__}")


def value_dtype_of(A) -> torch.dtype:
    """The value dtype of a container the variants cover."""
    return (A.ell if isinstance(A, DeviceHybrid) else A).value.dtype


def spmv_regular_traffic(A, x: torch.Tensor = None) -> torch.Tensor:
    """Stream-only variant: ``y[i] = sum_k a[k]`` over the stored row, in
    the value dtype.  ``x`` is ignored."""
    del x
    check_traffic_format(A)
    if isinstance(A, DeviceCsr):
        return csr_regular_core(A)
    if isinstance(A, DeviceEll):
        return ell_regular_core(A)
    if isinstance(A, DeviceWell):
        return well_regular_core(A)
    return hybrid_regular_core(A)


def spmv_irregular_traffic(A, x: torch.Tensor) -> torch.Tensor:
    """Gather-only variant: ``y[i] = sum_k x[j[k]]`` over the stored row
    (0 for a column outside [0, num_columns)), x cast to the value dtype
    first."""
    check_traffic_format(A)
    x = x.to(value_dtype_of(A)).contiguous()
    if isinstance(A, DeviceCsr):
        return csr_irregular_core(A, x)
    if isinstance(A, DeviceEll):
        return ell_irregular_core(A, x)
    if isinstance(A, DeviceWell):
        return well_irregular_core(A, x)
    return hybrid_irregular_core(A, x)


def _nbytes(t) -> int:
    return 0 if t is None else t.numel() * t.element_size()


def _parts(A, vb: int) -> tuple:
    """(stored entries, structure, value, index) bytes of what the
    variants of A read, x and y left out."""
    if isinstance(A, DeviceCsr):
        stored = A.value.numel()
        return (stored, _nbytes(A.row_ptr) + _nbytes(A.long_rows),
                stored * vb, stored * IDX)
    if isinstance(A, DeviceEll):
        stored = A.value.numel()
        return stored, 0, stored * vb, stored * IDX
    if isinstance(A, DeviceWell):
        bits = 1 << torch.arange(8, device=A.slot_mask.device)
        live = int(((A.slot_mask.long()[:, None] & bits) != 0).sum())
        live_chunks = int((A.slot_mask != 0).sum())
        stored = live * LANE
        struct = (_nbytes(A.slot_mask) + live_chunks * IDX
                  + _nbytes(A.step_ptr))
        idx = stored * IDX + live * IDX + _nbytes(A.segment_of_step)
        val = stored * vb
        if A.spill_value is not None:
            n = A.spill_value.numel()
            stored += n
            struct += _nbytes(A.spill_ptr) + _nbytes(A.spill_row)
            val += n * vb
            idx += n * IDX
        return stored, struct, val, idx
    e = _parts(A.ell, vb)
    if A.coo.value.numel() == 0:
        return e
    c = _parts(A.coo, vb)
    return tuple(a + b for a, b in zip(e, c))


def traffic_variant_bytes(A, x_dtype=None) -> dict:
    """The least device-memory bytes each leg moves (full, regular,
    irregular), for pricing the measured triple, under the JAX
    function's keys.

    regular: row structure + values, plus the y write.  irregular: row
    structure + indices + the gathered x (the raw gather volume, one
    element a stored entry, or the x footprint where that is smaller),
    plus the y write.  full: both streams, x once and y.
    """
    check_traffic_format(A)
    vb = value_dtype_of(A).itemsize
    xb = x_dtype.itemsize if x_dtype is not None else vb
    stored, struct, val, idx = _parts(A, vb)
    ybytes = A.num_rows * vb
    xfoot = A.num_columns * xb
    gather = min(stored * xb, xfoot)
    return {
        "stored_entries": stored,
        "structure_bytes": struct,
        "value_bytes": val,
        "index_bytes": idx,
        "gather_element_bytes": stored * xb,
        "x_footprint_bytes": xfoot,
        "y_bytes": ybytes,
        "regular_bytes": struct + val + ybytes,
        "irregular_bytes": struct + idx + gather + ybytes,
        "full_bytes": struct + val + idx + gather + ybytes,
    }

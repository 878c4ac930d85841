"""DIA SpMV / SpMM: the plain PyTorch versions.

``dia_spmv_reference`` and ``dia_spmm_reference`` are the semantic
specification of kernels K1 and K2 (``spmv_tpu_torch/csrc``), written
after the JAX package's XLA formulation (``spmv_tpu/ops/spmv.py``,
``_dia_padded`` and the DIA branch of ``spmm``):

    y[i] = sum_k data[k, i] * x[i + offsets[k]]

with the terms whose column falls outside [0, num_columns) left out.
Storage narrower than 32 bits (bfloat16) accumulates in float32, as the
Pallas kernel does, and rounds once at the end.  The CPU tests run these;
on the card ``chip_smoke.py`` holds the kernels against them.

The public entry points ``spmv`` and ``spmm`` are the wrappers in
``spmv_tpu_torch.ops.dia_kernels``, which dispatch on the tensor's device:
a CPU tensor takes the plain version here, a CUDA tensor the kernel,
anything else raises.
"""

from __future__ import annotations

import torch

__all__ = [
    "accumulate_dtype",
    "dia_spmv_reference",
    "dia_spmm_reference",
]


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


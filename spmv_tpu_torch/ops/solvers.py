"""Conjugate gradient on the DIA operator.

The counterpart of the CG part of ``spmv_tpu/ops/solvers.py``.  The
iteration runs eagerly in a Python loop; the stopping rule is the JAX
package's exactly (iterate while ``r.r > tol^2 * max(b.b, 1e-300)`` and
``k < max_iterations``, compared in the vector dtype), checked with one
scalar ``.item()`` per iteration, so iteration counts compare one to
one with the JAX solvers.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from spmv_tpu_torch.ops.dia_kernels import dia_spmv_core
from spmv_tpu_torch.ops.dia_kernels import spmv

__all__ = [
    "CgResult",
    "conjugate_gradient",
    "preconditioned_conjugate_gradient",
    "dia_conjugate_gradient",
    "jacobi_preconditioner",
    "extract_diagonal",
]


class CgResult(NamedTuple):
    x: torch.Tensor
    residual_norm: torch.Tensor   # 0-d, sqrt of the final r.r
    iterations: int


def _tol2(b: torch.Tensor, tol: float) -> torch.Tensor:
    b_norm2 = torch.clamp(torch.dot(b, b), min=1e-300)
    return torch.tensor(tol, dtype=b.dtype, device=b.device) ** 2 * b_norm2


def _check_recompute(recompute_every: int):
    if recompute_every < 0:
        raise ValueError(
            f"recompute_every must be >= 0, got {recompute_every}")


def conjugate_gradient(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor = None,
    tol: float = 1e-8,
    max_iterations: int = 1000,
    recompute_every: int = 0,
) -> CgResult:
    """Unpreconditioned CG for SPD systems.

    ``recompute_every=k`` (k > 0) replaces the recurrence residual with
    the true residual ``b - A x`` every k iterations, keeping the search
    direction (see the JAX function for the measured reasons).
    """
    return preconditioned_conjugate_gradient(
        matvec, b, None, x0=x0, tol=tol, max_iterations=max_iterations,
        recompute_every=recompute_every)


def preconditioned_conjugate_gradient(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    preconditioner: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor = None,
    tol: float = 1e-8,
    max_iterations: int = 1000,
    recompute_every: int = 0,
) -> CgResult:
    """PCG with an SPD ``preconditioner`` (M^-1 applied to a vector), or
    plain CG when it is None.  Convergence is tested on ||r||."""
    _check_recompute(recompute_every)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - matvec(x)
    z = preconditioner(r) if preconditioner is not None else r
    p = z.clone()
    rz = torch.dot(r, z)
    rr = torch.dot(r, r) if preconditioner is not None else rz
    tol2 = _tol2(b, tol)
    k = 0
    while k < max_iterations and bool(rr > tol2):
        ap = matvec(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        if recompute_every and (k + 1) % recompute_every == 0:
            r = b - matvec(x)
        z = preconditioner(r) if preconditioner is not None else r
        rz_new = torch.dot(r, z)
        rr = torch.dot(r, r) if preconditioner is not None else rz_new
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return CgResult(x=x, residual_norm=torch.sqrt(rr), iterations=k)


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    """M^-1 r = r / diag, with zero diagonal entries passed through
    unscaled."""
    inv = _jacobi_inverse(diag)

    def apply(r):
        return r * inv

    return apply


def _jacobi_inverse(diag: torch.Tensor) -> torch.Tensor:
    safe = torch.where(diag == 0, torch.ones_like(diag), diag)
    return torch.where(diag == 0, torch.ones_like(diag), 1.0 / safe)


def dia_conjugate_gradient(
    A,
    b: torch.Tensor,
    x0: torch.Tensor = None,
    tol: float = 1e-8,
    max_iterations: int = 1000,
    jacobi_diag=None,
    path: str = "auto",
    recompute_every: int = 0,
    fused: bool = True,
) -> CgResult:
    """CG specialised to a ``DeviceDia`` operator.

    ``path`` keeps the JAX function's names so calls port unchanged:

    - ``"pallas"``: the kernel loop, ``_dia_cg_fused``: one
      ``dia_spmv_core`` per iteration with the p.Ap dot fused into it
      (``fused=False`` takes the dot in a separate pass).  On a CUDA
      tensor that is kernel K1; on a CPU tensor the wrapper runs K1's
      plain version.
    - ``"xla"``: generic (P)CG over ``spmv``.  CPU only: on a CUDA
      tensor it raises, because there the kernel loop is the path.
    - ``"auto"``: ``"pallas"`` for a CUDA tensor, ``"xla"`` for a CPU
      tensor.  (The TPU chose by its on-chip residency budget; the
      port has no such budget.)

    ``jacobi_diag`` (optional, length num_rows) switches to Jacobi-
    preconditioned CG.
    """
    if A.num_rows != A.num_columns:
        raise ValueError("dia_conjugate_gradient requires a square matrix")
    _check_recompute(recompute_every)
    if path == "auto":
        path = "pallas" if b.is_cuda else "xla"
    inv = None
    if jacobi_diag is not None:
        inv = _jacobi_inverse(torch.as_tensor(
            jacobi_diag, dtype=b.dtype, device=b.device))
    if path == "xla":
        if b.is_cuda:
            raise ValueError(
                'path="xla" is the plain CPU path; a CUDA tensor takes '
                'the kernel path ("pallas" or "auto")')
        precond = (lambda r: r * inv) if inv is not None else None  # noqa: E731
        return preconditioned_conjugate_gradient(
            lambda v: spmv(A, v), b, precond, x0=x0, tol=tol,
            max_iterations=max_iterations,
            recompute_every=recompute_every)
    if path != "pallas":
        raise ValueError(f"unknown path {path!r}")
    return _dia_cg_fused(A, b, x0, tol, max_iterations, recompute_every,
                         inv=inv, fused=fused)


def _dia_cg_fused(A, b, x0, tol, max_iterations, recompute_every,
                  inv=None, fused=True) -> CgResult:
    """The kernel loop: A p goes into one preallocated buffer through
    ``dia_spmv_core(out=...)``, with p.Ap from the kernel's fused dot
    when ``fused``; vectors update in place.  ``inv`` is the Jacobi
    M^-1 (or None)."""
    b = b.to(A.data.dtype).contiguous()
    ap = torch.empty_like(b)

    def matvec(v):
        return dia_spmv_core(A, v, out=ap)

    def matvec_dot(v):
        if fused:
            return dia_spmv_core(A, v, with_dot=True, out=ap)
        y = matvec(v)
        return y, torch.dot(v, y)

    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype).clone()
    r = b - matvec(x)
    z = r * inv if inv is not None else r
    p = z.clone()
    rz = torch.dot(r, z)
    rr = torch.dot(r, r) if inv is not None else rz
    tol2 = _tol2(b, tol)
    k = 0
    while k < max_iterations and bool(rr > tol2):
        _, pap = matvec_dot(p)
        alpha = rz / pap.to(b.dtype)
        x.addcmul_(p, alpha)
        r.addcmul_(ap, alpha, value=-1)
        if recompute_every and (k + 1) % recompute_every == 0:
            r = b - matvec(x)
        z = r * inv if inv is not None else r
        rz_new = torch.dot(r, z)
        rr = torch.dot(r, r) if inv is not None else rz_new
        p.mul_(rz_new / rz).add_(z)
        rz = rz_new
        k += 1
    return CgResult(x=x, residual_norm=torch.sqrt(rr), iterations=k)


def extract_diagonal(m, dtype=np.float64) -> np.ndarray:
    """Host-side main diagonal of a host matrix (copied from
    ``spmv_tpu.ops.solvers.extract_diagonal``, whose module imports JAX).

    Accepts DiaMatrix (offset-0 slice), CsrMatrix (per-row column
    search), or anything exposing ``row_indices()/column_indices()/
    values_real()`` (MatrixMarket) or ``row_index/column_index/value``
    arrays (COO-like).  Duplicate (i, i) entries sum, matching SpMV
    semantics.
    """
    n = min(m.num_rows, m.num_columns)
    out = np.zeros(n, dtype=dtype)
    offsets = getattr(m, "offsets", None)
    if offsets is not None and hasattr(m, "data"):
        offs = np.asarray(offsets)
        hit = np.nonzero(offs == 0)[0]
        if hit.size:
            out[:] = np.asarray(m.data)[int(hit[0]), :n]
        return out
    if hasattr(m, "row_ptr"):
        rp = np.asarray(m.row_ptr)
        ci = np.asarray(m.column_index)
        va = np.asarray(m.value)
        rows = np.repeat(np.arange(m.num_rows, dtype=np.int64),
                         np.diff(rp))
        sel = rows == ci
        np.add.at(out, rows[sel][rows[sel] < n], va[sel][rows[sel] < n])
        return out
    if hasattr(m, "row_indices"):
        # MatrixMarket accessors are 1-based (matrix-market.cpp:171).
        ri = np.asarray(m.row_indices()) - 1
        ci = np.asarray(m.column_indices()) - 1
        va = np.asarray(m.values_real())
    else:
        ri = np.asarray(m.row_index)
        ci = np.asarray(m.column_index)
        va = np.asarray(m.value)
    sel = ri == ci
    np.add.at(out, ri[sel][ri[sel] < n], va[sel][ri[sel] < n])
    return out

"""Mixed-precision iterative refinement: fp64 answers from low-precision
solves.

The port's counterpart of ``spmv_tpu/ops/refine.py``.  The Krylov solve
runs in the device's working precision (float32 by default) and a few
fp64 residual evaluations on the host recover full accuracy
(Wilkinson 1963; Carson & Higham 2017):

    repeat:  r = b - A x        (fp64, host SpMV)
             d ~= solve(A, r)   (inner_dtype, on the device)
             x = x + d          (fp64, host axpy)

Each pass multiplies the error by about cond(A) * eps_inner, so a few
passes reach eps_fp64 wherever cond(A) << 1 / eps_inner.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from spmv_tpu_torch.models.device import resolve_device

__all__ = ["iterative_refinement", "RefineResult"]


class RefineResult(NamedTuple):
    x: np.ndarray               # fp64 solution
    residual_norm: float        # fp64 true-residual norm at exit
    refinements: int            # outer passes taken
    inner_iterations: int       # total inner (device) iterations


def iterative_refinement(
    a_host,
    b: np.ndarray,
    inner_solve: Callable,
    tol: float = 1e-12,
    max_refinements: int = 20,
    inner_dtype: torch.dtype = torch.float32,
    device=None,
) -> RefineResult:
    """Solve ``A x = b`` to fp64 accuracy with a low-precision inner solver.

    ``a_host`` is any host matrix exposing ``spmv(x) -> y`` in fp64
    (``CsrMatrix``, ``DiaMatrix``, ...), or a callable ``x -> A @ x`` on
    fp64 numpy arrays.  ``inner_solve`` maps a residual tensor (in
    ``inner_dtype``, on ``device``: ``default_device()`` when None) to an
    approximate
    correction: the correction itself or a ``CgResult``-like object with
    ``.x`` and ``.iterations`` (a closure over ``conjugate_gradient``,
    ``gmres`` or ``chebyshev`` at a loose tolerance).

    Stops when the fp64 relative residual reaches ``tol``, or when a
    pass fails to halve the residual (stagnation: cond(A) too large for
    the inner precision), whichever first.  Returns the best iterate
    seen.
    """
    if callable(getattr(a_host, "spmv", None)):
        matvec64 = lambda v: np.asarray(a_host.spmv(v), np.float64)  # noqa: E731
    elif callable(a_host):
        matvec64 = lambda v: np.asarray(a_host(v), np.float64)      # noqa: E731
    else:
        raise TypeError(
            "a_host must expose .spmv or be callable, got "
            f"{type(a_host)!r}")
    b = np.asarray(b, np.float64)
    b_norm = max(float(np.linalg.norm(b)), np.finfo(np.float64).tiny)

    x = np.zeros_like(b)
    best_x, best_rn = x, float("inf")
    device = resolve_device(device)
    prev_rn = float("inf")
    inner_total = 0
    k = 0
    while k < max_refinements:
        r = b - matvec64(x)
        rn = float(np.linalg.norm(r))
        if rn < best_rn:
            best_x, best_rn = x, rn
        if rn <= tol * b_norm:
            break
        if rn > 0.5 * prev_rn:
            # stagnated: the pass failed to at least halve the
            # residual, so the inner precision can't resolve further
            break
        prev_rn = rn
        res = inner_solve(torch.from_numpy(r).to(device=device,
                                                 dtype=inner_dtype))
        d = getattr(res, "x", res)
        inner_total += int(getattr(res, "iterations", 0))
        x = x + d.cpu().double().numpy()
        k += 1
    r = b - matvec64(x)
    rn = float(np.linalg.norm(r))
    if rn < best_rn:
        best_x, best_rn = x, rn
    return RefineResult(x=best_x, residual_norm=best_rn,
                        refinements=k, inner_iterations=inner_total)

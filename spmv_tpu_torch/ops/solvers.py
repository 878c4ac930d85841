"""Conjugate gradient and BiCGSTAB: generic (P)CG over any matvec, the
DIA kernel loop, batched multi-RHS CG over any matmat and over K2, and
BiCGSTAB for non-symmetric systems.

The counterpart of ``spmv_tpu/ops/solvers.py``.  The iteration runs
eagerly in a Python loop; the stopping rule is the JAX package's exactly
(iterate while ``r.r > tol^2 * max(b.b, 1e-300)`` and ``k <
max_iterations``, compared in the vector dtype; per column in the
batched solver; BiCGSTAB also stops at a rho or omega breakdown),
checked with one host sync per iteration, so iteration counts compare
one to one with the JAX solvers.  As there, the dots run over every
element (``jnp.vdot``), so a matvec over the sharded paths' stacked
(P, R) vectors (``parallel``) runs unchanged.  Over a process mesh
(``parallel.global_mesh``) a rank holds only its shards' rows: every
solver then reduces each dot locally and sums it over the ranks
(``parallel.comm.all_reduce_sum``), where JAX gets its ``psum`` from
global arrays; without a process mesh every call keeps its bits.  The
mesh is the one the sharded closure carries (``matvec.mesh``), or
``mesh=`` for a closure that carries none; a ``mesh=`` that differs from
the closure's raises.  The all-reduce leaves the same value on every
rank, so every branch on a dot (the stopping rule, a breakdown) goes the
same way on every rank.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from spmv_tpu_torch.ops.dia_kernels import dia_spmm_core, dia_spmv_core
from spmv_tpu_torch.ops.dispatch import spmv

__all__ = [
    "CgResult",
    "BatchedCgResult",
    "conjugate_gradient",
    "batched_conjugate_gradient",
    "dia_batched_conjugate_gradient",
    "preconditioned_conjugate_gradient",
    "bicgstab",
    "dia_conjugate_gradient",
    "jacobi_preconditioner",
    "extract_diagonal",
]


class CgResult(NamedTuple):
    x: torch.Tensor
    residual_norm: torch.Tensor   # 0-d, sqrt of the final r.r
    iterations: int


class BatchedCgResult(NamedTuple):
    x: torch.Tensor               # (n, k)
    residual_norm: torch.Tensor   # (k,), sqrt of each column's final r.r
    iterations: torch.Tensor      # (k,) int32, each column's own count


def _reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed over the ranks of a process mesh; ``t`` itself
    without one."""
    if mesh is None or mesh.group is None:
        return t
    # imported here: ``parallel`` imports ``ops``
    from spmv_tpu_torch.parallel.comm import all_reduce_sum

    return all_reduce_sum(t, mesh)


def _solver_mesh(fn, mesh, what: str):
    """The mesh ``what`` reduces its dots over: the one the sharded
    closure ``fn`` carries (``fn.mesh``), else ``mesh``.  A ``mesh``
    passed beside a closure that carries another raises."""
    held = getattr(fn, "mesh", None)
    if held is None:
        return mesh
    if mesh is not None and mesh != held:
        from spmv_tpu_torch.parallel.mesh import MeshError

        raise MeshError(
            f"{what} was passed mesh= other than the mesh its closure runs "
            "on; drop mesh=, the closure's is the one its dots reduce over")
    return held


def _vdot(a: torch.Tensor, b: torch.Tensor, mesh=None) -> torch.Tensor:
    """<a, b> over every element, as ``jnp.vdot`` (real): 1-D vectors
    and the sharded paths' stacked (P, R) layouts alike, summed over the
    ranks of a process ``mesh``."""
    return _reduce(torch.dot(a.reshape(-1), b.reshape(-1)), mesh)


def _tol2(b: torch.Tensor, tol: float, b_norm2=None,
          mesh=None) -> torch.Tensor:
    if b_norm2 is None:
        b_norm2 = _vdot(b, b, mesh)
    b_norm2 = torch.clamp(b_norm2, min=1e-300)
    return torch.tensor(tol, dtype=b.dtype, device=b.device) ** 2 * b_norm2


def _np_type(dtype: torch.dtype):
    """The numpy scalar type of a torch dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype.type


def _eps(dtype: torch.dtype):
    """The breakdown threshold of the JAX solvers, ``finfo(dtype).tiny *
    1e4`` in the dtype, as a numpy scalar."""
    t = _np_type(dtype)
    return t(np.finfo(t).tiny * t(1e4))


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
    mesh=None,
) -> CgResult:
    """Unpreconditioned CG for SPD systems.

    ``recompute_every=k`` (k > 0) replaces the recurrence residual with
    the true residual ``b - A x`` every k iterations, keeping the search
    direction (see the JAX function for the measured reasons).
    ``mesh``: the process mesh a sharded ``matvec`` runs on, across
    whose ranks the dots are summed.
    """
    return preconditioned_conjugate_gradient(
        matvec, b, None, x0=x0, tol=tol, max_iterations=max_iterations,
        recompute_every=recompute_every, mesh=mesh)


def preconditioned_conjugate_gradient(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    preconditioner: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor = None,
    tol: float = 1e-8,
    max_iterations: int = 1000,
    recompute_every: int = 0,
    mesh=None,
) -> CgResult:
    """PCG with an SPD ``preconditioner`` (M^-1 applied to a vector), or
    plain CG when it is None.  Convergence is tested on ||r||.
    ``mesh``: as ``conjugate_gradient``'s."""
    _check_recompute(recompute_every)
    mesh = _solver_mesh(matvec, mesh, "CG")
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - matvec(x)
    z = preconditioner(r) if preconditioner is not None else r
    p = z.clone()
    rz = _vdot(r, z, mesh)
    rr = _vdot(r, r, mesh) if preconditioner is not None else rz
    tol2 = _tol2(b, tol, mesh=mesh)
    k = 0
    while k < max_iterations and bool(rr > tol2):
        ap = matvec(p)
        alpha = rz / _vdot(p, ap, mesh)
        x = x + alpha * p
        r = r - alpha * ap
        if recompute_every and (k + 1) % recompute_every == 0:
            r = b - matvec(x)
        z = preconditioner(r) if preconditioner is not None else r
        rz_new = _vdot(r, z, mesh)
        rr = _vdot(r, r, mesh) if preconditioner is not None else rz_new
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return CgResult(x=x, residual_norm=torch.sqrt(rr), iterations=k)


def bicgstab(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] = None,
    x0: torch.Tensor = None,
    tol: float = 1e-8,
    max_iterations: int = 1000,
    mesh=None,
) -> CgResult:
    """BiCGSTAB for general (non-symmetric) systems (van der Vorst 1992).

    Right-preconditioned, as the JAX function: ``preconditioner`` (M^-1,
    e.g. ``ops.incomplete.ilu0_preconditioner``) is applied to the
    search directions, so the residual tested is the true residual of
    A x = b.  The loop runs while ``r.r > tol2``, the last iteration saw
    no breakdown (``|rho|`` and ``|omega|`` at least ``eps =
    finfo(dtype).tiny * 1e4``) and ``k < max_iterations``; a breakdown
    keeps the iterate.  ``mesh``: as ``conjugate_gradient``'s.
    """
    mesh = _solver_mesh(matvec, mesh, "BiCGSTAB")
    if preconditioner is None:
        def preconditioner(v):
            return v
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - matvec(x)
    rhat = r
    tol2 = _tol2(b, tol, mesh=mesh)
    eps = torch.tensor(_eps(b.dtype), device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho_prev = alpha_prev = omega_prev = one
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rr = _vdot(r, r, mesh)
    go = rr > tol2
    k = 0
    while k < max_iterations and bool(go):
        rho = _vdot(rhat, r, mesh)
        beta = (rho / _safe(rho_prev, eps)) * (alpha_prev /
                                               _safe(omega_prev, eps))
        p = r + beta * (p - omega_prev * v)
        ph = preconditioner(p)
        v = matvec(ph)
        alpha = rho / _safe(_vdot(rhat, v, mesh), eps)
        s = r - alpha * v
        sh = preconditioner(s)
        t = matvec(sh)
        omega = _vdot(t, s, mesh) / _safe(_vdot(t, t, mesh), eps)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rr = _vdot(r, r, mesh)
        # breakdown (rho or omega ~ 0): stop iterating, keep the iterate
        go = (rr > tol2) & (rho.abs() >= eps) & (omega.abs() >= eps)
        rho_prev, alpha_prev, omega_prev = rho, alpha, omega
        k += 1
    return CgResult(x=x, residual_norm=torch.sqrt(rr), iterations=k)


def _safe(v: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Divide-safe denominator: keep magnitude >= eps, keep sign."""
    mag = torch.maximum(v.abs(), eps)
    return torch.where(v < 0, -mag, mag)


def _colsum(v: torch.Tensor, w: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-column <v, w>: the sum over every axis but the column axis
    (axis 1), as in the JAX package, so it takes the (n, k) layout and
    the sharded DIA block's stacked (P, k, Rb) alike; summed over the
    ranks of a process ``mesh``."""
    return _reduce(
        (v * w).sum(dim=tuple(i for i in range(v.dim()) if i != 1)), mesh)


def _bcast_cols(a: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-column scalars (k,) shaped to broadcast along axis 1 of an
    ndim-dimensional block."""
    shape = [1] * ndim
    shape[1] = -1
    return a.reshape(shape)


def batched_conjugate_gradient(
    matmat: Callable[[torch.Tensor], torch.Tensor],
    B: torch.Tensor,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] = None,
    tol: float = 1e-8,
    max_iterations: int = 1000,
    recompute_every: int = 0,
    mesh=None,
) -> BatchedCgResult:
    """Multi-RHS CG: k independent per-column recurrences sharing one
    SpMM (``matmat``) per iteration, for B of shape (n, k), from X = 0.
    The columns lie on axis 1 and every other axis is summed, as in the
    JAX function, so the sharded DIA block's stacked (P, k, Rb) layout
    (``parallel.make_sharded_dia_matmat``) runs unchanged.

    As the JAX function: each column carries its own alpha and beta and
    converges on its own relative residual; a converged column freezes
    (its alpha and beta are forced to 0) while the rest iterate, so the
    result equals k separate CG runs up to rounding order.
    ``preconditioner`` (optional) applies an SPD M^-1 column-wise.
    ``recompute_every=k`` (k > 0) replaces R with B - A X on all
    columns every k iterations; a frozen column whose true residual is
    above tolerance reactivates, its search direction restarted.  The
    loop runs while any column is active and fewer than
    ``max_iterations`` iterations have run.  ``mesh``: as
    ``conjugate_gradient``'s.
    """
    _check_recompute(recompute_every)
    mesh = _solver_mesh(matmat, mesh, "batched CG")
    X = torch.zeros_like(B)
    R = B.clone()
    Z = preconditioner(R) if preconditioner is not None else R
    P = Z.clone()
    rz = _colsum(R, Z, mesh)
    rr = _colsum(R, R, mesh) if preconditioner is not None else rz
    tol2 = _tol2(B, tol, _colsum(B, B, mesh))
    iters = torch.zeros(B.shape[1], dtype=torch.int32, device=B.device)
    k = 0
    while k < max_iterations:
        active = rr > tol2
        if not bool(active.any()):
            break
        AP = matmat(P)
        pap = _colsum(P, AP, mesh)
        one = torch.ones_like(pap)
        alpha = _bcast_cols(torch.where(
            active, rz / torch.where(active, pap, one), 0.0), B.dim())
        X = X + alpha * P
        R = R - alpha * AP
        if recompute_every and (k + 1) % recompute_every == 0:
            R = B - matmat(X)
        Z = preconditioner(R) if preconditioner is not None else R
        rz_new = _colsum(R, Z, mesh)
        rr = _colsum(R, R, mesh) if preconditioner is not None else rz_new
        beta = torch.where(active, rz_new / torch.where(active, rz, one),
                           0.0)
        P = Z + _bcast_cols(beta, B.dim()) * P
        rz = rz_new
        iters += active.to(torch.int32)
        k += 1
    return BatchedCgResult(x=X, residual_norm=torch.sqrt(rr),
                           iterations=iters)


def dia_batched_conjugate_gradient(
    A,
    B: torch.Tensor,
    tol: float = 1e-8,
    max_iterations: int = 1000,
    jacobi_diag=None,
    recompute_every: int = 0,
) -> BatchedCgResult:
    """Multi-RHS CG specialised to a ``DeviceDia`` operator: one SpMM
    over all k columns of B (num_rows, k) per iteration, through
    ``dia_spmm_core`` into one preallocated buffer: K2 on a CUDA tensor,
    its plain version on a CPU tensor.  The JAX function's padded Pallas
    layout (``dia_prepare_X`` / ``dia_extract_Y``) is not carried: K2
    takes (n, k) as it is.  ``jacobi_diag`` (optional, length num_rows)
    switches to Jacobi-preconditioned CG.
    """
    if A.num_rows != A.num_columns:
        raise ValueError("dia_batched_conjugate_gradient requires a "
                         "square matrix")
    if B.dim() != 2:
        raise ValueError(f"B must be (num_rows, k); got {tuple(B.shape)}")
    B = B.to(A.data.dtype).contiguous()
    precond = None
    if jacobi_diag is not None:
        inv = _jacobi_inverse(torch.as_tensor(
            jacobi_diag, dtype=B.dtype, device=B.device))[:, None]

        def precond(R):
            return R * inv
    ap = torch.empty_like(B)

    def matmat(V):
        # A P is used up before the next call overwrites the buffer
        return dia_spmm_core(A, V, out=ap)

    return batched_conjugate_gradient(
        matmat, B, preconditioner=precond, tol=tol,
        max_iterations=max_iterations, recompute_every=recompute_every)


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

"""Restarted GMRES, Chebyshev iteration and Lanczos spectral bounds.

The port's counterpart of ``spmv_tpu/ops/krylov.py``.  The JAX functions
are single fixed-shape ``lax.while_loop``s; here the loops run eagerly,
with the JAX package's stopping rules compared in the vector dtype, so
iteration counts compare one to one:

- **GMRES(m)** keeps its Krylov basis as one dense ``(m + 1, n)``
  tensor and orthogonalises by classical Gram-Schmidt with one
  reorthogonalisation pass (CGS2): two products with the basis a pass.
  The JAX function masks rows past j and always runs ``restart`` inner
  steps, turning converged ones into no-ops; here the passes take rows
  ``0..j`` only (the rows past j are zero, so only the order of the sums
  differs) and the inner loop stops at the step that converges, so
  ``iterations`` counts exactly the steps the JAX function counts.  The
  small Hessenberg column, its Givens rotations and the residual
  estimate are taken on the host in the vector dtype (one host sync a
  step, which the convergence test needs anyway); the m x m triangular
  solve is ``torch.linalg.solve_triangular`` (the JAX function's
  ``solve_triangular`` runs outside any Pallas kernel too).
- **Chebyshev iteration** (Saad, Algorithm 12.1) needs no inner product
  in its loop; its scalar recurrence (rho) does not depend on the
  vectors, so it is taken on the host in the vector dtype.  The true
  residual is tested every ``check_every`` iterations, so iteration
  counts are multiples of it.
- **lanczos_bounds** runs ``num_steps`` Lanczos steps with full
  reorthogonalisation from ``np.random.default_rng(seed)``'s start, the
  JAX function's, and widens the Ritz extremes on the host.

Every dot runs over every element (``ops.solvers._vdot``, JAX's
``vdot``) and the basis products over the flattened vectors, so the
sharded paths' stacked (P, R) vectors go through as 1-D ones do, whose
results keep their bits.  Over a process mesh (the closure's, as the CG
solvers take it) a rank holds its shards' rows: every dot and every
basis product is summed over the ranks (``ops.solvers._reduce``), so
the small host algebra (Hessenberg, rotations, tridiagonal) runs on the
same numbers, and takes the same branches, on every rank.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from spmv_tpu_torch.models.device import resolve_device
from spmv_tpu_torch.ops.solvers import (
    CgResult,
    _eps,
    _np_type,
    _reduce,
    _solver_mesh,
    _tol2,
    _vdot,
)

__all__ = ["gmres", "chebyshev", "lanczos_bounds"]


def gmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] = None,
    x0: torch.Tensor = None,
    tol: float = 1e-8,
    restart: int = 32,
    max_iterations: int = 1000,
    mesh=None,
) -> CgResult:
    """Right-preconditioned restarted GMRES for general systems.

    Saad & Schultz 1986 GMRES(m).  Right preconditioning solves
    ``A M^-1 u = b`` with ``x = M^-1 u``, so the residual driving the
    stopping test is the true residual of ``A x = b`` and any
    preconditioner of ``ops.incomplete`` plugs in unchanged.  The outer
    loop runs while ``r.r > tol2`` and fewer than ``max_iterations``
    inner steps have run; a restart cycle stops at the step whose
    residual estimate ``|g[j+1]|`` reaches ``sqrt(tol2)``, and takes no
    step when its starting residual is at most ``eps``.  The basis costs
    ``(restart + 1) * n`` values.  ``mesh``: the process mesh a sharded
    ``matvec`` runs on, across whose ranks the dots and basis products
    are summed.
    """
    mesh = _solver_mesh(matvec, mesh, "GMRES")
    if preconditioner is None:
        def preconditioner(v):
            return v
    m = int(restart)
    if m < 1:
        raise ValueError("restart must be >= 1")
    dtype, dev = b.dtype, b.device
    nd = _np_type(dtype)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    tol2 = _tol2(b, tol, mesh=mesh)
    tol_abs = nd(np.sqrt(tol2.cpu().numpy()))
    eps = _eps(dtype)
    V = torch.zeros((m + 1,) + tuple(b.shape), dtype=dtype, device=dev)

    r = b - matvec(x)
    rr = _vdot(r, r, mesh)
    k = 0
    while bool(rr > tol2) and k < max_iterations:
        beta_t = torch.sqrt(_vdot(r, r, mesh))
        beta = nd(beta_t.item())
        V.zero_()
        V[0] = r / (beta_t if beta > eps else 1.0)
        # unused columns of R stay identity so the triangular solve is
        # non-singular and yields y = 0 there
        R = np.eye(m, dtype=nd)
        g = np.zeros(m + 1, dtype=nd)
        g[0] = beta
        cs = np.zeros(m, dtype=nd)
        sn = np.zeros(m, dtype=nd)
        steps = 0
        done = beta <= eps
        for j in range(m):
            if done:
                break
            w = matvec(preconditioner(V[j]))
            # CGS2 against rows 0..j (the rows past j are zero)
            Vj = V[: j + 1].reshape(j + 1, -1)
            h1 = _reduce(Vj @ w.reshape(-1), mesh)
            w = w - (h1 @ Vj).reshape(w.shape)
            h2 = _reduce(Vj @ w.reshape(-1), mesh)
            w = w - (h2 @ Vj).reshape(w.shape)
            hn_t = torch.sqrt(_vdot(w, w, mesh))
            hv = torch.cat([h1 + h2, hn_t.reshape(1)]).cpu().numpy()
            h = np.zeros(m + 1, dtype=nd)
            h[: j + 1] = hv[: j + 1]
            hn = hv[j + 1]
            # lucky breakdown (Krylov space exhausted): the next basis
            # row stays zero and h[j+1] = 0
            grew = hn > eps
            if grew:
                V[j + 1] = w / hn_t
                h[j + 1] = hn
            # the earlier rotations, in order
            for i in range(j):
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                hip = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i], h[i + 1] = hi, hip
            # the new rotation, zeroing h[j+1]
            denom = np.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            if denom > eps:
                c, s = h[j] / denom, h[j + 1] / denom
            else:
                c, s = nd(1), nd(0)
            h[j] = c * h[j] + s * h[j + 1]
            h[j + 1] = 0
            R[:, j] = h[:m]
            gj = g[j]
            g[j] = c * gj
            g[j + 1] = -s * gj
            cs[j], sn[j] = c, s
            done = abs(g[j + 1]) <= tol_abs
            steps += 1
        # R y = g over the produced columns; frozen steps give y = 0
        g_solve = np.where(np.arange(m) < steps, g[:m], 0).astype(nd)
        y = torch.linalg.solve_triangular(
            torch.from_numpy(R), torch.from_numpy(g_solve)[:, None],
            upper=True)[:, 0]
        x = x + preconditioner((y.to(dev) @ V[:m].reshape(m, -1))
                               .reshape(b.shape))
        r = b - matvec(x)
        rr = _vdot(r, r, mesh)
        k += steps
    return CgResult(x=x, residual_norm=torch.sqrt(rr), iterations=k)


def chebyshev(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    lambda_min: float,
    lambda_max: float,
    x0: torch.Tensor = None,
    tol: float = 1e-8,
    max_iterations: int = 1000,
    check_every: int = 20,
    mesh=None,
) -> CgResult:
    """Chebyshev iteration for SPD systems with known spectral bounds.

    Saad, Iterative Methods 2nd ed., Algorithm 12.1: one SpMV and three
    axpys an iteration and no inner product.  ``0 < lambda_min <=
    lambda_max`` must enclose A's spectrum (``lanczos_bounds``); bounds
    that clip it diverge.  With ``lambda_min == lambda_max`` it is
    Richardson with the exact step 1/theta.  Convergence is tested on the
    true residual once every ``check_every`` iterations.  ``mesh``: as
    ``gmres``'s (only that test's dot is reduced).
    """
    mesh = _solver_mesh(matvec, mesh, "Chebyshev")
    lo = float(lambda_min)
    hi = float(lambda_max)
    if not (0 < lo <= hi):
        raise ValueError("chebyshev needs 0 < lambda_min <= lambda_max"
                         f", got [{lambda_min}, {lambda_max}]")
    nd = _np_type(b.dtype)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    theta = nd((hi + lo) / 2.0)
    delta = nd((hi - lo) / 2.0)
    tol2 = _tol2(b, tol, mesh=mesh)
    # sigma in Saad 12.1; delta = 0 (one eigenvalue) degenerates to
    # Richardson with the exact step 1/theta
    richardson = not delta > 0
    sigma1 = nd(np.inf) if richardson else theta / delta
    check = max(1, int(check_every))

    r = b - matvec(x)
    p = r / float(theta)
    rho = nd(0) if richardson else nd(1) / sigma1
    rr = _vdot(r, r, mesh)
    k = 0
    while bool(rr > tol2) and k < max_iterations:
        for _ in range(check):
            x = x + p
            r = r - matvec(p)
            rho_new = nd(0) if richardson else nd(1) / (nd(2) * sigma1 - rho)
            scale = (nd(1) / theta if richardson
                     else nd(2) * rho_new / delta)
            p = float(rho_new * rho) * p + float(scale) * r
            rho = rho_new
        rr = _vdot(r, r, mesh)
        k += check
    return CgResult(x=x, residual_norm=torch.sqrt(rr), iterations=k)


def _lanczos_tridiag(matvec, v0: torch.Tensor, num_steps: int, mesh=None):
    """num_steps of Lanczos with full reorthogonalisation (CGS2 against
    the whole basis, as in ``gmres``): the (alpha, beta) of the
    tridiagonal, beta of length num_steps - 1; dots and basis products
    summed over the ranks of a process ``mesh``."""
    m = num_steps
    V = torch.zeros((m + 1,) + tuple(v0.shape), dtype=v0.dtype,
                    device=v0.device)
    V[0] = v0 / torch.sqrt(_vdot(v0, v0, mesh))
    alpha = torch.zeros(m, dtype=v0.dtype, device=v0.device)
    beta = torch.zeros(m, dtype=v0.dtype, device=v0.device)
    for j in range(m):
        w = matvec(V[j])
        alpha[j] = _vdot(V[j], w, mesh)
        Vj = V[: j + 1].reshape(j + 1, -1)
        w = w - (_reduce(Vj @ w.reshape(-1), mesh) @ Vj).reshape(w.shape)
        w = w - (_reduce(Vj @ w.reshape(-1), mesh) @ Vj).reshape(w.shape)
        bnew = torch.sqrt(_vdot(w, w, mesh))
        V[j + 1] = torch.where(bnew > 0, w / torch.where(bnew > 0, bnew, 1.0),
                               0.0)
        beta[j] = bnew
    return alpha, beta[: m - 1]


def lanczos_bounds(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    n,
    num_steps: int = 30,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    safety: float = 0.05,
    v0: torch.Tensor = None,
    device=None,
    mesh=None,
) -> tuple[float, float]:
    """Estimate ``(lambda_min, lambda_max)`` bounds for an SPD operator.

    ``n`` is the operand length (or shape).  Runs ``num_steps`` of
    Lanczos from ``np.random.default_rng(seed).standard_normal(n)`` (the
    JAX function's start) or from ``v0``, on ``device``
    (``default_device()`` when None), takes the Ritz extremes of the tridiagonal on the host and
    widens them multiplicatively by ``safety`` (Ritz values lie inside
    the spectrum, and ``chebyshev`` diverges on bounds that clip it).
    The returned floor is clamped positive.  Over a process ``mesh`` (as
    ``gmres``'s) ``n`` is the global stacked shape (P, R, ...): every
    rank draws the whole start and keeps its own shards' rows, and a
    ``v0`` passed in is the rank's rows; the bounds are the same on
    every rank.
    """
    mesh = _solver_mesh(matvec, mesh, "lanczos_bounds")
    if mesh is not None and device is None:
        device = mesh.device
    if v0 is None:
        v0 = np.random.default_rng(seed).standard_normal(n)
        if mesh is not None and mesh.group is not None:
            if v0.ndim < 2 or v0.shape[0] != mesh.size:
                raise ValueError(
                    f"lanczos_bounds over a process mesh of {mesh.size} "
                    f"shards draws the global stacked shape; got n={n}")
            v0 = v0[mesh.local_shards.start: mesh.local_shards.stop]
        v0 = torch.from_numpy(v0)
    v0 = torch.as_tensor(v0).to(device=resolve_device(device), dtype=dtype)
    alpha, beta = _lanczos_tridiag(matvec, v0, int(num_steps), mesh)
    a = alpha.cpu().double().numpy()
    bb = beta.cpu().double().numpy()
    T = np.diag(a) + np.diag(bb, 1) + np.diag(bb, -1)
    ritz = np.linalg.eigvalsh(T)
    lo, hi = float(ritz[0]), float(ritz[-1])
    # multiplicative widening: for stiff operators lambda_min can be
    # orders of magnitude below the spread, so an additive widening
    # would push the floor through zero
    lo *= (1.0 - safety)
    hi *= (1.0 + safety)
    return max(lo, 1e-30), max(hi, 1e-30)

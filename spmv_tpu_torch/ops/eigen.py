"""Block eigensolver: LOBPCG for symmetric positive definite operators.

The port's copy of ``spmv_tpu/ops/eigen.py``: block LOBPCG (Knyazev
2001), whose iteration costs one ``matmat`` (a block SpMM over k
columns, the port's hand-written SpMM kernel of the matrix's format on
the card) on the residual block W, one preconditioner apply on the
(n, k) block where one is given, tall-skinny dense algebra on the
(n, 3k) basis S = [X, W, P], and the Rayleigh-Ritz step on (3k, 3k)
matrices.  The arithmetic is the JAX function's, step for step: the
per-column normalisation of W and P, the Gram-eigh orthonormalisation
with its masked directions and their spectrum-scaled penalty,
``coeff = Vinv @ C[:, :k]`` polished by three Newton-Schulz steps, P
from ``coeff`` with its first k rows zeroed, A S tracked by the same
recurrences, the JAX ``cond`` as the stopping rule, and the block's
Rayleigh quotients and residual norms sorted by ``largest``.

Where it differs from the JAX function:

- **An eager loop.**  The JAX loop is one ``lax.while_loop`` on the
  device; here the loop runs in Python with one host read of the
  residual norms (and the Rayleigh quotients the rule scales them by) an
  iteration, as the port's GMRES and Chebyshev do.
- **The Rayleigh-Ritz step on the host.**  S^T [S, AS] is one product on
  the device; its (3k, 6k) result is copied to the host once, where the
  (3k, 3k) algebra (two ``torch.linalg.eigh``, LAPACK, in the working
  dtype, and the small products) runs, and the (3k, 2k) coefficients go
  back.  The JAX package's cyclic-Jacobi ``eigh`` exists for the TPU's
  float32 ``eigh`` and is not carried over.  ``chip_smoke.py`` phase 29
  times the step on the host and on the card (cuSOLVER) at k = 8.
- **The random P.**  The JAX function draws P from
  ``jax.random.PRNGKey(0)``; here it comes from ``generator`` (a
  ``torch.Generator`` seeded 0 when None) on X0's device, or from
  ``P0``, which lets the tests pass JAX's own draw.

Over a process mesh (the closure's, as the CG solvers take it) a rank holds
its shards' rows of every (n, k) block.  The Gram products and every
per-column dot are summed over the ranks (``ops.solvers._reduce``), so
the Rayleigh-Ritz step, the dropped Gram directions and the stopping
rule read the same numbers on every rank and no rank branches alone;
the random P is the rank's rows of the global (n, k) draw.

The solver's own contractions run in true float32 for float32 operands:
``_mmh`` sets PyTorch's float32 matmul precision to ``"ieee"`` (no TF32
on CUDA, no bfloat16 passes in oneDNN) around each product and restores
what was set before, so a switch flipped elsewhere in the process does
not reach them.  ``matmat`` and ``preconditioner`` keep the caller's
policy, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, NamedTuple

import torch

from spmv_tpu_torch.models.device import default_device
from spmv_tpu_torch.ops.dispatch import spmm
from spmv_tpu_torch.ops.solvers import _reduce, _solver_mesh

__all__ = ["lobpcg", "dia_eigsh", "EigResult"]


@contextlib.contextmanager
def _ieee_fp32():
    """float32 products in float32 for the duration, whatever the
    process-wide switches say; they are restored on exit."""
    flags = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)
    old = [f.fp32_precision for f in flags]
    for f in flags:
        f.fp32_precision = "ieee"
    try:
        yield
    finally:
        for f, o in zip(flags, old):
            f.fp32_precision = o


def _mmh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with _ieee_fp32():
        return a @ b


def _coldot(a: torch.Tensor, b: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-column <a_j, b_j>: elementwise products and a column sum, no
    matmul; summed over the ranks of a process ``mesh``."""
    return _reduce((a * b).sum(0), mesh)


class EigResult(NamedTuple):
    eigenvalues: torch.Tensor       # (k,)
    eigenvectors: torch.Tensor      # (n, k), orthonormal columns
    residual_norms: torch.Tensor    # (k,) ||A v - theta v||
    iterations: int


def _small_eigh(H: torch.Tensor):
    """Symmetric eigh of a small matrix: ``torch.linalg.eigh`` in H's
    dtype, ascending, of (H + H^T) / 2, as ``jnp.linalg.eigh`` takes it
    (``symmetrize_input``)."""
    return torch.linalg.eigh((H + H.T) / 2)


def _ortho_coeffs(G: torch.Tensor, eps: float):
    """Inverse-sqrt coefficients for a Gram matrix, masking the
    degenerate directions.  Returns (Vinv (m, m), mask (m,))."""
    w, V = _small_eigh(G)
    wmax = torch.clamp(w[-1], min=1e-30)
    mask = w > eps * wmax
    inv_sqrt = torch.where(mask, 1.0 / torch.sqrt(torch.where(mask, w, 1.0)),
                           0.0)
    return V * inv_sqrt[None, :], mask


def _rayleigh_ritz(G: torch.Tensor, SAS: torch.Tensor, k: int, sign: float,
                   gram_eps: float) -> torch.Tensor:
    """The (3k, k) coefficients of the new block in the S basis, from
    G = S^T S and SAS = S^T A S: the JAX body's small algebra."""
    Vinv, mask = _ortho_coeffs(G, gram_eps)
    H = (Vinv.T @ SAS) @ Vinv
    H = 0.5 * (H + H.T)
    # Degenerate directions sort away from the selected end, with a
    # penalty scaled to the spectrum (2 ||H||_F >= 2 ||H||_2): an
    # absolute constant would spoil eigh's accuracy for every other
    # eigenvalue, its error being relative to ||H||.
    pen = 2.0 * torch.sqrt(torch.sum(H * H)) + 1.0
    H = H + torch.diag(torch.where(mask, 0.0, sign * pen))
    # ascending with the sign applied: the first k columns are the
    # wanted end (the Ritz values are recomputed as Rayleigh quotients)
    _, C = _small_eigh(sign * H)
    coeff = Vinv @ C[:, :k]
    # polish against the metric G with a Newton-Schulz inverse square
    # root of M = coeff^T G coeff, which is near I
    M = (coeff.T @ G) @ coeff
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    T = eye
    for _ in range(3):
        T = 0.5 * (T @ (3.0 * eye - M @ (T @ T)))
    return coeff @ T


def _unconverged(theta: torch.Tensor, res: torch.Tensor, tol: float) -> bool:
    """The JAX ``cond`` less its iteration cap: any residual above tol
    times the block's spectral scale max(max |theta|, 1), in the dtype,
    read on the host in one copy."""
    th, rs = torch.stack([theta, res]).cpu()
    scale = torch.clamp(th.abs().max(), min=1.0)
    return bool((rs > tol * scale).any())


def lobpcg(
    matmat: Callable[[torch.Tensor], torch.Tensor],
    X0,
    preconditioner: Callable[[torch.Tensor], torch.Tensor] = None,
    largest: bool = False,
    tol: float = 1e-6,
    max_iterations: int = 200,
    gram_eps: float = None,
    mask=None,
    P0=None,
    generator: torch.Generator = None,
    mesh=None,
) -> EigResult:
    """k extreme eigenpairs of the SPD operator behind ``matmat``.

    ``X0`` is the (n, k) starting block; a tensor stays on its device,
    anything else goes to ``default_device()``.
    ``largest`` selects the top instead of the bottom of the spectrum.
    Convergence: every column satisfies ``||A v - theta v|| <= tol *
    max(max_j |theta_j|, 1)``, scaled by the block's largest Rayleigh
    quotient because the attainable residual floor of the Gram-based
    basis scales with ``||A||``.  ``mask`` (n,) of 0/1 confines the basis
    to the real rows of a padded layout, so that the operator's padding
    null space gives no spurious zero eigenvalue.  The random start of P
    is ``P0`` when given, else a draw from ``generator`` (seeded 0 when
    None).  ``gram_eps`` (default ``1e3 * eps(dtype)``) is the relative
    Gram eigenvalue below which a basis direction is dropped: a fixed
    small value would keep numerically degenerate directions in
    float32.  ``mesh``: the process mesh a sharded ``matmat`` runs on;
    ``X0``, ``mask`` and ``P0`` are then the rank's rows (every rank as
    many), n is the global row count and the eigenvectors come back as
    the rank's rows.
    """
    mesh = _solver_mesh(matmat, mesh, "LOBPCG")
    dev = X0.device if isinstance(X0, torch.Tensor) else default_device()
    X0 = torch.as_tensor(X0, device=dev)
    n_local, k = X0.shape
    ranks = 1 if mesh is None or mesh.group is None else mesh.world_size
    n = n_local * ranks
    dtype = X0.dtype
    # the (n, 3k) trial basis has full column rank only when 3k <= n;
    # below that the masking drops the degenerate directions
    if k > n:
        raise ValueError(f"lobpcg needs k <= n; got k={k}, n={n}")
    if 3 * k > n:
        warnings.warn(
            f"lobpcg trial basis (n={n}, 3k={3*k}) is rank-deficient; "
            "fine for toy sizes, but prefer 3*k <= n", stacklevel=2)
    if gram_eps is None:
        gram_eps = torch.finfo(dtype).eps * 1e3
    sign = -1.0 if largest else 1.0
    row_mask = None
    if mask is not None:
        row_mask = torch.as_tensor(mask, dtype=dtype,
                                   device=dev).reshape(-1, 1)
        X0 = X0 * row_mask
    if P0 is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        P = torch.randn((n, k), generator=generator, dtype=dtype, device=dev)
        if ranks > 1:
            P = P[mesh.rank * n_local: (mesh.rank + 1) * n_local]
    else:
        P = torch.as_tensor(P0, dtype=dtype, device=dev)
    if row_mask is not None:
        P = P * row_mask

    cX, _ = _ortho_coeffs(_reduce(_mmh(X0.T, X0), mesh).cpu(), gram_eps)
    X = _mmh(X0, cX.to(dev))
    AX = matmat(X)
    AP = matmat(P)
    theta = _coldot(X, AX, mesh)
    R = AX - X * theta[None, :]
    res = None                      # the JAX res0 = inf: one step runs
    it = 0
    while it < max_iterations and (res is None
                                   or _unconverged(theta, res, tol)):
        W = preconditioner(R) if preconditioner is not None else R
        if row_mask is not None:
            W = W * row_mask
        # per-column normalisation of W and P conditions the Gram matrix
        # (their scales shrink toward zero as the iteration converges)
        W = W / torch.clamp(torch.sqrt(_coldot(W, W, mesh)),
                            min=1e-30)[None, :]
        AW = matmat(W)
        Ps = torch.clamp(torch.sqrt(_coldot(P, P, mesh)), min=1e-30)[None, :]
        B = torch.cat([X, W, P / Ps, AX, AW, AP / Ps], dim=1)  # [S, AS]
        S, AS = B[:, :3 * k], B[:, 3 * k:]
        GS = _reduce(_mmh(S.T, B), mesh).cpu()  # [G, S^T AS], one copy
        coeff = _rayleigh_ritz(GS[:, :3 * k], GS[:, 3 * k:], k, sign,
                               gram_eps)
        # P spans only the W / P part of the update (the three-term
        # recurrence): coeff with its first k rows zeroed
        coeff_wp = coeff.clone()
        coeff_wp[:k] = 0.0
        Cc = torch.cat([coeff, coeff_wp], dim=1).to(dev)
        XP = _mmh(S, Cc)
        AXP = _mmh(AS, Cc)
        X, P = XP[:, :k], XP[:, k:]
        AX, AP = AXP[:, :k], AXP[:, k:]
        theta = _coldot(X, AX, mesh)
        R = AX - X * theta[None, :]
        res = torch.sqrt(_coldot(R, R, mesh))
        it += 1
    # theta and R are the returned block's Rayleigh quotients and
    # residual (JAX's final pass recomputes the same values)
    res = torch.sqrt(_coldot(R, R, mesh))
    order = torch.argsort(-theta if largest else theta, stable=True)
    return EigResult(
        eigenvalues=theta[order],
        eigenvectors=X[:, order],
        residual_norms=res[order],
        iterations=it,
    )


def dia_eigsh(
    A,
    k: int = 4,
    which: str = "smallest",
    preconditioner: Callable[[torch.Tensor], torch.Tensor] = None,
    tol: float = 1e-6,
    max_iterations: int = 200,
    seed: int = 0,
    dtype: torch.dtype = None,
) -> EigResult:
    """k extreme eigenpairs of a symmetric ``DeviceDia`` operator.

    Convenience wrapper: a start block drawn from a ``torch.Generator``
    seeded ``seed`` on the matrix's device, and the SpMM (K2 on the
    card) as ``matmat``.  ``which`` is "smallest" or "largest".
    """
    if which not in ("smallest", "largest"):
        raise ValueError(
            f"which must be 'smallest' or 'largest', got {which!r}")
    if A.num_rows != A.num_columns:
        raise ValueError("dia_eigsh requires a square matrix")
    dtype = dtype or A.data.dtype
    dev = A.data.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    X0 = torch.randn((A.num_rows, k), generator=gen, dtype=dtype, device=dev)
    return lobpcg(
        lambda V: spmm(A, V), X0, preconditioner=preconditioner,
        largest=(which == "largest"), tol=tol,
        max_iterations=max_iterations,
    )

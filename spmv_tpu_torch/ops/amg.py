"""Algebraic multigrid (smoothed aggregation) preconditioning.

The port's copy of ``spmv_tpu/ops/amg.py``.

- **Setup (host, numpy), copied with the logic unchanged:** strength
  graph -> greedy aggregation (``csrc/amg.cpp`` through
  ``ops/_amg_native.py``, with the Python loop as its fallback) ->
  tentative prolongator -> Jacobi-smoothed P -> Galerkin triple product
  P^T A P, recursed until the coarse grid is dense-solvable
  (``smoothed_aggregation_setup``), and the block variant whose
  aggregates are runs of ``block`` consecutive rows
  (``block_aggregation_setup``).
- **Apply (device, torch):** a V-cycle whose smoother is a fixed-degree
  Chebyshev polynomial in D^-1 A (``_cheb_smooth``): matvecs and axpys
  only.  The coarsest level is a precomputed dense inverse, applied by
  ``torch.matmul`` (the JAX package leaves that product to XLA; it is
  no Pallas kernel).

Two layouts, as in the JAX package:

- the **generic** layout (``amg_preconditioner``): A, P and P^T are
  ``DeviceCsr`` (P and P^T rectangular), each product one launch of the
  CSR kernel (``csr_spmv_core``) on the card;
- the **block** layout (``block_amg_device``, ``block_vcycle``,
  ``block_amg_preconditioner``, ``amg_solve``): transfers are reshapes
  (restrict = sum over each run of ``block`` rows, prolong = repeat),
  the smoothed prolongator is applied as the composition
  (I - w D^-1 A) P0, and every level operator is a ``DeviceDia`` on
  kernel K1 when it has at most ``max_diagonals`` diagonals, else a
  ``DeviceCsr``.  The JAX package passed the hierarchy through ``jit``
  as a pytree argument; here ``BlockAmgDevice`` is an ``nn.Module``.

Every device entry point takes ``device=`` and defaults to
``default_device()``: the card, unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.models.csr import CsrMatrix
from spmv_tpu_torch.models.device import (
    DeviceCsr,
    DeviceDia,
    default_value_dtype,
    resolve_device,
)
from spmv_tpu_torch.models.dia import DiaMatrix
from spmv_tpu_torch.ops.dispatch import spmm, spmv
from spmv_tpu_torch.ops.solvers import (
    CgResult,
    preconditioned_conjugate_gradient,
)

__all__ = [
    "amg_preconditioner",
    "smoothed_aggregation_setup",
    "AmgHierarchy",
    "AmgLevel",
    "block_aggregation_setup",
    "block_amg_preconditioner",
    "block_amg_device",
    "block_vcycle",
    "amg_solve",
    "BlockAmgHierarchy",
    "BlockAmgLevel",
    "BlockAmgDevice",
    "BlockAmgDeviceLevel",
]


# ---------------------------------------------------------------------
# host-side sparse helpers (CSR as plain (row_ptr, cols, vals) arrays)
# ---------------------------------------------------------------------

def _csr_from_coo(n_rows, rows, cols, vals):
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    rp = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=rp[1:])
    return rp, cols.astype(np.int32), vals


def _coo_dedupe(n_rows, n_cols, rows, cols, vals):
    """Sum duplicate (row, col) entries; returns sorted COO.

    argsort + add.reduceat instead of np.unique(return_inverse): the
    expanded entries arrive nearly row-sorted, which the stable sort
    exploits.
    """
    key = rows.astype(np.int64) * n_cols + cols
    if key.size == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float64))
    order = np.argsort(key, kind="stable")
    k = key[order]
    v = vals[order]
    bnd = np.empty(k.size, np.bool_)
    bnd[0] = True
    np.not_equal(k[1:], k[:-1], out=bnd[1:])
    starts = np.flatnonzero(bnd)
    out_vals = np.add.reduceat(v, starts)
    uk = k[starts]
    return uk // n_cols, uk % n_cols, out_vals


def _spgemm(n_rows, ar, ac, av, br, bc, bv, n_cols_out):
    """C = A @ B for host CSR triples, fully vectorized.

    Expands every A entry (i, j) against B's row j (the classic
    expand/sort/compress formulation), then compresses duplicates
    with one sort: no per-row Python loop.
    """
    deg = (br[ac + 1] - br[ac]).astype(np.int64)
    total = int(deg.sum())
    if total == 0:
        return (np.zeros(n_rows + 1, np.int64),
                np.zeros(0, np.int32), np.zeros(0, np.float64))
    cum = np.cumsum(deg) - deg
    offs = np.repeat(cum, deg)
    seq = np.arange(total, dtype=np.int64) - offs
    bidx = np.repeat(br[ac], deg) + seq
    arow = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(ar))
    rows = np.repeat(arow, deg)
    cols = bc[bidx].astype(np.int64)
    vals = np.repeat(av, deg) * bv[bidx]
    rows, cols, vals = _coo_dedupe(n_rows, n_cols_out, rows, cols,
                                   vals)
    # dedupe output is already (row, col)-sorted with unique keys, so
    # build row_ptr directly instead of re-lexsorting
    rp = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=rp[1:])
    return rp, cols.astype(np.int32), vals


def _transpose(n_rows, n_cols, rp, cols, vals):
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(rp))
    return _csr_from_coo(n_cols, cols.astype(np.int64), rows, vals)


def _host_spmv_fast(rp, cols, vals, x):
    # segment sum via cumsum trick: much faster than np.add.at
    prod = np.concatenate(([0.0], np.cumsum(vals * x[cols])))
    return prod[rp[1:]] - prod[rp[:-1]]


def _extract_diag(n, rp, cols, vals):
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    d = np.zeros(n, np.float64)
    sel = rows == cols
    np.add.at(d, rows[sel], vals[sel])
    return d


def _strength_graph(n, rp, cols, vals, theta):
    """Symmetric strength-of-connection filter: keep off-diagonal
    (i, j) with |a_ij| >= theta * sqrt(|a_ii a_jj|)."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    d = np.abs(_extract_diag(n, rp, cols, vals))
    offdiag = rows != cols
    strong = offdiag & (
        np.abs(vals) >= theta * np.sqrt(d[rows] * d[cols]))
    return _csr_from_coo(n, rows[strong],
                         cols[strong].astype(np.int64), vals[strong])


def _aggregate_py(n, rp, cols):
    """Greedy aggregation over the strength graph (Vanek et al. 96).

    Pass 1 makes an aggregate of every node whose strong neighborhood
    is untouched; pass 2 attaches leftovers to an adjacent aggregate;
    pass 3 groups whatever remains (isolated from all aggregates)
    with its unassigned neighbors.  Pure-Python reference; the native
    twin (csrc/amg.cpp) mirrors it statement-for-statement.
    """
    agg = np.full(n, -1, np.int64)
    cnt = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nb = cols[rp[i]:rp[i + 1]]
        if (agg[nb] == -1).all():
            agg[i] = cnt
            agg[nb] = cnt
            cnt += 1
    attach = agg.copy()
    for i in range(n):
        if agg[i] != -1:
            continue
        nb = cols[rp[i]:rp[i + 1]]
        hit = nb[agg[nb] != -1]
        if hit.size:
            attach[i] = agg[hit[0]]
    agg = attach
    for i in range(n):
        if agg[i] != -1:
            continue
        agg[i] = cnt
        nb = cols[rp[i]:rp[i + 1]]
        agg[nb[agg[nb] == -1]] = cnt
        cnt += 1
    return agg, cnt


def _aggregate(n, rp, cols):
    from spmv_tpu_torch.ops import _amg_native

    if _amg_native.available() and n > 4096:
        return _amg_native.aggregate(rp, cols)
    return _aggregate_py(n, rp, cols)


def _lambda_max_dinv_a(n, rp, cols, vals, dinv, iters=15, seed=0):
    """Power iteration for lambda_max(D^-1 A) on the host."""
    v = np.random.default_rng(seed).standard_normal(n)
    lam = 1.0
    for _ in range(iters):
        w = dinv * _host_spmv_fast(rp, cols, vals, v)
        nw = np.linalg.norm(w)
        if nw == 0:
            return 1.0
        lam = nw / max(np.linalg.norm(v), 1e-300)
        v = w / nw
    return float(lam)


# ---------------------------------------------------------------------
# hierarchy
# ---------------------------------------------------------------------

class AmgLevel(NamedTuple):
    """One level's host arrays: A (n x n), P (n x nc), Pt (nc x n)."""
    n: int
    a: tuple                # (row_ptr, cols, vals)
    p: tuple                # (row_ptr, cols, vals) or None at coarsest
    pt: tuple
    n_coarse: int
    dinv: np.ndarray
    lambda_max: float       # of D^-1 A, for the Chebyshev smoother


@dataclasses.dataclass
class AmgHierarchy:
    levels: list            # of AmgLevel (finest first)
    coarse_inv: np.ndarray  # dense inverse of the coarsest operator
    theta: float
    omega: float

    @property
    def num_levels(self) -> int:
        return len(self.levels) + 1

    @property
    def operator_complexity(self) -> float:
        """sum(nnz over levels) / nnz(finest), the standard AMG
        grid-quality metric (the dense coarse solve counts n^2, so tiny
        problems read high)."""
        if not self.levels:
            return 1.0   # pure dense solve, no multigrid levels
        fine = len(self.levels[0].a[2])
        tot = sum(len(lv.a[2]) for lv in self.levels)
        tot += self.coarse_inv.shape[0] ** 2
        return tot / max(fine, 1)


def _as_host_csr(m):
    """(row_ptr, cols, vals) fp64 view of any host matrix exposing
    CSR arrays, a DIA layout, or MatrixMarket-style accessors."""
    if hasattr(m, "row_ptr"):
        rp = np.asarray(m.row_ptr, np.int64)
        stored = int(rp[-1])
        return (rp, np.asarray(m.column_index[:stored], np.int32),
                np.asarray(m.value[:stored], np.float64))
    if hasattr(m, "offsets") and hasattr(m, "data"):
        n, nc = m.num_rows, m.num_columns
        offs = np.asarray(m.offsets, np.int64)
        data = np.asarray(m.data, np.float64)
        rows_l, cols_l, vals_l = [], [], []
        for k, off in enumerate(offs):
            i = np.arange(max(0, -off), min(n, nc - off),
                          dtype=np.int64)
            rows_l.append(i)
            cols_l.append(i + off)
            vals_l.append(data[k, i])
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
        vals = np.concatenate(vals_l)
        keep = vals != 0.0
        return _csr_from_coo(n, rows[keep], cols[keep], vals[keep])
    if hasattr(m, "row_indices"):
        # 1-based MatrixMarket accessors (matrix-market.cpp:171)
        rows = np.asarray(m.row_indices(), np.int64) - 1
        cols = np.asarray(m.column_indices(), np.int64) - 1
        vals = np.asarray(m.values_real(), np.float64)
        r, c, v = _coo_dedupe(m.num_rows, m.num_columns, rows, cols,
                              vals)
        return _csr_from_coo(m.num_rows, r, c, v)
    raise TypeError(f"unsupported host matrix type: {type(m)!r}")


def smoothed_aggregation_setup(
    m,
    theta: float = 0.08,
    omega_scale: float = 4.0 / 3.0,
    max_levels: int = 12,
    coarse_size: int = 512,
    smooth_prolongator: bool = True,
) -> AmgHierarchy:
    """Build the SA-AMG hierarchy on the host.

    ``m`` is any square host matrix (CsrMatrix, DiaMatrix,
    MatrixMarket).  ``theta`` is the strength threshold; ``omega_scale
    / lambda_max(D^-1 A)`` is the prolongator-smoothing weight
    (omega_scale=4/3 is the SA-classic optimum for one Jacobi step).
    Coarsening stops at ``coarse_size`` rows (dense-inverted) or when
    aggregation stalls.
    """
    if m.num_rows != m.num_columns:
        raise ValueError("AMG requires a square matrix")
    rp, cols, vals = _as_host_csr(m)
    n = m.num_rows
    levels = []
    omega_used = 0.0
    for _ in range(max_levels):
        if n <= coarse_size:
            break
        srp, scols, _svals = _strength_graph(n, rp, cols, vals, theta)
        agg, n_agg = _aggregate(n, srp, scols)
        if n_agg >= n:
            break   # aggregation stalled: stop coarsening here
        dinv_d = _extract_diag(n, rp, cols, vals)
        dinv = np.where(dinv_d != 0.0, 1.0 / np.where(
            dinv_d != 0.0, dinv_d, 1.0), 1.0)
        lam = _lambda_max_dinv_a(n, rp, cols, vals, dinv)

        # tentative prolongator: one entry per row, column = aggregate,
        # normalized so P0's columns are unit vectors
        sizes = np.bincount(agg, minlength=n_agg).astype(np.float64)
        p0_rp = np.arange(n + 1, dtype=np.int64)
        p0_cols = agg.astype(np.int32)
        p0_vals = 1.0 / np.sqrt(sizes[agg])

        if smooth_prolongator:
            # P = (I - omega D^-1 A) P0
            omega_used = omega_scale / max(lam, 1e-300)
            ap_rp, ap_cols, ap_vals = _spgemm(
                n, rp, cols, vals, p0_rp, p0_cols, p0_vals, n_agg)
            ap_rows = np.repeat(np.arange(n, dtype=np.int64),
                                np.diff(ap_rp))
            rows_cat = np.concatenate([
                np.arange(n, dtype=np.int64), ap_rows])
            cols_cat = np.concatenate([
                p0_cols.astype(np.int64), ap_cols.astype(np.int64)])
            vals_cat = np.concatenate([
                p0_vals, -omega_used * dinv[ap_rows] * ap_vals])
            prow, pcol, pval = _coo_dedupe(
                n, n_agg, rows_cat, cols_cat, vals_cat)
            keep = pval != 0.0
            p_rp, p_cols, p_vals = _csr_from_coo(
                n, prow[keep], pcol[keep], pval[keep])
        else:
            p_rp, p_cols, p_vals = p0_rp, p0_cols, p0_vals

        pt_rp, pt_cols, pt_vals = _transpose(n, n_agg, p_rp, p_cols,
                                             p_vals)
        # Galerkin: Ac = Pt (A P)
        ap = _spgemm(n, rp, cols, vals, p_rp, p_cols, p_vals, n_agg)
        ac_rp, ac_cols, ac_vals = _spgemm(
            n_agg, pt_rp, pt_cols, pt_vals, *ap, n_agg)

        levels.append(AmgLevel(
            n=n, a=(rp, cols, vals), p=(p_rp, p_cols, p_vals),
            pt=(pt_rp, pt_cols, pt_vals), n_coarse=n_agg,
            dinv=dinv, lambda_max=lam))
        rp, cols, vals = ac_rp, ac_cols, ac_vals
        n = n_agg

    # coarsest: dense inverse
    dense = np.zeros((n, n))
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    dense[rows, cols] = vals
    coarse_inv = np.linalg.inv(dense)
    return AmgHierarchy(levels=levels, coarse_inv=coarse_inv,
                        theta=theta, omega=omega_used)


# ---------------------------------------------------------------------
# device apply
# ---------------------------------------------------------------------

def _device_csr(n_rows, n_cols, rp, cols, vals, dtype, device):
    host = CsrMatrix(n_rows, n_cols, len(vals), 1, rp, cols, vals)
    return DeviceCsr.from_host(host, dtype=dtype, device=device)


def _cheb_smooth(matvec, dinv, b, x, lo, hi, degree):
    """Fixed-degree Chebyshev smoother on D^-1 A: the degree is static
    and unrolled, with no convergence checks and no inner products.
    The scalars are Python floats, so each rounds once to the vectors'
    type where it meets them, as JAX's weakly typed scalars do."""
    theta = (hi + lo) / 2.0
    delta = (hi - lo) / 2.0
    sigma1 = theta / delta
    r = dinv * (b - matvec(x))
    p = r / theta
    rho = 1.0 / sigma1
    for _ in range(degree):
        x = x + p
        r = r - dinv * matvec(p)
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        p = rho_new * rho * p + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x


def amg_preconditioner(
    m=None,
    hierarchy: AmgHierarchy = None,
    dtype=None,
    smoother_degree: int = 3,
    smoother_band=(1.0 / 30.0, 1.1),
    device=None,
    **setup_kw,
):
    """Build ``M^-1 r`` = one SA-AMG V-cycle, as a closure.

    Give either a host matrix ``m`` (runs ``smoothed_aggregation_setup``
    with ``**setup_kw``) or a prebuilt ``hierarchy``.  Returns
    ``(apply, info)``, so it plugs into PCG unchanged.

    The smoother is a degree-``smoother_degree`` Chebyshev polynomial
    in D^-1 A targeting ``[band_lo * lam, band_hi * lam]`` (the
    PyAMG-standard (1/30, 1.1) band); identical pre/post smoothing
    keeps the cycle symmetric for CG.  A, P and P^T are ``DeviceCsr``
    on ``device``: each product is one CSR kernel launch on the card.

    ``apply`` takes a vector (n,) or a block (n, k): a block runs one
    V-cycle for all its columns, each product one launch of the CSR SpMM
    (the JAX CLI's ``jax.vmap`` of the vector apply, as LOBPCG's
    preconditioner).
    """
    if hierarchy is None:
        if m is None:
            raise ValueError("need a host matrix or a hierarchy")
        hierarchy = smoothed_aggregation_setup(m, **setup_kw)
    device = resolve_device(device)
    dtype = dtype or default_value_dtype()
    dev = []
    for lv in hierarchy.levels:
        a = _device_csr(lv.n, lv.n, *lv.a, dtype, device)
        p = _device_csr(lv.n, lv.n_coarse, *lv.p, dtype, device)
        pt = _device_csr(lv.n_coarse, lv.n, *lv.pt, dtype, device)
        lo = float(smoother_band[0] * lv.lambda_max)
        hi = float(smoother_band[1] * lv.lambda_max)
        dev.append((a, p, pt, torch.as_tensor(lv.dinv, dtype=dtype,
                                              device=device), lo, hi))
    coarse_inv = torch.as_tensor(hierarchy.coarse_inv, dtype=dtype,
                                 device=device)

    def vcycle(level, b):
        if level == len(dev):
            return coarse_inv @ b
        a, p, pt, dinv, lo, hi = dev[level]
        # a block (n, k) takes every product through spmm (one launch of
        # the CSR SpMM on the card) and dinv over its columns
        prod = spmv if b.dim() == 1 else spmm
        if b.dim() == 2:
            dinv = dinv[:, None]
        x = _cheb_smooth(lambda v: prod(a, v), dinv, b,
                         torch.zeros_like(b), lo, hi, smoother_degree)
        r = b - prod(a, x)
        xc = vcycle(level + 1, prod(pt, r))
        x = x + prod(p, xc)
        return _cheb_smooth(lambda v: prod(a, v), dinv, b, x, lo, hi,
                            smoother_degree)

    def apply(r):
        return vcycle(0, r)

    info = {
        "kind": "sa-amg",
        "levels": hierarchy.num_levels,
        "level_rows": [lv.n for lv in hierarchy.levels]
        + [hierarchy.coarse_inv.shape[0]],
        "operator_complexity": hierarchy.operator_complexity,
        "theta": hierarchy.theta,
        "omega": hierarchy.omega,
        "smoother": f"chebyshev(degree={smoother_degree})",
    }
    return apply, info


# ---------------------------------------------------------------------
# Block aggregation
# ---------------------------------------------------------------------
#
# - aggregates are fixed-size runs of ``block`` CONSECUTIVE rows, so
#   the tentative transfers are pure reshapes: restrict = reshape +
#   sum over the block axis, prolongate = repeat.  On a band-ordered
#   matrix consecutive rows are the locality-coupled ones.
# - the SMOOTHED prolongator P = (I - w D^-1 A) P0 is never stored on
#   the device: it is applied as a composition (one extra matvec around
#   the reshape), while the host Galerkin product uses the explicit P,
#   so the two stay consistent by construction.
# - every level operator converts to DIA when its diagonal count
#   allows (Galerkin products of banded operators stay banded), so
#   smoother matvecs run K1.

class BlockAmgLevel(NamedTuple):
    """Host arrays for one block-aggregation level (padded system)."""
    n: int                  # logical rows before padding
    n_pad: int              # padded to a multiple of block
    n_coarse: int           # n_pad // block
    block: int
    a: tuple                # padded host CSR (row_ptr, cols, vals)
    dinv: np.ndarray
    lambda_max: float
    omega: float
    smoothed: bool          # P = (I - w D^-1 A) P0 vs plain P0


@dataclasses.dataclass
class BlockAmgHierarchy:
    levels: list            # of BlockAmgLevel, finest first
    coarse_inv: np.ndarray
    block: int

    @property
    def num_levels(self) -> int:
        return len(self.levels) + 1

    @property
    def operator_complexity(self) -> float:
        if not self.levels:
            return 1.0
        fine = len(self.levels[0].a[2])
        tot = sum(len(lv.a[2]) for lv in self.levels)
        tot += self.coarse_inv.shape[0] ** 2
        return tot / max(fine, 1)


def _pad_csr_identity(n, n_pad, rp, cols, vals, diag_value):
    """Append identity rows (value diag_value) for rows n..n_pad."""
    if n_pad == n:
        return rp, cols, vals
    extra = n_pad - n
    rp2 = np.concatenate([rp, rp[-1] + 1 + np.arange(extra,
                                                     dtype=np.int64)])
    cols2 = np.concatenate([cols, np.arange(n, n_pad, dtype=np.int32)])
    vals2 = np.concatenate([vals, np.full(extra, diag_value)])
    return rp2, cols2, vals2


def block_aggregation_setup(
    m,
    block: int = 4,
    omega_scale: float = 4.0 / 3.0,
    max_levels: int = 12,
    coarse_size: int = 512,
    smooth_levels: int = 1,
) -> BlockAmgHierarchy:
    """Build the block-SA hierarchy on the host.

    Aggregates are runs of ``block`` consecutive rows (pad rows carry
    an identity diagonal at the level's mean |diag| so D^-1 A keeps a
    unit eigenvalue there); the Galerkin products use the explicitly
    smoothed prolongator so they match the device's composed apply in
    exact arithmetic.

    Only the finest ``smooth_levels`` levels smooth their prolongator:
    each smoothing widens the Galerkin stencil by a matrix power, so
    smoothing every level densifies the deep operators; with plain P0
    below, every Galerkin operator of a banded matrix stays banded.
    """
    if m.num_rows != m.num_columns:
        raise ValueError("AMG requires a square matrix")
    if block < 2:
        raise ValueError("block must be >= 2")
    rp, cols, vals = _as_host_csr(m)
    n = m.num_rows
    wscale = 1.0 / np.sqrt(block)
    levels = []
    for _ in range(max_levels):
        if n <= coarse_size:
            break
        n_pad = -(-n // block) * block
        d = _extract_diag(n, rp, cols, vals)
        dmean = float(np.abs(d).mean()) or 1.0
        rp, cols, vals = _pad_csr_identity(n, n_pad, rp, cols, vals,
                                           dmean)
        d = np.concatenate([d, np.full(n_pad - n, dmean)])
        dinv = np.where(d != 0.0, 1.0 / np.where(d != 0.0, d, 1.0),
                        1.0)
        lam = _lambda_max_dinv_a(n_pad, rp, cols, vals, dinv)
        omega = omega_scale / max(lam, 1e-300)
        nc = n_pad // block

        smoothed = len(levels) < smooth_levels
        p0_rp = np.arange(n_pad + 1, dtype=np.int64)
        p0_cols = (np.arange(n_pad, dtype=np.int64)
                   // block).astype(np.int32)
        p0_vals = np.full(n_pad, wscale)
        if smoothed:
            # explicit smoothed P for the Galerkin product
            ap_rp, ap_cols, ap_vals = _spgemm(
                n_pad, rp, cols, vals, p0_rp, p0_cols, p0_vals, nc)
            ap_rows = np.repeat(np.arange(n_pad, dtype=np.int64),
                                np.diff(ap_rp))
            rows_cat = np.concatenate(
                [np.arange(n_pad, dtype=np.int64), ap_rows])
            cols_cat = np.concatenate([p0_cols.astype(np.int64),
                                       ap_cols.astype(np.int64)])
            vals_cat = np.concatenate([
                p0_vals, -omega * dinv[ap_rows] * ap_vals])
            prow, pcol, pval = _coo_dedupe(n_pad, nc, rows_cat,
                                           cols_cat, vals_cat)
            keep = pval != 0.0
            p_rp, p_cols, p_vals = _csr_from_coo(
                n_pad, prow[keep], pcol[keep], pval[keep])
        else:
            p_rp, p_cols, p_vals = p0_rp, p0_cols, p0_vals
        pt = _transpose(n_pad, nc, p_rp, p_cols, p_vals)
        ap = _spgemm(n_pad, rp, cols, vals, p_rp, p_cols, p_vals, nc)
        ac_rp, ac_cols, ac_vals = _spgemm(nc, *pt, *ap, nc)

        levels.append(BlockAmgLevel(
            n=n, n_pad=n_pad, n_coarse=nc, block=block,
            a=(rp, cols, vals), dinv=dinv, lambda_max=lam,
            omega=omega, smoothed=smoothed))
        rp, cols, vals = ac_rp, ac_cols, ac_vals
        n = nc

    dense = np.zeros((n, n))
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    dense[rows, cols] = vals
    return BlockAmgHierarchy(levels=levels,
                             coarse_inv=np.linalg.inv(dense),
                             block=block)


class BlockAmgDeviceLevel(torch.nn.Module):
    """Device arrays for one block level: the operator ``a`` (a
    ``DeviceDia`` or ``DeviceCsr`` submodule), the buffer ``dinv`` and
    the level's scalars (``n``, ``n_pad``, ``n_coarse``, ``block``,
    ``omega``, ``lo``, ``hi``, ``wscale``, ``smoothed``)."""

    def __init__(self, a, dinv: torch.Tensor, n: int, n_pad: int,
                 n_coarse: int, block: int, omega: float, lo: float,
                 hi: float, wscale: float, smoothed: bool):
        super().__init__()
        self.a = a
        self.register_buffer("dinv", dinv)
        self.n = int(n)
        self.n_pad = int(n_pad)
        self.n_coarse = int(n_coarse)
        self.block = int(block)
        self.omega = float(omega)
        self.lo = float(lo)
        self.hi = float(hi)
        self.wscale = float(wscale)
        self.smoothed = bool(smoothed)


class BlockAmgDevice(torch.nn.Module):
    """A block hierarchy on a device: ``levels`` (a ``ModuleList`` of
    ``BlockAmgDeviceLevel``), the dense ``coarse_inv`` buffer and the
    smoother degree.  ``forward(r)`` is ``block_vcycle``."""

    def __init__(self, levels, coarse_inv: torch.Tensor,
                 smoother_degree: int):
        super().__init__()
        self.levels = torch.nn.ModuleList(levels)
        self.register_buffer("coarse_inv", coarse_inv)
        self.smoother_degree = int(smoother_degree)

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        return block_vcycle(self, r)


def block_amg_device(
    hierarchy: BlockAmgHierarchy,
    dtype=None,
    smoother_degree: int = 3,
    smoother_band=(1.0 / 30.0, 1.1),
    max_diagonals: int = 96,
    device=None,
) -> BlockAmgDevice:
    """Push a block hierarchy to the device.

    Each level operator converts to DIA (kernel K1) when its diagonal
    count stays under ``max_diagonals``; otherwise it falls back to the
    CSR form (the CSR kernel).
    """
    device = resolve_device(device)
    dtype = dtype or default_value_dtype()
    dev_levels = []
    for lv in hierarchy.levels:
        rp, cols, vals = lv.a
        host = CsrMatrix(lv.n_pad, lv.n_pad, len(vals), 1, rp, cols,
                         vals)
        try:
            a_dev = DeviceDia.from_host(
                DiaMatrix.from_csr(host, max_diagonals=max_diagonals),
                dtype=dtype, device=device)
        except MatrixError:
            a_dev = DeviceCsr.from_host(host, dtype=dtype, device=device)
        dev_levels.append(BlockAmgDeviceLevel(
            a=a_dev,
            dinv=torch.as_tensor(lv.dinv, dtype=dtype, device=device),
            n=lv.n, n_pad=lv.n_pad, n_coarse=lv.n_coarse,
            block=lv.block, omega=float(lv.omega),
            lo=float(smoother_band[0] * lv.lambda_max),
            hi=float(smoother_band[1] * lv.lambda_max),
            wscale=float(1.0 / np.sqrt(lv.block)),
            smoothed=lv.smoothed,
        ))
    return BlockAmgDevice(
        dev_levels,
        torch.as_tensor(hierarchy.coarse_inv, dtype=dtype, device=device),
        smoother_degree)


def block_vcycle(hier: BlockAmgDevice, r: torch.Tensor) -> torch.Tensor:
    """One gather-free V-cycle: M^-1 r on the level-0 PADDED system.

    Transfers are reshape/sum and repeat; the smoothed prolongator is
    applied as the composition (I - w D^-1 A) around them (one extra
    matvec each way), so no rectangular sparse operator exists on the
    device.  On the card each matvec is one K1 (or CSR kernel) launch
    and the vector updates are torch element-wise operations.
    """
    degree = hier.smoother_degree
    levels = hier.levels

    def cycle(l, b):
        if l == len(levels):
            return hier.coarse_inv @ b
        lv = levels[l]

        def mv(v):
            return spmv(lv.a, v)

        x = _cheb_smooth(mv, lv.dinv, b, torch.zeros_like(b), lv.lo,
                         lv.hi, degree)
        r_f = b - mv(x)
        # restrict: P^T r = P0^T (I - w A D^-1) r; P0^T is a reshaped
        # block-sum.  Unsmoothed levels skip the composition matvec.
        rs = (r_f - lv.omega * mv(lv.dinv * r_f) if lv.smoothed
              else r_f)
        rc = rs.reshape(lv.n_coarse, lv.block).sum(dim=1) * lv.wscale
        # pad to the next level's system
        nl = (levels[l + 1].n_pad if l + 1 < len(levels)
              else hier.coarse_inv.shape[0])
        if nl > lv.n_coarse:
            rc = torch.nn.functional.pad(rc, (0, nl - lv.n_coarse))
        xc = cycle(l + 1, rc)[:lv.n_coarse]
        # prolongate: P xc = (I - w D^-1 A) P0 xc; P0 is a repeat
        # (an expand, which needs no host sync under a CUDA graph)
        y0 = xc[:, None].expand(-1, lv.block).reshape(-1) * lv.wscale
        x = x + (y0 - lv.omega * lv.dinv * mv(y0) if lv.smoothed
                 else y0)
        return _cheb_smooth(mv, lv.dinv, b, x, lv.lo, lv.hi, degree)

    return cycle(0, r)


def _block_info(hierarchy: BlockAmgHierarchy, hier: BlockAmgDevice,
                smoother_degree: int) -> dict:
    return {
        "kind": "sa-amg-block",
        "block": hierarchy.block,
        "levels": hierarchy.num_levels,
        "level_rows": [lv.n_pad for lv in hierarchy.levels]
        + [hierarchy.coarse_inv.shape[0]],
        "level_formats": [type(lv.a).__name__ for lv in hier.levels],
        "operator_complexity": hierarchy.operator_complexity,
        "smoother": f"chebyshev(degree={smoother_degree})",
    }


def block_amg_preconditioner(
    m=None,
    hierarchy: BlockAmgHierarchy = None,
    dtype=None,
    smoother_degree: int = 3,
    device=None,
    **setup_kw,
):
    """(apply, info) closure form of the block V-cycle.

    ``apply`` pads/unpads at the level-0 boundary so it plugs into any
    solver on the ORIGINAL n-vector; ``amg_solve`` keeps the whole
    Krylov loop in the padded layout instead.
    """
    if hierarchy is None:
        if m is None:
            raise ValueError("need a host matrix or a hierarchy")
        hierarchy = block_aggregation_setup(m, **setup_kw)
    hier = block_amg_device(hierarchy, dtype=dtype,
                            smoother_degree=smoother_degree,
                            device=device)
    n = hierarchy.levels[0].n if hierarchy.levels else None

    if not hierarchy.levels:
        def apply(r):
            return hier.coarse_inv @ r
    else:
        n_pad = hierarchy.levels[0].n_pad

        def apply(r):
            rp_ = (torch.nn.functional.pad(r, (0, n_pad - n))
                   if n_pad > n else r)
            out = block_vcycle(hier, rp_)
            return out[:n] if n_pad > n else out

    return apply, _block_info(hierarchy, hier, smoother_degree)


def amg_solve(
    m,
    b,
    tol: float = 1e-6,
    max_iterations: int = 500,
    dtype=None,
    block: int = 4,
    smoother_degree: int = 3,
    hierarchy: BlockAmgHierarchy = None,
    device=None,
    **setup_kw,
):
    """Full block-AMG-PCG solve.

    Builds (or takes) the hierarchy, pads b once, and runs the whole
    PCG in the padded layout, A being the level-0 operator.  Returns
    ``(CgResult, info)`` with x on the original n rows.
    """
    if hierarchy is None:
        hierarchy = block_aggregation_setup(m, block=block, **setup_kw)
    hier = block_amg_device(hierarchy, dtype=dtype,
                            smoother_degree=smoother_degree,
                            device=device)
    info = _block_info(hierarchy, hier, smoother_degree)
    cinv = hier.coarse_inv
    b_dev = torch.as_tensor(b, dtype=cinv.dtype, device=cinv.device)
    if not hierarchy.levels:
        return CgResult(x=cinv @ b_dev, residual_norm=torch.tensor(0.0),
                        iterations=1), info

    lv0 = hierarchy.levels[0]
    n, n_pad = lv0.n, lv0.n_pad
    if n_pad > n:
        b_dev = torch.nn.functional.pad(b_dev, (0, n_pad - n))
    a0 = hier.levels[0].a
    res = preconditioned_conjugate_gradient(
        lambda v: spmv(a0, v), b_dev, lambda r: block_vcycle(hier, r),
        tol=tol, max_iterations=max_iterations)
    return CgResult(x=res.x[:n], residual_norm=res.residual_norm,
                    iterations=res.iterations), info

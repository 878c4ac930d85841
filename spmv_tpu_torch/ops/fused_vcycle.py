"""Fused multigrid V-cycle: the whole block-SA AMG apply in ONE launch
(kernel K8, ``csrc/fused_vcycle.cu``).

The counterpart of ``spmv_tpu/ops/fused_vcycle.py``.  K8 replaces the
Pallas kernel ``_fused_kernel`` (``fused_vcycle.py:297``): y = M^-1 b,
one V-cycle over every level of a block hierarchy (degree-k Chebyshev
pre- and post-smoothing in D^-1 A, the smoothed restriction and
prolongation compositions, the dense coarse solve) without returning to
the host between its steps.

- ``_choose_depth`` and ``fused_block_setup`` are copied verbatim: their
  padding to a multiple of ``128 * block**L`` defines the hierarchy, so
  both packages build the same levels.
- ``FusedVcycle`` holds the levels in the NATURAL row order: level l is
  a ``DeviceDia`` (``data[k, i] = A_l[i, i + offsets[k]]``, (D_l, n_l))
  with ``dinv`` (n_l,), ``omega``, ``lo``, ``hi``, ``wscale`` and
  ``smoothed``; the coarse inverse is (nc, nc).  Not carried, because
  they are the TPU's layout: the lane fold (``_fold``, ``fold_vector``,
  ``unfold_vector``), the ``_widen`` halo and its ``|off| <= R_l``
  guard (a CUDA thread reads any neighbour row, so poisson2d(64, 16),
  which the JAX package refuses, runs here), the folded coarse
  permutation and ``_vmem_limit``.  Kept: the "fused-aligned" check,
  because K8 has no padding step between levels.
- ``fused_vcycle_reference`` is the plain version: ``_fused_kernel``'s
  arithmetic in natural order (DIA matvecs, the Chebyshev smoother,
  restrict = the sum of each run of ``block`` rows times wscale, prolong
  = repeat times wscale, the smoothed compositions, coarse = Cinv @ b).
- ``fused_vcycle_core`` is K8's wrapper: a CUDA tensor launches K8 (or
  raises), a CPU tensor takes the plain version; ``.launches`` counts
  the launches.  ``fused_vcycle`` pads and unpads at the boundary, and
  ``fused_vcycle_preconditioner`` is the (apply, info) form for PCG.

The Chebyshev scalars are computed on the host in float64 with the
association of ``_cheb_smooth`` (``(rho_new * rho) * p``,
``(2 rho_new / delta) * r``, ``r / theta``) and rounded to the vector
type once, where JAX's weakly typed Python floats round.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_tpu_torch.errors import KernelError, MatrixError
from spmv_tpu_torch.models.csr import CsrMatrix
from spmv_tpu_torch.models.device import LANE, DeviceDia, resolve_device
from spmv_tpu_torch.models.dia import DiaMatrix
from spmv_tpu_torch.ops._launch import (
    check_no_alias,
    check_vector,
    on_cuda,
    raise_on,
    stream_of,
)
from spmv_tpu_torch.ops.amg import (
    _as_host_csr,
    _cheb_smooth,
    _extract_diag,
    _pad_csr_identity,
    block_aggregation_setup,
)
from spmv_tpu_torch.ops.spmv import dia_spmv_reference

__all__ = [
    "fused_block_setup",
    "fused_vcycle_device",
    "fused_vcycle",
    "fused_vcycle_core",
    "fused_vcycle_reference",
    "fused_vcycle_preconditioner",
    "FusedVcycle",
]

THREADS_PER_BLOCK = 1024     # kThreads in csrc/fused_vcycle.cu
MAX_LEVELS = 12          # kMaxLevels in csrc/fused_vcycle.cu
MAX_DEGREE = 8           # kMaxDegree in csrc/fused_vcycle.cu
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


# ---------------------------------------------------------------------
# setup: a block hierarchy with fused-kernel alignment
# ---------------------------------------------------------------------

def _choose_depth(n: int, block: int, coarse_max: int,
                  max_levels: int) -> int:
    """Smallest L (>= 1) whose coarsest padded size fits coarse_max."""
    level = 1
    while (-(-n // (LANE * block ** level)) * LANE > coarse_max
           and level < max_levels):
        level += 1
    return level


def fused_block_setup(
    m,
    block: int = 4,
    coarse_max: int = 512,
    max_levels: int = 8,
    **setup_kw,
):
    """Build a ``BlockAmgHierarchy`` whose every level satisfies the
    fused kernel's alignment contract.

    The input is pre-padded with identity rows to a multiple of
    ``128 * block**L`` so the internal per-level padding of
    ``block_aggregation_setup`` is a no-op and level sizes divide
    exactly by ``block`` all the way down.  ``setup_kw`` forwards to
    block_aggregation_setup (e.g. ``smooth_levels``).
    """
    if m.num_rows != m.num_columns:
        raise MatrixError("fused V-cycle requires a square matrix")
    n = m.num_rows
    depth = _choose_depth(n, block, coarse_max, max_levels)
    unit = LANE * block ** depth
    n_pad = -(-n // unit) * unit
    rp, cols, vals = _as_host_csr(m)
    if n_pad != n:
        d = _extract_diag(n, rp, cols, vals)
        dmean = float(np.abs(d).mean()) or 1.0
        rp, cols, vals = _pad_csr_identity(n, n_pad, rp, cols, vals,
                                           dmean)
    host = CsrMatrix(n_pad, n_pad, len(vals), 1, rp, cols, vals)
    hier = block_aggregation_setup(
        host, block=block, max_levels=depth, coarse_size=0, **setup_kw)
    hier.original_rows = n          # for pad/unpad at the boundary
    return hier


# ---------------------------------------------------------------------
# device hierarchy in the natural order
# ---------------------------------------------------------------------

def _cheb_scalars(lo: float, hi: float, degree: int):
    """theta and the per-step coefficients of ``_cheb_smooth``'s p
    update, ``c1[j] = rho_new * rho`` and ``c2[j] = 2 rho_new / delta``,
    in float64 with the Python code's association."""
    theta = (hi + lo) / 2.0
    delta = (hi - lo) / 2.0
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    c1, c2 = [], []
    for _ in range(degree):
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        c1.append(rho_new * rho)
        c2.append(2.0 * rho_new / delta)
        rho = rho_new
    return theta, c1, c2


class FusedVcycle(torch.nn.Module):
    """Device arrays and geometry for K8, in the natural row order.

    - ``levels``: a ``ModuleList`` of ``DeviceDia``, level l's operator
      (``data`` (D_l, n_l), ``offsets``); the tuples ``data``,
      ``offsets`` and ``rows`` read them;
    - buffers ``dinv0 .. dinv{L-1}`` (the tuple ``dinv``), ``coarse``
      (nc, nc), the dense coarse inverse, and ``barrier`` (2,) int32, the
      arrival counter and generation of K8's grid barrier (zero between
      launches; so one module's applies must not run on two streams at
      once);
    - per level ``omegas``, ``los``, ``his``, ``wscales``, ``smoothed``;
      ``block``, ``degree``, ``num_rows`` (the original rows) and
      ``padded_rows``.
    """

    def __init__(self, levels, dinv, coarse: torch.Tensor, omegas, los,
                 his, wscales, smoothed, block: int, degree: int,
                 num_rows: int, padded_rows: int):
        super().__init__()
        self.levels = torch.nn.ModuleList(levels)
        for i, d in enumerate(dinv):
            self.register_buffer(f"dinv{i}", d)
        self.register_buffer("coarse", coarse)
        self.register_buffer("barrier", torch.zeros(
            2, dtype=torch.int32, device=coarse.device))
        self.omegas = tuple(float(v) for v in omegas)
        self.los = tuple(float(v) for v in los)
        self.his = tuple(float(v) for v in his)
        self.wscales = tuple(float(v) for v in wscales)
        self.smoothed = tuple(bool(v) for v in smoothed)
        self.block = int(block)
        self.degree = int(degree)
        self.num_rows = int(num_rows)
        self.padded_rows = int(padded_rows)

    @property
    def dtype(self) -> torch.dtype:
        return self.coarse.dtype

    @property
    def data(self) -> tuple:
        return tuple(a.data for a in self.levels)

    @property
    def dinv(self) -> tuple:
        return tuple(getattr(self, f"dinv{i}")
                     for i in range(len(self.levels)))

    @property
    def offsets(self) -> tuple:
        return tuple(a.offsets for a in self.levels)

    @property
    def rows(self) -> tuple:
        return tuple(a.num_rows for a in self.levels)

    def forward(self, r: torch.Tensor) -> torch.Tensor:
        return fused_vcycle(self, r)


def fused_vcycle_device(
    hierarchy,
    dtype=torch.float32,
    smoother_degree: int = 3,
    smoother_band=(1.0 / 30.0, 1.1),
    device=None,
) -> FusedVcycle:
    """Push a fused-aligned block hierarchy to the device, float32 or
    float64 (the types K8 takes)."""
    if dtype not in _DTYPE_CODE:
        raise MatrixError(
            "the fused V-cycle takes float32 or float64; got "
            f"{str(dtype).replace('torch.', '')}")
    if not hierarchy.levels:
        raise MatrixError("hierarchy has no levels — matrix is "
                          "already coarse; use a dense solve")
    device = resolve_device(device)
    levels, dinv, omegas, los, his, wscales, smoothed = ([] for _ in
                                                         range(7))
    for lv in hierarchy.levels:
        if lv.n != lv.n_pad:
            raise MatrixError(
                "hierarchy levels are not fused-aligned — build with "
                "fused_block_setup")
        rp, cols, vals = lv.a
        host = CsrMatrix(lv.n_pad, lv.n_pad, len(vals), 1, rp, cols,
                         vals)
        levels.append(DeviceDia.from_host(DiaMatrix.from_csr(host),
                                          dtype=dtype, device=device))
        dinv.append(torch.as_tensor(lv.dinv, dtype=dtype, device=device))
        omegas.append(float(lv.omega))
        los.append(float(smoother_band[0] * lv.lambda_max))
        his.append(float(smoother_band[1] * lv.lambda_max))
        wscales.append(float(1.0 / np.sqrt(lv.block)))
        smoothed.append(bool(lv.smoothed))
    coarse = torch.as_tensor(np.asarray(hierarchy.coarse_inv),
                             dtype=dtype, device=device)
    return FusedVcycle(
        levels, dinv, coarse, omegas, los, his, wscales, smoothed,
        block=hierarchy.block, degree=int(smoother_degree),
        num_rows=int(getattr(hierarchy, "original_rows",
                             hierarchy.levels[0].n)),
        padded_rows=hierarchy.levels[0].n_pad)


# ---------------------------------------------------------------------
# the plain version and the kernel's wrapper
# ---------------------------------------------------------------------

def fused_vcycle_reference(fv: FusedVcycle, b: torch.Tensor) -> torch.Tensor:
    """M^-1 b on the padded system (padded_rows,), in plain PyTorch: the
    arithmetic of ``_fused_kernel`` (fused_vcycle.py:297) in the natural
    order."""
    nl = len(fv.levels)
    dinvs = fv.dinv

    def cycle(level, b):
        if level == nl:
            return fv.coarse @ b
        a, dinv = fv.levels[level], dinvs[level]
        omega, wscale = fv.omegas[level], fv.wscales[level]
        lo, hi = fv.los[level], fv.his[level]
        smoothed = fv.smoothed[level]

        def mv(v):
            return dia_spmv_reference(a, v)

        x = _cheb_smooth(mv, dinv, b, torch.zeros_like(b), lo, hi,
                         fv.degree)
        r = b - mv(x)
        rs = r - omega * mv(dinv * r) if smoothed else r
        rcoarse = rs.reshape(-1, fv.block).sum(dim=1) * wscale
        xc = cycle(level + 1, rcoarse)
        y0 = xc[:, None].expand(-1, fv.block).reshape(-1) * wscale
        x = x + (y0 - omega * dinv * mv(y0) if smoothed else y0)
        return _cheb_smooth(mv, dinv, b, x, lo, hi, fv.degree)

    return cycle(0, b)


def _scratch_layout(rows, nc):
    """Element offsets of K8's per-level vectors in one scratch buffer:
    r, p and q at every level, b and x below level 0 (level 0's are the
    caller's b and y), and the coarse b and x.  Returns (per-level dicts,
    coarse b, coarse x, total)."""
    at, total = [], 0
    for lvl, n in enumerate(rows):
        slots = ("r", "p", "q") + (("b", "x") if lvl else ())
        at.append({s: total + i * n for i, s in enumerate(slots)})
        total += len(slots) * n
    return at, total, total + nc, total + 2 * nc


def _launch_table(fv: FusedVcycle, b, y, scratch):
    """The level table K8 takes: per level 8 pointers (data, offsets,
    dinv, b, x, r, p, q), 4 integers (rows, diagonals, smoothed, block)
    and 3 + 2 MAX_DEGREE float64 scalars (omega, wscale, theta, c1, c2),
    then the coarse inverse's, b's and x's pointers."""
    rows = fv.rows
    nc = fv.coarse.shape[0]
    at, bc, xc, _ = _scratch_layout(rows, nc)
    base, isz = scratch.data_ptr(), scratch.element_size()
    ptrs, ints, scal = [], [], []
    for lvl, (a, dinv) in enumerate(zip(fv.levels, fv.dinv)):
        o = at[lvl]
        ptrs += [a.data.data_ptr(), a.offsets_dev.data_ptr(),
                 dinv.data_ptr(),
                 b.data_ptr() if lvl == 0 else base + o["b"] * isz,
                 y.data_ptr() if lvl == 0 else base + o["x"] * isz,
                 base + o["r"] * isz, base + o["p"] * isz,
                 base + o["q"] * isz]
        ints += [rows[lvl], a.num_diagonals, int(fv.smoothed[lvl]),
                 fv.block]
        theta, c1, c2 = _cheb_scalars(fv.los[lvl], fv.his[lvl], fv.degree)
        pad = [0.0] * (MAX_DEGREE - fv.degree)
        scal += [fv.omegas[lvl], fv.wscales[lvl], theta] + c1 + pad \
            + c2 + pad
    ptrs += [fv.coarse.data_ptr(), base + bc * isz, base + xc * isz]
    return (np.asarray(ptrs, np.uint64), np.asarray(ints, np.int64),
            np.asarray(scal, np.float64))


def _check_launchable(fv: FusedVcycle) -> None:
    if fv.dtype not in _DTYPE_CODE:
        raise KernelError(f"K8 takes float32 or float64, not {fv.dtype}")
    if not 1 <= len(fv.levels) <= MAX_LEVELS:
        raise KernelError(
            f"K8 takes 1 to {MAX_LEVELS} levels; got {len(fv.levels)}")
    if not 1 <= fv.degree <= MAX_DEGREE:
        raise KernelError(
            f"K8 takes a smoother degree of 1 to {MAX_DEGREE}; got "
            f"{fv.degree}")
    if fv.padded_rows >= 1 << 31:
        raise KernelError("K8 indexes rows in 32 bits")
    rows = fv.rows + (fv.coarse.shape[0],)
    if any(n != rows[i + 1] * fv.block for i, n in enumerate(rows[:-1])):
        raise KernelError(
            f"level rows {rows} do not shrink by the block {fv.block}")


def fused_vcycle_core(fv: FusedVcycle, b: torch.Tensor,
                      out: torch.Tensor = None) -> torch.Tensor:
    """y = M^-1 b on the padded system: b and y (padded_rows,) in the
    hierarchy's dtype.  A CUDA tensor launches K8 once; a CPU tensor takes
    ``fused_vcycle_reference``.  ``out`` (optional) receives y and must
    not overlap b."""
    dt = fv.dtype
    check_vector("b", b, (fv.padded_rows,), dt)
    if out is not None:
        check_vector("out", out, (fv.padded_rows,), dt)
        check_no_alias(b, out)
    if not on_cuda("fused V-cycle", fv.coarse, b,
                   *(() if out is None else (out,))):
        y = fused_vcycle_reference(fv, b)
        return y if out is None else out.copy_(y)

    from spmv_tpu_torch.ops._build import load_library

    _check_launchable(fv)
    y = out if out is not None else torch.empty_like(b)
    _, _, _, total = _scratch_layout(fv.rows, fv.coarse.shape[0])
    scratch = torch.empty(total, dtype=dt, device=b.device)
    ptrs, ints, scal = _launch_table(fv, b, y, scratch)
    lib = load_library()
    rc = lib.fused_vcycle_launch(
        _DTYPE_CODE[dt], b.device.index, len(fv.levels), fv.degree,
        fv.coarse.shape[0], ptrs.ctypes.data, ints.ctypes.data,
        scal.ctypes.data, fv.barrier.data_ptr(), THREADS_PER_BLOCK,
        stream_of(b))
    raise_on(lib, rc, "fused_vcycle")
    fused_vcycle_core.launches += 1
    return y


fused_vcycle_core.launches = 0


def fused_vcycle(fv: FusedVcycle, r: torch.Tensor) -> torch.Tensor:
    """M^-1 r on the ORIGINAL n-vector (pad -> kernel -> unpad)."""
    r = r.to(fv.dtype)
    if fv.padded_rows > fv.num_rows:
        r = torch.nn.functional.pad(r, (0, fv.padded_rows - fv.num_rows))
    return fused_vcycle_core(fv, r.contiguous())[:fv.num_rows]


def fused_vcycle_preconditioner(
    m=None,
    hierarchy=None,
    dtype=torch.float32,
    smoother_degree: int = 3,
    device=None,
    **setup_kw,
):
    """(apply, info) closure, a drop-in for
    ``preconditioned_conjugate_gradient`` like
    ``block_amg_preconditioner``, applying the whole cycle in one K8
    launch.  ``info`` has the JAX function's keys but
    ``vmem_limit_bytes``, a TPU budget."""
    if hierarchy is None:
        if m is None:
            raise ValueError("need a host matrix or a hierarchy")
        hierarchy = fused_block_setup(m, **setup_kw)
    fv = fused_vcycle_device(hierarchy, dtype=dtype,
                             smoother_degree=smoother_degree,
                             device=device)

    def apply(r):
        return fused_vcycle(fv, r)

    info = {
        "kind": "sa-amg-fused",
        "block": fv.block,
        "levels": len(fv.levels) + 1,
        "level_rows": list(fv.rows) + [fv.coarse.shape[0]],
        "num_diagonals": [len(o) for o in fv.offsets],
        "operator_complexity": hierarchy.operator_complexity,
        "smoother": f"chebyshev(degree={smoother_degree})",
    }
    return apply, info

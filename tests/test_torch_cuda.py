"""Kernels K1, K2, K3a-c and the CSR kernel on the card against their
plain versions.

Marked ``cuda``: they skip where no CUDA device is present.  This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances (relative max-norm): float64 1e-12 and float32 1e-5 (the
kernel fuses multiply-add where the plain version rounds twice);
bfloat16 storage 1e-2 (both accumulate in float32 and round y once, so
they differ by at most one bfloat16 step); the fused dot 1e-10 in
float64 and 1e-4 in float32, relative to sum |x_i y_i| (the scale of
the rounding error of any summation order).  The WELL-CW and CSR
kernels (float64 and float32 only) are also launched twice on the same
input, and the two outputs must be bitwise equal.
"""

import functools

import numpy as np
import pytest
import torch

from spmv_tpu.io.generate import (
    banded_random,
    from_coo_arrays,
    poisson2d,
    random_sparse,
)
from spmv_tpu.models import DiaMatrix, WellCwMatrix
from spmv_tpu_torch.models import DeviceDia, DeviceWellCw
from spmv_tpu_torch.ops import (
    csr_spmv_core,
    csr_spmv_reference,
    cw_level_reference,
    cw_merged_reference,
    cw_pool_reference,
    dia_spmm_core,
    dia_spmm_reference,
    dia_spmv_core,
    dia_spmv_reference,
    wellcw_level_core,
    wellcw_merged_core,
    wellcw_pool_core,
    wellcw_spmv_core,
    wellcw_spmv_reference,
)

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 1e-5, torch.bfloat16: 1e-2}
DOT_TOL = {torch.float64: 1e-10, torch.float32: 1e-4, torch.bfloat16: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _matrix(case):
    if case == "poisson":
        return DiaMatrix.from_matrix_market(poisson2d(64, 48))
    if case == "large_offsets":
        rng = np.random.default_rng(7)
        n, rows, cols = 5000, [], []
        for off in (-300, -129, -128, -3, 0, 1, 127, 128, 300):
            i = np.arange(max(0, -off), min(n, n - off))
            rows.append(i)
            cols.append(i + off)
        rows, cols = np.concatenate(rows), np.concatenate(cols)
        return DiaMatrix.from_matrix_market(from_coo_arrays(
            n, n, rows, cols, rng.standard_normal(rows.size)))
    rows, cols = np.array([0, 0, 1, 2, 3, 3, 3]), np.array([0, 1, 1, 2, 0, 3, 4])
    return DiaMatrix.from_matrix_market(from_coo_arrays(
        4, 5, rows, cols, np.array([1.0, 2.0, 1.0, 3.0, -1.0, 2.0, 1.0])))


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("case", ["poisson", "large_offsets", "rectangular"])
def test_k1_matches_plain(case, dtype, cuda):
    A = DeviceDia.from_host(_matrix(case), dtype=dtype, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(A.num_columns, generator=g, device=cuda).to(dtype)
    before = dia_spmv_core.launches
    y = dia_spmv_core(A, x)
    y2, dot = dia_spmv_core(A, x, with_dot=True)
    torch.cuda.synchronize()
    assert dia_spmv_core.launches == before + 2
    want, want_dot = dia_spmv_reference(A, x, with_dot=True)
    assert _rel(y, want) <= TOL[dtype]
    assert torch.equal(y, y2)
    r = min(A.num_rows, A.num_columns)
    scale = float((x[:r].double() * want[:r].double()).abs().sum())
    assert abs(float(dot) - float(want_dot)) / scale <= DOT_TOL[dtype]


@pytest.mark.parametrize("dtype", list(TOL), ids=str)
@pytest.mark.parametrize("k", [1, 4, 11])
def test_k2_matches_plain(k, dtype, cuda):
    A = DeviceDia.from_host(_matrix("large_offsets"), dtype=dtype,
                            device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    X = torch.randn(A.num_columns, k, generator=g, device=cuda).to(dtype)
    before = dia_spmm_core.launches
    Y = dia_spmm_core(A, X)
    torch.cuda.synchronize()
    assert dia_spmm_core.launches == before + 1
    assert _rel(Y, dia_spmm_reference(A, X)) <= TOL[dtype]


# name -> (matrix, host packing options, device options)
WELLCW_CASES = {
    "merged": (lambda: banded_random(16384, 512, 6, seed=20), {}, {}),
    "fallback": (lambda: banded_random(4096, 128, 8, seed=1), {}, {}),
    "forced_fallback": (lambda: banded_random(16384, 512, 6, seed=20), {},
                        {"chunks_per_step": 32}),
    "remainder": (lambda: random_sparse(256, 256, 12, seed=7),
                  {"levels": [(2, 1, 0.0)], "pool_cap": 0}, {}),
}


@functools.lru_cache(maxsize=None)
def _wellcw_host(case):
    make, host_kw, _ = WELLCW_CASES[case]
    return WellCwMatrix.from_matrix_market(make(), **host_kw)


def _parts(A):
    """(wrapper, part, plain version) of every kernel launch of A."""
    out = []
    if A.merged is not None:
        out.append((wellcw_merged_core, A.merged, cw_merged_reference))
    out += [(wellcw_level_core, lv, cw_level_reference) for lv in A.levels]
    pools = ([A.pool] if A.pool is not None else []) + list(A.tail_pools)
    out += [(wellcw_pool_core, p, cw_pool_reference) for p in pools]
    if A.remainder is not None:
        out.append((lambda R, x, n: csr_spmv_core(R, x), A.remainder,
                    lambda R, x, n: csr_spmv_reference(R, x)))
    return out


def _rel_err(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max() /
                 max(float(want.abs().max()), 1e-300))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
@pytest.mark.parametrize("case", list(WELLCW_CASES))
def test_wellcw_kernels_match_plain(case, dtype, cuda):
    w = _wellcw_host(case)
    A = DeviceWellCw.from_host(w, dtype=dtype, device=cuda,
                               **WELLCW_CASES[case][2])
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(A.num_columns, generator=g, device=cuda, dtype=dtype)
    n = A.num_rows
    counters = (wellcw_merged_core, wellcw_level_core, wellcw_pool_core,
                csr_spmv_core)
    before = [c.launches for c in counters]
    for wrapper, part, plain in _parts(A):
        y1 = wrapper(part, x, n)
        y2 = wrapper(part, x, n)
        torch.cuda.synchronize()
        assert torch.equal(y1, y2), wrapper
        assert _rel_err(y1, plain(part, x, n)) <= TOL[dtype], wrapper
    y = wellcw_spmv_core(A, x)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    expect = [3 * (A.merged is not None),
              3 * len(A.levels),
              3 * ((A.pool is not None) + len(A.tail_pools)),
              3 * (A.remainder is not None)]
    assert launched == expect
    assert _rel_err(y, wellcw_spmv_reference(A, x)) <= TOL[dtype]
    want = torch.from_numpy(w.spmv(x.double().cpu().numpy()))
    assert _rel_err(y.cpu(), want) <= TOL[dtype]

"""The port's DIA container and SpMV / SpMM against the JAX package.

Inputs come from numpy with fixed seeds and go through both packages:
the port's plain versions (what its wrappers run for CPU tensors) are
held against JAX's XLA formulation (``spmv_tpu.ops.spmv``) and against
the Pallas kernels in interpret mode, run as tests/test_dia.py runs
them.  Tolerances: rtol 1e-12 in float64 (the sums differ only in
rounding order); 1e-2 relative max-norm for bfloat16 storage (8-bit
mantissa, one rounding of y).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.io.generate import from_coo_arrays, poisson2d
from spmv_tpu.io.matrix_market import parse_matrix_market
from spmv_tpu.models import DiaMatrix as JaxDiaMatrix
from spmv_tpu.models import device as jdev
from spmv_tpu.ops import pallas_kernels as jpk
from spmv_tpu.ops import spmv as jspmv
from spmv_tpu.ops.spmv import spmm as jspmm
from spmv_tpu_torch.errors import KernelError
from spmv_tpu_torch.io.generate import poisson2d as port_poisson2d
from spmv_tpu_torch.models import DeviceDia, DiaMatrix, dia_from_spmv_tpu
from spmv_tpu_torch.ops import (
    dia_spmm,
    dia_spmm_core,
    dia_spmv,
    dia_spmv_core,
)

CASES = ("poisson", "large_offsets", "rectangular")


@pytest.fixture(autouse=True)
def _fp64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    # the port's entry points run on the card unless asked for the CPU
    monkeypatch.setenv("SPMV_TPU_TORCH_DEVICE", "cpu")


def _banded(n, offsets, seed):
    """Random n x n matrix on the given diagonals (80% filled)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        i = i[rng.random(i.size) < 0.8]
        rows.append(i)
        cols.append(i + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return from_coo_arrays(n, n, rows, cols,
                           rng.standard_normal(rows.size))


def _host(case, tiny_text) -> JaxDiaMatrix:
    if case == "poisson":
        mm = poisson2d(13, 17)
    elif case == "large_offsets":
        # |offset| > 128, offsets that are multiples of 128, both signs
        mm = _banded(600, [-256, -129, -128, -3, 0, 1, 127, 128, 300], 7)
    else:
        mm = parse_matrix_market(tiny_text)         # 4 x 5
    return JaxDiaMatrix.from_matrix_market(mm)


def _jax_fields(Aj):
    arrays = {"data": np.asarray(Aj.data)}
    meta = {"offsets": Aj.offsets, "num_rows": Aj.num_rows,
            "num_columns": Aj.num_columns, "num_entries": Aj.num_entries}
    return arrays, meta


def _both(case, tiny_text, dtype=None):
    dia = _host(case, tiny_text)
    Aj = jdev.DeviceDia.from_host(dia, dtype=dtype)
    return dia, Aj, dia_from_spmv_tpu(*_jax_fields(Aj), device="cpu")


@pytest.mark.parametrize("case", CASES)
def test_from_host_matches_converted_jax_container(case, tiny_mtx_text):
    dia, Aj, Ac = _both(case, tiny_mtx_text)
    At = DeviceDia.from_host(dia)
    assert At.data.dtype == torch.float64          # default_value_dtype
    assert Ac.offsets == At.offsets == Aj.offsets
    assert At.offsets_dev.tolist() == list(Aj.offsets)
    for f in ("num_rows", "num_columns", "num_entries"):
        assert getattr(Ac, f) == getattr(At, f) == getattr(Aj, f)
    assert tuple(At.data.shape) == (len(Aj.offsets), Aj.num_rows)
    torch.testing.assert_close(Ac.data, At.data, rtol=0, atol=0)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("op", ["spmv", "spmm", "spmv_dot"])
def test_plain_matches_jax_xla_and_pallas(case, op, tiny_mtx_text):
    _, Aj, A = _both(case, tiny_mtx_text)
    rng = np.random.default_rng(4)
    shape = (A.num_columns, 3) if op == "spmm" else (A.num_columns,)
    x = rng.standard_normal(shape)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    launches = (dia_spmv_core.launches, dia_spmm_core.launches)
    if op == "spmv":
        got = dia_spmv(A, xt)
        wants = [jspmv(Aj, xj),
                 jpk.dia_spmv(Aj, xj, tile_rows=8, interpret=True)]
    elif op == "spmm":
        got = dia_spmm(A, xt)
        wants = [jspmm(Aj, xj),
                 jpk.dia_spmm(Aj, xj, tile_rows=8, interpret=True)]
    else:
        y, got = dia_spmv_core(A, xt, with_dot=True)
        r = min(A.num_rows, A.num_columns)
        y_xla = jspmv(Aj, xj)
        _, parts = jpk.dia_spmv_core(
            Aj, jpk.dia_prepare_x(Aj, xj, 8), 8, interpret=True,
            in_place=False, with_dot=True)
        wants = [jnp.vdot(xj[:r], y_xla[:r]), parts.sum()]
        _close(y, y_xla, 1e-12)
    for want in wants:
        _close(got, want, 1e-12)
    # CPU tensors take the plain versions: no kernel launched
    assert (dia_spmv_core.launches, dia_spmm_core.launches) == launches


@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_bf16_storage_matches_pallas(op, tiny_mtx_text):
    """bfloat16 storage, float32 accumulation, against the Pallas kernel
    (which also accumulates in float32) and the fp64 host product."""
    torch.set_default_dtype(torch.float32)
    dia, Aj, A = _both("poisson", tiny_mtx_text, dtype=jnp.bfloat16)
    assert A.data.dtype == torch.bfloat16
    rng = np.random.default_rng(5)
    shape = (A.num_columns, 2) if op == "spmm" else (A.num_columns,)
    x = rng.standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    if op == "spmv":
        got = dia_spmv(A, torch.from_numpy(x))
        pallas = jpk.dia_spmv(Aj, xj, tile_rows=8, interpret=True)
        host = dia.spmv(x.astype(np.float64))
    else:
        got = dia_spmm(A, torch.from_numpy(x))
        pallas = jpk.dia_spmm(Aj, xj, tile_rows=8, interpret=True)
        host = np.stack([dia.spmv(x[:, j].astype(np.float64))
                         for j in range(2)], axis=1)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for want in (np.asarray(pallas, np.float32), host):
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-2, err


def _bad_inputs(A):
    n, m = A.num_rows, A.num_columns
    x = torch.ones(m)
    return {
        "dtype": (torch.ones(m, dtype=torch.float32), None),
        "shape": (torch.ones(m + 1), None),
        "strided": (torch.ones(2 * m)[::2], None),
        "meta_device": (torch.ones(m, device="meta"), None),
        "out_aliases_x": (x, x[:n]),
        "out_shape": (x, torch.empty(n + 1)),
    }


@pytest.mark.parametrize("what", ["dtype", "shape", "strided",
                                  "meta_device", "out_aliases_x",
                                  "out_shape"])
def test_wrapper_rejects_bad_inputs(what):
    """The wrapper checks before it runs anything; a device that is
    neither the CPU nor CUDA raises instead of falling back."""
    dia = DiaMatrix.from_matrix_market(port_poisson2d(4, 4))
    A = DeviceDia.from_host(dia)
    x, out = _bad_inputs(A)[what]
    if what == "meta_device":
        A = A.to("meta")
    with pytest.raises(KernelError):
        dia_spmv_core(A, x, out=out)


def test_device_dia_forward_and_out_buffer():
    dia = DiaMatrix.from_matrix_market(port_poisson2d(5, 7))
    A = DeviceDia.from_host(dia)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(35))
    out = torch.empty(35)
    y = dia_spmv_core(A, x, out=out)
    assert y is out
    _close(A(x), dia.spmv(x.numpy()), 1e-12)
    _close(y, dia.spmv(x.numpy()), 1e-12)

"""The port's examples 01 and 02 on the CPU, against the JAX functions
the JAX examples call.

Each example runs as a child process with ``SPMV_TPU_TORCH_DEVICE=cpu``
and a time limit of its own, and must print the JAX example's lines in
its format.  The JAX side runs in this process, in float32 as the JAX
examples run:

- ``examples/01_formats_and_spmv_torch.py``: each matrix takes the
  format ``auto_format`` picks for it in the JAX package, and the
  product agrees with the fp64 host product (``rel_err`` below 1e-5).
- ``examples/02_solvers_torch.py``: CG on the DIA matrix and IC(0)-PCG
  take the JAX functions' iteration counts on the same inputs within 2;
  the four eigenvalues lie within 1e-5 of the analytic poisson2d(64, 64)
  spectrum.  The example raises ``dia_eigsh``'s cap from the JAX
  example's 200 iterations to 1,000; at 200, in float32, the port's
  ``dia_eigsh`` misses the spectrum by no more than JAX's does.
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmv_tpu.io.generate import banded_random, poisson2d
from spmv_tpu.models import CsrMatrix, DiaMatrix, auto_format
from spmv_tpu.models.device import DeviceDia, device_put_matrix
from spmv_tpu.ops import (
    dia_conjugate_gradient,
    dia_eigsh,
    ic0_factor,
    ic0_preconditioner,
    preconditioned_conjugate_gradient,
    spmv,
)
from spmv_tpu_torch import ops as tops
from spmv_tpu_torch.io.generate import poisson2d as tpoisson2d
from spmv_tpu_torch.models import DiaMatrix as TDiaMatrix
from spmv_tpu_torch.models.device import DEVICE_ENV
from spmv_tpu_torch.models.device import DeviceDia as TDeviceDia

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE_S = 120
LINE_01 = (r"(poisson 5-point|scattered banded)\s+-> (\S+)\s+\S+ Gnnz/s"
           r"  rel_err (\S+)")
LINES_02 = (r"CG        iters (\d+) rel_x \S+",
            r"IC\(0\)-PCG iters (\d+) method \S+",
            r"smallest eigenvalues \[([^\]]*)\]")


def _example(script) -> list:
    """The lines ``examples/<script>`` prints on the CPU within
    EXAMPLE_S (past it, the test fails)."""
    env = dict(os.environ, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")
    env[DEVICE_ENV] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    try:
        r = subprocess.run([sys.executable,
                            os.path.join(REPO, "examples", script)],
                           cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=EXAMPLE_S)
    except subprocess.TimeoutExpired:
        pytest.fail(f"{script} outlasted {EXAMPLE_S} s")
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()


def test_example_01_picks_the_jax_formats():
    lines = _example("01_formats_and_spmv_torch.py")
    assert len(lines) == 2, lines
    mats = {"poisson 5-point": poisson2d(256, 256),
            "scattered banded": banded_random(1 << 14, half_bandwidth=256,
                                              nnz_per_row=8)}
    for line in lines:
        m = re.fullmatch(LINE_01, line)
        assert m, line
        _, rationale = auto_format(mats[m[1]])
        assert m[2] == rationale["format"]
        assert float(m[3]) < 1e-5


def _jax_counts() -> tuple:
    """The JAX example's CG and IC(0)-PCG iteration counts, float32."""
    f32 = jnp.float32
    mm = poisson2d(64, 64)
    host = CsrMatrix.from_matrix_market(mm)
    x_true = np.random.default_rng(0).standard_normal(mm.num_rows)
    b = jnp.asarray(host.spmv(x_true), f32)
    Ad = DeviceDia.from_host(DiaMatrix.from_matrix_market(mm), dtype=f32)
    cg = dia_conjugate_gradient(Ad, b, tol=1e-8, max_iterations=2000)
    A = device_put_matrix(host, dtype=f32)
    apply_m, _ = ic0_preconditioner(ic0_factor(host), dtype=f32)
    pcg = preconditioned_conjugate_gradient(
        lambda v: spmv(A, v), b, apply_m, tol=1e-8, max_iterations=2000)
    return int(cg.iterations), int(pcg.iterations)


def test_example_02_counts_and_eigenvalues():
    lines = _example("02_solvers_torch.py")
    assert len(lines) == 3, lines
    ms = [re.fullmatch(p, line) for p, line in zip(LINES_02, lines)]
    assert all(ms), lines
    cg, pcg = _jax_counts()
    assert abs(int(ms[0][1]) - cg) <= 2
    assert abs(int(ms[1][1]) - pcg) <= 2
    c = 2.0 - 2.0 * np.cos(np.arange(1, 5) * np.pi / 65)
    want = np.sort((c[:, None] + c[None, :]).ravel())[:4]
    got = np.array([float(v) for v in ms[2][1].split()])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the witness for the example's cap: at the JAX example's 200
    # iterations, in float32, JAX's dia_eigsh misses the spectrum by at
    # least as much as the port's
    jax_eig = dia_eigsh(DeviceDia.from_host(
        DiaMatrix.from_matrix_market(poisson2d(64, 64)),
        dtype=jnp.float32), k=4, tol=1e-8, max_iterations=200)
    port_eig = tops.dia_eigsh(TDeviceDia.from_host(
        TDiaMatrix.from_matrix_market(tpoisson2d(64, 64)),
        dtype=torch.float32, device="cpu"), k=4, tol=1e-8,
        max_iterations=200)
    jax_err = np.abs(np.asarray(jax_eig.eigenvalues, np.float64) - want)
    port_err = np.abs(port_eig.eigenvalues.double().numpy() - want)
    assert port_err.max() <= jax_err.max()

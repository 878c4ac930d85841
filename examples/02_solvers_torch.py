"""Krylov solves and eigenpairs on the card: the PyTorch port's
counterpart of ``examples/02_solvers.py``.

CG on the DIA kernel loop, IC(0)-preconditioned CG on a CSR operator,
and a few smallest eigenpairs via LOBPCG.  Runs on the first CUDA
device, or on the CPU with ``SPMV_TPU_TORCH_DEVICE=cpu``:

    python examples/02_solvers_torch.py
"""

import numpy as np
import torch

from spmv_tpu_torch.io.generate import poisson2d
from spmv_tpu_torch.models import CsrMatrix, DiaMatrix
from spmv_tpu_torch.models.device import (
    DeviceDia,
    default_device,
    default_value_dtype,
    device_put_matrix,
)
from spmv_tpu_torch.ops import (
    dia_conjugate_gradient,
    dia_eigsh,
    ic0_factor,
    ic0_preconditioner,
    preconditioned_conjugate_gradient,
    spmv,
)

device, dtype = default_device(), default_value_dtype()
mm = poisson2d(64, 64)
host = CsrMatrix.from_matrix_market(mm)
n = mm.num_rows
rng = np.random.default_rng(0)
x_true = rng.standard_normal(n)
b = torch.as_tensor(host.spmv(x_true), dtype=dtype, device=device)

# plain CG through the DIA kernel loop (K1 with its fused p.Ap dot on
# the card)
Ad = DeviceDia.from_host(DiaMatrix.from_matrix_market(mm), dtype=dtype,
                         device=device)
res = dia_conjugate_gradient(Ad, b, tol=1e-8, max_iterations=2000)
print("CG        iters", int(res.iterations),
      "rel_x", float(np.linalg.norm(res.x.double().cpu().numpy() - x_true)
                     / np.linalg.norm(x_true)))

# IC(0)-preconditioned CG
A = device_put_matrix(host, dtype=dtype, device=device)
L = ic0_factor(host)
apply_m, info = ic0_preconditioner(L, dtype=dtype, device=device)
res_p = preconditioned_conjugate_gradient(
    lambda v: spmv(A, v), b, apply_m, tol=1e-8, max_iterations=2000)
print("IC(0)-PCG iters", int(res_p.iterations), "method", info["method"])

# four smallest eigenpairs (analytic spectrum available for poisson);
# in float32 LOBPCG's default cap of 200 iterations stops short of it,
# in the JAX package's dia_eigsh as in this one (tests/test_torch_examples.py
# holds the two side by side), so the cap here is 1,000
eig = dia_eigsh(Ad, k=4, which="smallest", tol=1e-8, max_iterations=1000)
print("smallest eigenvalues",
      np.round(eig.eigenvalues.double().cpu().numpy(), 6))

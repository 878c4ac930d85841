"""Pick a format, run SpMV on the card, time it: the PyTorch port's
counterpart of ``examples/01_formats_and_spmv.py``.

Runs on the first CUDA device (the DIA and WELL products are the
hand-written kernels there), or on the CPU with
``SPMV_TPU_TORCH_DEVICE=cpu`` (their plain versions):

    python examples/01_formats_and_spmv_torch.py
"""

import numpy as np
import torch

from spmv_tpu_torch.io.generate import banded_random, poisson2d
from spmv_tpu_torch.models import auto_format
from spmv_tpu_torch.models.device import (
    default_device,
    default_value_dtype,
    device_put_matrix,
)
from spmv_tpu_torch.ops import spmv
from spmv_tpu_torch.profile.harness import time_kernel

device, dtype = default_device(), default_value_dtype()
# auto_format inspects the sparsity structure: stencils -> DIA,
# clustered general -> WELL, scattered -> WELL-CW, block structure
# (SpMM workloads) -> BSR.
for name, mm in [("poisson 5-point", poisson2d(256, 256)),
                 ("scattered banded", banded_random(
                     1 << 14, half_bandwidth=256, nnz_per_row=8))]:
    host, rationale = auto_format(mm)
    A = device_put_matrix(host, dtype=dtype, device=device)
    x = torch.ones(mm.num_columns, dtype=dtype, device=device)
    y = spmv(A, x)
    want = host.spmv(np.ones(mm.num_columns))
    rel = float(np.linalg.norm(y.double().cpu().numpy() - want)
                / np.linalg.norm(want))
    # chained-slope timing: the per-chain overhead cancels
    t = time_kernel(lambda v: spmv(A, v[: A.num_columns]),
                    (x,)).seconds_per_iteration
    print(f"{name:18s} -> {rationale['format']:9s} "
          f"{mm.num_entries / t / 1e9:8.2f} Gnnz/s  rel_err {rel:.1e}")

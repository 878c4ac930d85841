"""spmv_tpu_torch — the PyTorch and CUDA port of spmv_tpu.

The port runs the DIA stencil path and the WELL-CW scattered-matrix
path on an NVIDIA Hopper card (sm_90a):

- ``spmv_tpu_torch.models``    ``DeviceDia``, ``DeviceWellCw`` and
                               ``DeviceCsr``, the device containers, and
                               the converters from the JAX containers.
- ``spmv_tpu_torch.ops``       DIA, WELL-CW and CSR SpMV / SpMM (plain
                               PyTorch versions and hand-written CUDA
                               kernels), the triad, and conjugate
                               gradient (single and multi-RHS).
- ``spmv_tpu_torch.perfmodel`` The card's machine model, its bandwidth
                               measured by the triad.
- ``spmv_tpu_torch.profile``   Chained-step timing and the profiling
                               report.

Host-side code is shared with ``spmv_tpu`` and not copied: Matrix Market
ingest and generators, the host formats, the performance model, sample
statistics, JSON output and the kernel base classes.  The port never
imports JAX.  The command line is ``python -m spmv_tpu_torch``.
"""

__version__ = "0.1.0"

from spmv_tpu.errors import (
    KernelError,
    MatrixError,
    SpmvError,
    TraceConfigError,
)

__all__ = [
    "SpmvError",
    "MatrixError",
    "KernelError",
    "TraceConfigError",
    "__version__",
]

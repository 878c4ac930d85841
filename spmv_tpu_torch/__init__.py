"""spmv_tpu_torch — the PyTorch and CUDA port of spmv_tpu.

The port runs the DIA stencil path, the WELL-CW scattered-matrix path,
the WELL banded-matrix path and the BSR block-matrix SpMM path on an
NVIDIA Hopper card (sm_90a):

- ``spmv_tpu_torch.io``        Matrix Market ingest and the generators.
- ``spmv_tpu_torch.models``    The host formats (``CsrMatrix``,
                               ``DiaMatrix``, ``WellCwMatrix``,
                               ``WellMatrix``, ``BsrMatrix``) and
                               ``auto_format``, the device containers
                               (``DeviceDia``, ``DeviceWellCw``,
                               ``DeviceWell``, ``DeviceBsr``,
                               ``DeviceCsr``), and the converters from
                               the JAX containers.
- ``spmv_tpu_torch.ops``       DIA, WELL-CW, WELL and CSR SpMV / SpMM and
                               BSR SpMM (plain PyTorch versions and
                               hand-written CUDA kernels), the triad, and
                               conjugate gradient (single and multi-RHS).
- ``spmv_tpu_torch.perfmodel`` The card's machine model, its bandwidth
                               measured by the triad, and the roofline.
- ``spmv_tpu_torch.profile``   Chained-step timing and the profiling
                               report.

The port keeps its own copies of the JAX package's host code (ingest,
host formats and packers, roofline, sample statistics, JSON output): it
imports nothing of ``spmv_tpu``, and never JAX.  Its entry points run on
the card; ``SPMV_TPU_TORCH_DEVICE=cpu`` or an explicit ``device=`` asks
for the CPU.  The command line is ``python -m spmv_tpu_torch``.
"""

__version__ = "0.1.0"

from spmv_tpu_torch.errors import (
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

"""Host-side utilities of the port: sample statistics and JSON report
output (copies of ``spmv_tpu/utils/sample.py`` and ``jsonio.py``; the
JAX package's compile and AOT caches have no counterpart here)."""

from spmv_tpu_torch.utils.jsonio import dump_json, json_dumps
from spmv_tpu_torch.utils.sample import Sample, compute_sample

__all__ = ["Sample", "compute_sample", "dump_json", "json_dumps"]

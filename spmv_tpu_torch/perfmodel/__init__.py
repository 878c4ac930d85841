"""The port's performance model: the card's machine model (its bandwidth
measured by the triad), and the port's copies of the JAX package's
roofline (``tiling.roofline_time``), sharded-SpMV scaling model
(``scaling.spmv_scaling_model``, priced with the measured triad and an
assumed NVLink rate), machine-config reader
(``trace_config.read_trace_config``) and cache-trace simulation (the
reference tool's simulation mode, ``--profile 0``: ``cache_sim``,
``layout``, ``refstring``, ``cache_trace`` and the native replay core's
loader ``native``), exported as ``spmv_tpu/perfmodel/__init__.py`` does."""

from spmv_tpu_torch.perfmodel.machine import (
    H100_SXM_DATASHEET,
    GpuMachineModel,
    measured_machine,
)
from spmv_tpu_torch.perfmodel.scaling import (
    SpmvScalingModel,
    spmv_scaling_model,
)
from spmv_tpu_torch.perfmodel.tiling import roofline_time
from spmv_tpu_torch.perfmodel.trace_config import (
    Cache,
    ThreadAffinity,
    TraceConfig,
    parse_trace_config,
    read_trace_config,
)
from spmv_tpu_torch.perfmodel.cache_sim import (
    FIFO,
    LRU,
    RAND,
    trace_cache_misses_interleaved,
    trace_cache_misses_single,
)
from spmv_tpu_torch.perfmodel.layout import VirtualLayout, thread_of_index
from spmv_tpu_torch.perfmodel.cache_trace import (
    CacheTrace,
    trace_cache_misses,
)

__all__ = ["GpuMachineModel", "H100_SXM_DATASHEET", "measured_machine",
           "roofline_time", "SpmvScalingModel", "spmv_scaling_model",
           "Cache", "ThreadAffinity", "TraceConfig",
           "read_trace_config", "parse_trace_config", "LRU", "FIFO", "RAND",
           "trace_cache_misses_single", "trace_cache_misses_interleaved",
           "VirtualLayout", "thread_of_index", "CacheTrace",
           "trace_cache_misses"]

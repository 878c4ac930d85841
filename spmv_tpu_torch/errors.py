"""Typed exception hierarchy.

The reference uses one typed exception per subsystem, caught in main and
mapped to a non-zero exit (reference: src/main.cpp:261-270,
src/matrix/matrix-error.hpp, src/kernels/kernel.hpp:47-50,
src/trace-config.hpp:14-18). We mirror that failure model.

The port's copy of ``spmv_tpu/errors.py``: the same code, importing the
port's copies instead of the JAX package.
"""


class SpmvError(Exception):
    """Base class for all spmv_tpu errors."""


class MatrixError(SpmvError):
    """Matrix parsing / conversion error (reference: matrix::matrix_error)."""


class KernelError(SpmvError):
    """Kernel construction / execution error (reference: kernel_error)."""


class TraceConfigError(SpmvError):
    """Machine-model config error (reference: trace_config_error)."""


class ProfileError(SpmvError):
    """Profiling error (reference: perf::perf_error)."""

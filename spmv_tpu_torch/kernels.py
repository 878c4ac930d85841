"""Kernels of the port: ``triad``, ``dia`` and ``wellcw``.

They subclass the shared ``spmv_tpu.kernels`` classes, so loading,
conversion, the memory reference strings and ``describe`` stay the JAX
package's; what changes is the device step (``run_fn`` / ``spmm_fn``)
and the byte accounting, whose value width comes from the tensor dtype
here (the shared classes ask JAX whether x64 is on).  Every other kernel
name raises: it is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from spmv_tpu import kernels as _base
from spmv_tpu.errors import KernelError
from spmv_tpu.io.matrix_market import MatrixMarket
from spmv_tpu.perfmodel.refstring import IDX
from spmv_tpu_torch.models.device import (
    DeviceDia,
    DeviceWellCw,
    default_device,
    default_value_dtype,
)
from spmv_tpu_torch.ops.dia_kernels import dia_spmm_core, dia_spmv_core
from spmv_tpu_torch.ops.triad import triad
from spmv_tpu_torch.ops.wellcw_kernels import wellcw_spmv_core

__all__ = ["TriadKernel", "DiaKernel", "WellCwKernel", "make_kernel"]


class _PingPong:
    """Two buffers a chained step alternates between: each step reads one
    and writes the other, so no iteration allocates and no output
    aliases its input."""

    def __init__(self, first: torch.Tensor):
        self.bufs = (first, torch.empty_like(first))

    def other(self, v: torch.Tensor) -> torch.Tensor:
        return self.bufs[1] if v is self.bufs[0] else self.bufs[0]


def _chain_output(y: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Feed y back as the next iteration's input (``spmv_tpu.kernels.
    _chain_output``): a rectangular matrix takes y's leading entries and
    keeps the previous input's tail."""
    if y.shape == v.shape:
        return y
    if y.shape[0] >= v.shape[0]:
        return y[: v.shape[0]]
    return torch.cat([y, v[y.shape[0]:]])


class TriadKernel(_base.TriadKernel):
    """STREAM triad on the port's device.  ``traffic_split`` is the base
    ``Kernel``'s (all bytes stream), which reads ``bytes_per_run``."""

    def __init__(self, num_entries: int, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(num_entries)
        self.device = torch.device(device or default_device())
        self.dtype = dtype or default_value_dtype()

    def run_fn(self):
        n = self.num_entries
        b = torch.ones(n, dtype=self.dtype, device=self.device)
        c = torch.full((n,), 2.0, dtype=self.dtype, device=self.device)
        bufs = _PingPong(b)

        def step(v, c):
            return triad(v, c, 3.1, out=bufs.other(v))

        return step, (b, c)

    def bytes_per_run(self) -> int:
        return 3 * self.dtype.itemsize * self.num_entries


class DiaKernel(_base.DiaKernel):
    """DIA SpMV / SpMM through kernels K1 / K2 on CUDA (their plain
    versions on the CPU)."""

    def __init__(self, *args, device=None,
                 dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(*args, **kw)
        self.device = torch.device(device or default_device())
        self.dtype = dtype or default_value_dtype()

    def device_matrix(self) -> DeviceDia:
        return DeviceDia.from_host(self.matrix, dtype=self.dtype,
                                   device=self.device)

    def run_fn(self):
        A = self.device_matrix()
        x = torch.ones(A.num_columns, dtype=self.dtype, device=self.device)
        if A.num_rows == A.num_columns:
            bufs = _PingPong(x)

            def step(v, A):
                return dia_spmv_core(A, v, out=bufs.other(v))
        else:
            def step(v, A):
                return _chain_output(
                    dia_spmv_core(A, v[: A.num_columns]), v)

        return step, (x, A)

    def spmm_fn(self, k: int):
        if k <= 0:
            raise KernelError("spmm: k must be positive")
        A = self.device_matrix()
        X = torch.ones((A.num_columns, k), dtype=self.dtype,
                       device=self.device)
        if A.num_rows == A.num_columns:
            bufs = _PingPong(X)

            def step(V, A):
                return dia_spmm_core(A, V, out=bufs.other(V))
        else:
            def step(V, A):
                return _chain_output(
                    dia_spmm_core(A, V[: A.num_columns]), V)

        return step, (X, A)

    @property
    def value_bytes(self) -> int:
        return self.dtype.itemsize

    def bytes_per_run(self) -> int:
        m = self.matrix
        return (m.data.size + m.num_columns + m.num_rows) * self.value_bytes

    def traffic_split(self):
        # the diagonals stream; x and y are the chained iterate
        m = self.matrix
        vec = (m.num_columns + m.num_rows) * self.value_bytes
        return self.bytes_per_run() - vec, vec


class WellCwKernel(_base.WellCwKernel):
    """WELL-CW SpMV through kernels K3a-c and the CSR remainder kernel on
    CUDA (their plain versions on the CPU).  The SpMM (kernels K4) is not
    ported yet."""

    def __init__(self, *args, device=None,
                 dtype: Optional[torch.dtype] = None, **kw):
        super().__init__(*args, **kw)
        self.device = torch.device(device or default_device())
        self.dtype = dtype or default_value_dtype()

    def device_matrix(self) -> DeviceWellCw:
        return DeviceWellCw.from_host(self.matrix, dtype=self.dtype,
                                      device=self.device)

    def run_fn(self):
        A = self.device_matrix()
        x = torch.ones(A.num_columns, dtype=self.dtype, device=self.device)
        if A.num_rows == A.num_columns:
            bufs = _PingPong(x)

            def step(v, A):
                return wellcw_spmv_core(A, v, out=bufs.other(v))
        else:
            def step(v, A):
                return _chain_output(
                    wellcw_spmv_core(A, v[: A.num_columns]), v)

        return step, (x, A)

    def spmm_fn(self, k: int):
        raise KernelError(
            "spmm on wellcw is not yet ported to spmv_tpu_torch (kernels "
            "K4); see ROADMAP.md")

    @property
    def value_bytes(self) -> int:
        return self.dtype.itemsize

    def bytes_per_run(self) -> int:
        # the shared class's count, at the tensor's value width
        m = self.matrix
        vb = self.value_bytes
        b = sum(lv.value.size * (vb + IDX) for lv in m.levels)
        for p in m._pools():
            b += p.value.size * (vb + 2 * IDX)        # + rowmap
        if m.remainder is not None:
            b += m.remainder.num_entries * (vb + IDX)
        return b + (m.num_columns + m.num_rows) * vb

    def traffic_split(self):
        # the chunks stream; x and y are the chained iterate
        m = self.matrix
        vec = (m.num_columns + m.num_rows) * self.value_bytes
        return self.bytes_per_run() - vec, vec


def make_kernel(
    name: str,
    matrix_path: str = None,
    mm: MatrixMarket = None,
    matrix=None,
    triad_entries: int = 0,
    device=None,
    dtype: Optional[torch.dtype] = None,
    **kw,
):
    """Kernel factory: ``triad``, ``dia`` and ``wellcw``; any other name
    of the JAX package's factory raises ``KernelError`` (not yet
    ported)."""
    if name == "triad":
        return TriadKernel(triad_entries, device=device, dtype=dtype)
    if name == "dia":
        return DiaKernel(matrix_path=matrix_path, mm=mm, matrix=matrix,
                         device=device, dtype=dtype, **kw)
    if name == "wellcw":
        return WellCwKernel(matrix_path=matrix_path, mm=mm, matrix=matrix,
                            device=device, dtype=dtype, **kw)
    if name in _base.KERNEL_NAMES:
        raise KernelError(
            f"kernel {name!r} is not yet ported to spmv_tpu_torch; see "
            "ROADMAP.md")
    raise KernelError(
        f"unknown kernel {name!r}; expected one of {_base.KERNEL_NAMES}")

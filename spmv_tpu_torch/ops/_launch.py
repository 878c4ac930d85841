"""Launch discipline shared by the kernel wrappers.

Each wrapper checks device, dtype, shape and contiguity here before it
launches, and raises through ``raise_on`` when the C launcher returns a
CUDA error.  ``on_cuda`` is the only place that decides between a
kernel and its plain version: CUDA tensors take the kernel, CPU tensors
the plain version, and any other device (or a mix) raises.
"""

from __future__ import annotations

import torch

from spmv_tpu_torch.errors import KernelError

__all__ = ["on_cuda", "check_vector", "check_no_alias", "raise_on",
           "stream_of"]


def on_cuda(what: str, *tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises for any
    other device or a mix of devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise KernelError(
            f"matrix and vectors lie on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise KernelError(f"no {what} kernel for device {dev}")


def check_vector(name: str, t: torch.Tensor, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape):
        raise KernelError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise KernelError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise KernelError(f"{name} must be contiguous")


def check_no_alias(x: torch.Tensor, out: torch.Tensor) -> None:
    xs, xe = x.data_ptr(), x.data_ptr() + x.numel() * x.element_size()
    os_, oe = out.data_ptr(), out.data_ptr() + out.numel() * out.element_size()
    if xs < oe and os_ < xe:
        raise KernelError(
            "out must not overlap the input vector (the kernels have no "
            "in-place variant; alternate between two buffers)")


def raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.spmv_tpu_torch_error_string(rc).decode()
        raise KernelError(f"{what} launch failed: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the C launchers take it."""
    return torch.cuda.current_stream(t.device).cuda_stream

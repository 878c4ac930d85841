"""Device-side DIA container.

The counterpart of ``spmv_tpu.models.device.DeviceDia``.  The TPU
container folds each diagonal into (rows/128, 128) lanes and pads rows
to a multiple of 1024 for the Pallas kernel's DMA windows; a CUDA
kernel addresses memory linearly, so here each diagonal is one
contiguous row of ``data`` with exactly ``num_rows`` entries.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from spmv_tpu.models.dia import DiaMatrix

__all__ = ["DeviceDia", "default_device", "default_value_dtype"]


def default_device() -> torch.device:
    """The first CUDA device when one is present, else the CPU.  The CPU
    serves the tests; once a card is present nothing switches to it."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def default_value_dtype() -> torch.dtype:
    """float64 when torch's default dtype is float64 (the tests' analogue
    of JAX's x64 mode), else float32."""
    if torch.get_default_dtype() == torch.float64:
        return torch.float64
    return torch.float32


class DeviceDia(torch.nn.Module):
    """DIA matrix on a device: ``data[k, i] = A[i, i + offsets[k]]``.

    Buffers (moved by ``.to(device)``):

    - ``data``: (D, num_rows), the value dtype (float32, float64 or
      bfloat16 storage);
    - ``offsets_dev``: (D,) int32, the diagonal offsets the kernels read.

    Metadata (plain Python values): ``num_rows``, ``num_columns``,
    ``num_entries`` and ``offsets``, a tuple of ints as in the JAX
    container, which the plain versions loop over.  Entries of ``data``
    whose column ``i + offsets[k]`` falls outside [0, num_columns) are
    zero and never read by the kernels.
    """

    format_name = "dia"

    def __init__(self, num_rows: int, num_columns: int, num_entries: int,
                 offsets, data: torch.Tensor):
        super().__init__()
        offsets = tuple(int(o) for o in offsets)
        if data.dim() != 2 or tuple(data.shape) != (len(offsets),
                                                    num_rows):
            raise ValueError(
                f"data has shape {tuple(data.shape)}, expected "
                f"{(len(offsets), num_rows)}")
        self.num_rows = int(num_rows)
        self.num_columns = int(num_columns)
        self.num_entries = int(num_entries)
        self.offsets = offsets
        self.register_buffer("data", data.contiguous())
        self.register_buffer("offsets_dev", torch.tensor(
            offsets, dtype=torch.int32, device=data.device))

    @property
    def num_diagonals(self) -> int:
        return len(self.offsets)

    @classmethod
    def from_host(cls, m: DiaMatrix, dtype: Optional[torch.dtype] = None,
                  device=None) -> "DeviceDia":
        dtype = dtype or default_value_dtype()
        data = torch.from_numpy(np.ascontiguousarray(m.data,
                                                     dtype=np.float64))
        return cls(m.num_rows, m.num_columns, m.num_entries, m.offsets,
                   data.to(device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x (the plain version on the CPU, kernel K1 on CUDA)."""
        from spmv_tpu_torch.ops.dia_kernels import spmv

        return spmv(self, x)

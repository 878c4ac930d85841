"""STREAM triad: a[i] = b[i] + q * c[i].

The bandwidth probe of the reference tool (24 bytes and 2 flops per
element in fp64).  The JAX package computes it with XLA, not a Pallas
kernel, so the port computes it with PyTorch's own elementwise kernel.
"""

from __future__ import annotations

import torch

__all__ = ["triad"]


def triad(b: torch.Tensor, c: torch.Tensor, q: float,
          out: torch.Tensor = None) -> torch.Tensor:
    return torch.add(b, c, alpha=q, out=out)

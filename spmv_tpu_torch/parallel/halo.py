"""Communication-volume model (the remote-traffic analogue): the port's
copy of ``spmv_tpu/parallel/halo.py``, numpy only, its import rewritten.

The reference prices remote traffic by attributing every x-gather
reference to the NUMA domain owning that page and replaying it through
the cache model, yielding per-thread x per-domain miss matrices
(csr-matrix.cpp:132-136, cache-trace.cpp:156-160).  On a TPU slice the
same question is "which x entries must cross the interconnect, and
between which shards" — answered *analytically* here, as a pure function of the
partition (testable on CPU with hand-computable cases, the same trick
as test_replacement.cpp).

``communication_volume`` returns, for a row-partitioned CSR and its
bounds, the P x P matrix ``need[p][q]`` = number of *distinct* x
elements shard p reads that shard q owns (diagonal = local reads).
From it derive:

- all-gather cost per shard: (P-1)/P * n elements (what the current
  kernel pays),
- ragged point-to-point cost: sum of off-diagonal need rows (what a
  halo-exchange kernel would pay),
- the halo efficiency ratio between them (when >> 1, a halo kernel
  beats all-gather; RCM reordering raises it).

``build_halo_plan`` materializes the per-shard halo index lists for the
gather-based halo kernel.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from spmv_tpu_torch.models.csr import CsrMatrix

__all__ = ["communication_volume", "HaloPlan", "build_halo_plan"]


def communication_volume(
    m: CsrMatrix, bounds: np.ndarray, col_bounds: np.ndarray = None
) -> dict:
    """Distinct-element communication matrix for a row partition.

    Returns {"need": (P,P) int64, "all_gather_elements": int,
    "halo_elements": int, "halo_fraction_of_all_gather": float,
    "bytes_per_element": None} — byte pricing is applied by the caller
    (dtype-dependent).
    """
    bounds = np.asarray(bounds, dtype=np.int64)
    if col_bounds is None:
        col_bounds = bounds
    P = bounds.size - 1
    need = np.zeros((P, P), dtype=np.int64)

    rows = np.repeat(
        np.arange(m.num_rows, dtype=np.int64), np.diff(m.row_ptr)
    )
    shard_of_row = np.searchsorted(bounds, rows, side="right") - 1

    for p in range(P):
        sel = shard_of_row == p
        cols_p = np.unique(m.column_index[sel])
        owners = np.searchsorted(col_bounds, cols_p, side="right") - 1
        np.add.at(need[p], owners, 1)

    off_diag = need.sum() - np.trace(need)
    n = m.num_columns
    all_gather = (P - 1) * n  # every shard receives the other shards' x
    return {
        "num_shards": P,
        "need": need,
        "all_gather_elements": int(all_gather),
        "halo_elements": int(off_diag),
        "halo_fraction_of_all_gather": (
            float(off_diag) / all_gather if all_gather else 0.0
        ),
    }


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Per-shard halo gather lists (host-side, static).

    ``halo_indices[p]`` — global x indices shard p must fetch remotely,
    sorted; ``local_slices[p]`` — (lo, hi) global range shard p owns.
    """

    num_shards: int
    local_slices: tuple
    halo_indices: tuple       # tuple of np.ndarray
    halo_sources: tuple       # tuple of np.ndarray (owner shard per index)

    def max_halo(self) -> int:
        return max((h.size for h in self.halo_indices), default=0)


def build_halo_plan(
    m: CsrMatrix, bounds: np.ndarray, col_bounds: np.ndarray = None
) -> HaloPlan:
    bounds = np.asarray(bounds, dtype=np.int64)
    if col_bounds is None:
        col_bounds = bounds
    P = bounds.size - 1
    rows = np.repeat(
        np.arange(m.num_rows, dtype=np.int64), np.diff(m.row_ptr)
    )
    shard_of_row = np.searchsorted(bounds, rows, side="right") - 1

    halo_indices: List[np.ndarray] = []
    halo_sources: List[np.ndarray] = []
    local_slices = []
    for p in range(P):
        lo, hi = int(col_bounds[p]), int(col_bounds[p + 1])
        local_slices.append((lo, hi))
        cols_p = np.unique(m.column_index[shard_of_row == p])
        remote = cols_p[(cols_p < lo) | (cols_p >= hi)]
        halo_indices.append(remote.astype(np.int64))
        halo_sources.append(
            (np.searchsorted(col_bounds, remote, side="right") - 1).astype(
                np.int64
            )
        )
    return HaloPlan(
        num_shards=P,
        local_slices=tuple(local_slices),
        halo_indices=tuple(halo_indices),
        halo_sources=tuple(halo_sources),
    )

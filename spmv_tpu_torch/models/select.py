"""Automatic storage-format selection.

The reference makes the user pick a format on the command line
(--spmv-format, src/main.cpp:166-188).  On TPU the right choice is
mechanical, so this module decides from the matrix's structure:

1. **DIA** when the distinct-diagonal count is small enough that the
   dense diagonal storage stays near the nonzero count (the stencil
   case — the fastest kernel by far);
2. otherwise **WELL**, optionally RCM-reordered first when that
   collapses the window spill (general matrices with clustered
   columns);
3. otherwise **WELL-CW** (chunk-window WELL, models.wellcw) — the
   scattered-column format whose windows tile the column space, so it
   has no spill cliff (probes 27/28: 15 Gnnz/s on the random-banded
   case where per-slot WELL spilled 31%).  The device path never
   falls back to the XLA CSR gather path (~0.06 Gnnz/s on this chip).

``auto_format`` returns the converted host matrix plus a rationale
dict for reports.

The port's copy of ``spmv_tpu/models/select.py``: the same code,
importing the port's copies instead of the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from spmv_tpu_torch.io.matrix_market import MatrixMarket
from spmv_tpu_torch.models.dia import DiaMatrix
from spmv_tpu_torch.models.well import WellMatrix
from spmv_tpu_torch.models.wellcw import WellCwMatrix

__all__ = ["auto_format"]

DIA_MAX_FILL = 3.0          # dense diagonal slots per nonzero
WELL_MAX_SPILL = 0.15       # acceptable out-of-window fraction
BSR_SPMM_MAX_FILL = 2.0     # stored block cells per nonzero at which
                            # the MXU path still wins an SpMM workload
                            # (tighter than the 4.0 advisory hint)
WELL_MAX_FILL = 2.0         # stored slots per kept nonzero: beyond
#                             this the per-slot kernel's storage
#                             blowup loses to WELL-CW's cheaper chunks
WELL_WINDOW_ROWS = 4


def auto_format(
    mm: MatrixMarket,
    try_rcm: bool = True,
    window_rows: int = WELL_WINDOW_ROWS,
    workload: str = "spmv",
) -> Tuple[object, dict]:
    """Pick and build the best host format for ``mm``.

    Returns (matrix, rationale).  ``rationale["format"]`` is one of
    "dia" / "bsr" / "well" / "well+rcm" / "well+sigma" / "wellcw";
    the dict carries the numbers the decision used.

    ``workload`` steers the choice the way the reference's CLI lets
    the caller steer formats (src/main.cpp:166-188): "spmv" (default)
    optimizes the single-vector bandwidth path; "spmm" lets a
    block-structured pattern select BSR, whose dense (block x 128)
    MXU products win once the gather amortizes over many vectors.
    """
    if workload not in ("spmv", "spmm"):
        raise ValueError(
            f"workload must be 'spmv' or 'spmm', got {workload!r}")
    rationale: dict = {"workload": workload}

    # int32 throughout and bincount instead of unique-sorts: the
    # structure statistics must stay cheap next to conversion itself
    # (first-touch page faults price every nnz-sized temporary on the
    # target host — see bench.py).
    nspan = mm.num_rows + mm.num_columns - 1
    if nspan <= (1 << 28) and max(mm.num_rows,
                                  mm.num_columns) < (1 << 31):
        rows = mm.rows_1based.astype(np.int32, copy=False) - 1
        cols = mm.cols_1based.astype(np.int32, copy=False) - 1
        diag = (cols - rows) + np.int32(mm.num_rows - 1)
        num_diags = int(np.count_nonzero(np.bincount(
            diag, minlength=nspan)))
    else:
        # hyper-sparse huge dimensions: the bincount span would be
        # multi-GB (or overflow int32) — same guard as
        # DiaMatrix._from_coo; fall back to an nnz-sized unique
        rows = mm.rows_1based.astype(np.int64) - 1
        cols = mm.cols_1based.astype(np.int64) - 1
        num_diags = int(np.unique(cols - rows).size)
    dia_fill = (
        num_diags * mm.num_rows / max(mm.num_entries, 1)
    )
    rationale["num_diagonals"] = num_diags
    rationale["dia_fill"] = dia_fill
    if dia_fill <= DIA_MAX_FILL:
        rationale["format"] = "dia"
        return DiaMatrix.from_matrix_market(mm), rationale

    if workload == "spmm":
        # An SpMM-heavy caller with dense block structure belongs on
        # the MXU: each stored (block_rows x 128) tile feeds dense
        # dot products against the whole X panel, so BSR beats the
        # gather formats once fill is reasonable.
        from spmv_tpu_torch.models.bsr import BLOCK, BsrMatrix

        counts = BsrMatrix.block_counts(rows, cols, mm.num_columns)
        bh = min(
            (128, 64, 32, 16, 8),
            key=lambda h: (counts[h] * h * BLOCK, -h),
        )
        nb = counts[bh]
        bsr_fill = nb * bh * BLOCK / max(mm.num_entries, 1)
        rationale["bsr_fill"] = bsr_fill
        rationale["bsr_block_rows"] = bh
        if bsr_fill <= BSR_SPMM_MAX_FILL:
            rationale["format"] = "bsr"
            return (
                BsrMatrix.from_matrix_market(mm, block_rows=bh),
                rationale,
            )

    well = WellMatrix.from_matrix_market(mm, window_rows=window_rows)
    rationale["well_spill"] = well.spill_fraction
    rationale["well_fill"] = well.fill_ratio
    if (well.spill_fraction <= WELL_MAX_SPILL
            and well.fill_ratio <= WELL_MAX_FILL):
        rationale["format"] = "well"
        return well, rationale

    if try_rcm and mm.num_rows == mm.num_columns:
        from spmv_tpu_torch.models.reorder import (
            find_new_order_rcm,
            find_new_order_sigma,
        )

        mm_rcm = mm.permute(find_new_order_rcm(mm))
        well_rcm = WellMatrix.from_matrix_market(
            mm_rcm, window_rows=window_rows
        )
        rationale["well_rcm_spill"] = well_rcm.spill_fraction
        rationale["well_rcm_fill"] = well_rcm.fill_ratio
        if (well_rcm.spill_fraction <= WELL_MAX_SPILL
                and well_rcm.fill_ratio <= WELL_MAX_FILL):
            rationale["format"] = "well+rcm"
            rationale["note"] = (
                "matrix was RCM-reordered; vectors must be permuted "
                "accordingly"
            )
            return well_rcm, rationale

        # sigma row sort: groups rows of similar length so per-slot
        # windows align — catches length-skewed matrices RCM leaves
        # scattered
        mm_sig = mm.permute(find_new_order_sigma(mm))
        well_sig = WellMatrix.from_matrix_market(
            mm_sig, window_rows=window_rows
        )
        rationale["well_sigma_spill"] = well_sig.spill_fraction
        rationale["well_sigma_fill"] = well_sig.fill_ratio
        if (well_sig.spill_fraction <= WELL_MAX_SPILL
                and well_sig.fill_ratio <= WELL_MAX_FILL):
            rationale["format"] = "well+sigma"
            rationale["note"] = (
                "matrix was sigma-sorted; vectors must be permuted "
                "accordingly"
            )
            return well_sig, rationale

    # Scattered columns: chunk-window WELL — structurally spill-free
    # (band-adaptive anchored windows + the pooled tail; the remainder
    # is pathological multiplicity only, ~zero with the default
    # spec), so there is no performance cliff and no CSR fallback on
    # the device path.
    cw = WellCwMatrix.from_matrix_market(mm)
    rationale["format"] = "wellcw"
    rationale["wellcw_fill"] = cw.fill_ratio
    rationale["wellcw_remainder"] = cw.remainder_fraction

    # SpMV picks WELL-CW, but if the pattern has dense block structure
    # an SpMM-heavy caller should have passed workload="spmm" (which
    # selects BSR outright above) — surface the hint in the rationale
    # for callers on the default workload.
    from spmv_tpu_torch.models.bsr import BLOCK, BsrMatrix

    rows0 = mm.rows_1based.astype(np.int64) - 1
    cols0 = mm.cols_1based.astype(np.int64) - 1
    bh = BsrMatrix.choose_block_rows(rows0, cols0, mm.num_columns)
    nb = np.unique(
        (rows0 // bh) * (mm.num_columns // BLOCK + 1) + cols0 // BLOCK
    ).size
    bsr_fill = nb * bh * BLOCK / max(mm.num_entries, 1)
    if bsr_fill <= 4.0:
        rationale["note"] = (
            f"dense block structure detected (BSR fill {bsr_fill:.2f} "
            f"at block_rows={bh}); for SpMM-heavy workloads consider "
            "-s bsr"
        )
        rationale["bsr_fill"] = bsr_fill
        rationale["bsr_block_rows"] = bh
    return cw, rationale

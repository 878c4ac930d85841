"""DIA (diagonal) storage format — a TPU-native addition.

The reference stores only COO/CSR/ELL/hybrid (SURVEY.md §2); all of its
kernels gather ``x[j]`` through an index array.  TPUs have no gather
hardware — on the target chip arbitrary in-VMEM gathers either lower to
scalar loops or miscompile (experiments/tpu_probe3_gather2.py) — so the
idiomatic TPU formulation for banded/stencil matrices is by diagonals:

    y[i] = sum_k data[k, i] * x[i + offsets[k]]

Every x access becomes a *contiguous shifted window*, i.e. pure
streaming FMAs on the VPU with zero index traffic.  For the reference's
own test matrices (poisson2D 5-point stencils, SuiteSparse 1138_bus
after RCM) this covers all or nearly all nonzeros; the measured win on
a v5e chip is ~400x over the segment-sum formulation
(experiments/tpu_probe5_formulations.py).

Layout follows the classic DIA convention (row-indexed):
``data[k, i] = A[i, i + offsets[k]]`` with zeros where the column falls
outside [0, num_columns) or where A has no entry.

The port's copy of ``spmv_tpu/models/dia.py``: the same code, importing
the port's copies instead of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.io.matrix_market import MatrixMarket, VALUE_DTYPE
from spmv_tpu_torch.models._convert import require_coordinate
from spmv_tpu_torch.models.csr import CsrMatrix

__all__ = ["DiaMatrix"]


@dataclasses.dataclass
class DiaMatrix:
    num_rows: int
    num_columns: int
    num_entries: int           # stored nonzeros (explicit entries)
    offsets: np.ndarray        # (D,) int64, sorted ascending, distinct
    data: np.ndarray           # (D, num_rows) float64

    format_name = "dia"

    # ------------------------------------------------------------------
    @classmethod
    def from_matrix_market(
        cls, mm: MatrixMarket, max_diagonals: int | None = None
    ) -> "DiaMatrix":
        # No row-major sort: _from_coo is order-invariant (offsets and
        # data cells are content-addressed), so the nnz-sized sort is
        # pure setup waste at large nnz (~10 s at 84M entries).
        require_coordinate(mm)
        rows = mm.rows_1based.astype(np.int32, copy=False) - 1
        cols = mm.cols_1based.astype(np.int32, copy=False) - 1
        vals = np.asarray(mm.values, dtype=VALUE_DTYPE)
        return cls._from_coo(
            mm.num_rows, mm.num_columns, rows, cols, vals, max_diagonals
        )

    @classmethod
    def from_csr(
        cls, m: CsrMatrix, max_diagonals: int | None = None
    ) -> "DiaMatrix":
        lengths = np.diff(m.row_ptr)
        rows = np.repeat(
            np.arange(m.num_rows, dtype=np.int64), lengths
        )
        cols = np.asarray(m.column_index, dtype=np.int64)
        vals = np.asarray(m.value, dtype=VALUE_DTYPE)
        # CSR alignment padding carries (column 0, value 0) entries that
        # are indistinguishable from real explicit zeros at column 0, so
        # only unpadded CSR converts losslessly.
        if int(m.row_ptr[-1]) != m.num_entries:
            raise MatrixError(
                "DiaMatrix.from_csr requires an unpadded CSR "
                "(row_alignment == 1)"
            )
        return cls._from_coo(
            m.num_rows, m.num_columns, rows, cols, vals, max_diagonals
        )

    @classmethod
    def _from_coo(cls, num_rows, num_columns, rows, cols, vals,
                  max_diagonals):
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        nspan = num_rows + num_columns - 1
        fast = (
            vals.size
            and np.issubdtype(vals.dtype, np.floating)
            and nspan <= (1 << 28)
            and max(num_rows, num_columns) < (1 << 31)
        )
        if fast:
            # Occupancy bincount over the shifted-diagonal axis
            # replaces unique + searchsorted + add.at — same results,
            # no nnz-sized sorts, int32 temporaries (first-touch page
            # faults price every nnz-sized buffer on the target host;
            # see bench.py).  Duplicate (i, j) entries sum, matching
            # the general sparse convention.
            r32 = rows.astype(np.int32, copy=False)
            c32 = cols.astype(np.int32, copy=False)
            shifted = (c32 - r32) + np.int32(num_rows - 1)
            occ = np.bincount(shifted, minlength=nspan).astype(bool)
            offsets = np.flatnonzero(occ) - (num_rows - 1)
            if (max_diagonals is not None
                    and offsets.size > max_diagonals):
                raise MatrixError(
                    f"matrix has {offsets.size} distinct diagonals "
                    f"(> max_diagonals={max_diagonals}); DIA would be "
                    f"inefficient — use CSR/ELL/hybrid instead"
                )
            lut = np.cumsum(occ, dtype=np.int32) - np.int32(1)
            k = lut[shifted]
            cells = offsets.size * num_rows
            idx_t = np.int32 if cells < (1 << 31) else np.int64
            flat = (k.astype(idx_t, copy=False) * idx_t(num_rows)
                    + r32.astype(idx_t, copy=False))
            data = np.bincount(
                flat, weights=vals, minlength=max(cells, 1)
            ).astype(VALUE_DTYPE, copy=False)[:cells].reshape(
                offsets.size, num_rows)
            return cls(
                num_rows=int(num_rows),
                num_columns=int(num_columns),
                num_entries=int(rows.size),
                offsets=offsets,
                data=data,
            )
        rows = rows.astype(np.int64, copy=False)
        cols = cols.astype(np.int64, copy=False)
        offs_per_entry = cols - rows
        offsets = np.unique(offs_per_entry)
        if max_diagonals is not None and offsets.size > max_diagonals:
            raise MatrixError(
                f"matrix has {offsets.size} distinct diagonals "
                f"(> max_diagonals={max_diagonals}); DIA would be "
                f"inefficient — use CSR/ELL/hybrid instead"
            )
        data = np.zeros((offsets.size, num_rows), dtype=VALUE_DTYPE)
        k = np.searchsorted(offsets, offs_per_entry)
        # Duplicate (i, j) entries sum, matching the general sparse
        # convention (the reference keeps duplicates as-is in COO but
        # its MM files never contain duplicates).
        np.add.at(data, (k, rows), vals)
        return cls(
            num_rows=int(num_rows),
            num_columns=int(num_columns),
            num_entries=int(rows.size),
            offsets=offsets,
            data=data,
        )

    # ------------------------------------------------------------------
    @property
    def num_diagonals(self) -> int:
        return int(self.offsets.size)

    @property
    def fill_ratio(self) -> float:
        """stored-slots / nonzeros — DIA is profitable when close to 1."""
        slots = self.data.size
        return slots / max(self.num_entries, 1)

    def memory_usage_bytes(self) -> int:
        return self.offsets.nbytes + self.data.nbytes

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """NumPy reference SpMV (fp64 correctness gate)."""
        x = np.asarray(x)
        n, m = self.num_rows, self.num_columns
        y = np.zeros(n, dtype=np.result_type(self.data, x))
        for k, off in enumerate(self.offsets):
            off = int(off)
            lo = max(0, -off)
            hi = min(n, m - off)
            if hi <= lo:
                continue
            y[lo:hi] += self.data[k, lo:hi] * x[lo + off:hi + off]
        return y

    def __matmul__(self, x):
        return self.spmv(x)

    def to_dense(self) -> np.ndarray:
        A = np.zeros((self.num_rows, self.num_columns), dtype=VALUE_DTYPE)
        for k, off in enumerate(self.offsets):
            off = int(off)
            lo = max(0, -off)
            hi = min(self.num_rows, self.num_columns - off)
            if hi > lo:
                i = np.arange(lo, hi)
                A[i, i + off] = self.data[k, lo:hi]
        return A

"""BSR: block-sparse rows with dense (block_rows, 128) blocks — the MXU format.

Third TPU-native format (with DIA and WELL; no reference counterpart —
the reference's formats are all entry-wise, SURVEY.md §2).  SpMV is
bandwidth-bound and belongs to DIA/WELL; BSR exists for the workloads
where the MXU matters: matrices with *dense block structure* (FEM,
multi-dof meshes) multiplied against **blocks of vectors** (SpMM).
Each stored block is a dense (block_rows, 128) tile — block_rows is
any multiple of 8 up to 128 (narrower blocks trade MXU utilization for
less zero fill on finer-grained structure) — and the kernel's inner op

    Y_block(block_rows, k) += A_block(block_rows, 128) @ X_block(128, k)

is a native systolic-array matmul at full utilization when
block_rows = k = 128.  ``block_rows="auto"`` picks the height with the
lowest storage fill.

Storage: ``block_col`` / ``block_rowptr`` index nonzero blocks in
block-row-major order; ``blocks`` holds them dense.  ``fill_ratio``
(stored slots / nnz) decides when BSR is worth it: below ~8 the MXU's
flops-per-byte advantage beats the zero-padding traffic for SpMM.

The port's copy of ``spmv_tpu/models/bsr.py``: the same code,
importing the port's copies instead of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.io.matrix_market import MatrixMarket, VALUE_DTYPE
from spmv_tpu_torch.models._convert import require_coordinate
from spmv_tpu_torch.models.csr import CsrMatrix

__all__ = ["BsrMatrix", "BLOCK"]

BLOCK = 128


@dataclasses.dataclass
class BsrMatrix:
    num_rows: int
    num_columns: int
    num_entries: int
    blocks: np.ndarray        # (NB, block_rows, 128) float64 dense
    block_col: np.ndarray     # (NB,) int32 block-column index
    block_rowptr: np.ndarray  # (num_block_rows + 1,) int64
    block_rows: int = BLOCK   # block height (multiple of 8, <= 128)

    format_name = "bsr"

    # ------------------------------------------------------------------
    @classmethod
    def from_matrix_market(
        cls, mm: MatrixMarket, max_fill: float | None = None,
        block_rows: int | str = BLOCK,
    ) -> "BsrMatrix":
        # No row-major sort: the occupancy-bincount _build is
        # order-invariant (entries land in content-addressed bins), so
        # the nnz-sized radix sort other formats need (~10 s at 67M
        # entries) is pure waste here.
        require_coordinate(mm)
        rows = mm.rows_1based.astype(np.int32, copy=False) - 1
        cols = mm.cols_1based.astype(np.int32, copy=False) - 1
        vals = np.asarray(mm.values, dtype=VALUE_DTYPE)
        return cls._build(
            mm.num_rows, mm.num_columns, rows, cols, vals, max_fill,
            block_rows,
        )

    @classmethod
    def from_csr(
        cls, m: CsrMatrix, max_fill: float | None = None,
        block_rows: int | str = BLOCK,
    ) -> "BsrMatrix":
        if int(m.row_ptr[-1]) != m.num_entries:
            raise MatrixError("BsrMatrix.from_csr requires unpadded CSR")
        rows = np.repeat(
            np.arange(m.num_rows, dtype=np.int64), np.diff(m.row_ptr)
        )
        return cls._build(
            m.num_rows, m.num_columns, rows,
            np.asarray(m.column_index, np.int64),
            np.asarray(m.value), max_fill, block_rows,
        )

    @staticmethod
    def block_counts(rows, cols, num_columns) -> dict:
        """{block height: occupied (rows//bh, cols//128) block count}
        for every height 128/64/32/16/8.

        One bincount occupancy pass at the finest height (8); every
        coarser height's block count is an any-reduction over groups
        of fine block-rows — identical to unique((rows//bh, cols//128))
        per height, without five nnz-sized sorts (the old path cost
        ~40 s at 67M entries; this is ~1 s)."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        ncb = num_columns // BLOCK + 1
        if rows.size == 0:
            return {bh: 0 for bh in (128, 64, 32, 16, 8)}
        # Pad fine block-rows to a multiple of 128//8 so every height
        # reshapes cleanly.
        nbr8 = (int(rows.max()) // 8 + 1 + 15) // 16 * 16
        nbins = nbr8 * ncb
        if nbins > (1 << 28):  # degenerate hyper-sparse shapes
            rows = rows.astype(np.int64, copy=False)
            cols = cols.astype(np.int64, copy=False)
            return {
                bh: int(np.unique(
                    (rows // bh) * ncb + cols // BLOCK).size)
                for bh in (128, 64, 32, 16, 8)
            }
        # nbins <= 2^28 means the key fits int32: keep every
        # nnz-length temporary 4-byte — on this host first-touch page
        # faults dominate (see bench.py), so bytes allocated ≈ time.
        r32 = rows.astype(np.int32, copy=False)
        c32 = cols.astype(np.int32, copy=False)
        key8 = (r32 >> 3) * np.int32(ncb) + (c32 >> 7)
        occ = np.bincount(key8, minlength=nbins).astype(bool)
        occ = occ.reshape(nbr8, ncb)
        return {
            bh: int(occ.reshape(nbr8 // (bh // 8), bh // 8, ncb)
                    .any(1).sum())
            for bh in (128, 64, 32, 16, 8)
        }

    @staticmethod
    def choose_block_rows(rows, cols, num_columns) -> int:
        """The block height (of 8..128) with the lowest storage fill
        for this sparsity pattern (stored slots per nonzero)."""
        counts = BsrMatrix.block_counts(rows, cols, num_columns)
        n = max(np.asarray(rows).size, 1)
        best_bh, best_fill = BLOCK, np.inf
        for bh in (128, 64, 32, 16, 8):
            fill = counts[bh] * bh * BLOCK / n
            if fill < best_fill:
                best_bh, best_fill = bh, fill
        return best_bh

    @classmethod
    def _build(cls, num_rows, num_columns, rows, cols, vals, max_fill,
               block_rows=BLOCK):
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        if block_rows == "auto":
            block_rows = cls.choose_block_rows(rows, cols, num_columns)
        bh = int(block_rows)
        if bh <= 0 or bh > BLOCK or bh % 8:
            raise MatrixError(
                f"block_rows must be a multiple of 8 in [8, {BLOCK}]; "
                f"got {block_rows!r}"
            )
        nbr = max(-(-num_rows // bh), 1)
        ncb_p = num_columns // BLOCK + 1
        nbins = nbr * ncb_p
        # Occupancy bincount + cumsum lookup table replaces
        # np.unique(key, return_inverse=True): uniq is the ascending
        # occupied-bin list, inv a gather through the table — same
        # result, no nnz-sized sort (~25 s saved at 67M entries).
        # int32 temporaries throughout: first-touch page faults are
        # ~5 ms/MB on the target host, so halving bytes halves wall
        # time (the key fits int32 whenever nbins <= 2^28).
        # The fast path also needs the raw coordinates to fit int32
        # (same guard as DiaMatrix._from_coo / generate.py): int64
        # rows >= 2^31 with a narrow column count would pass the
        # nbins gate yet overflow rows.astype(int32).
        if (vals.size and nbins <= (1 << 28)
                and max(num_rows, num_columns) < (1 << 31)):
            r32 = rows.astype(np.int32, copy=False)
            c32 = cols.astype(np.int32, copy=False)
            key = (r32 // np.int32(bh)) * np.int32(ncb_p) + (c32 >> 7)
            occ = np.bincount(key, minlength=nbins).astype(bool)
            uniq = np.flatnonzero(occ)
            lut = np.cumsum(occ, dtype=np.int32) - np.int32(1)
            inv = lut[key]
        else:
            rows = rows.astype(np.int64, copy=False)
            cols = cols.astype(np.int64, copy=False)
            key = (rows // bh) * ncb_p + cols // BLOCK
            uniq, inv = np.unique(key, return_inverse=True)
        nb = uniq.size
        if max_fill is not None and vals.size:
            fill = nb * bh * BLOCK / vals.size
            if fill > max_fill:
                raise MatrixError(
                    f"BSR fill ratio {fill:.1f} exceeds max_fill="
                    f"{max_fill}; the matrix has no dense block "
                    "structure — use WELL/CSR instead"
                )
        vals_arr = np.asarray(vals)
        if vals_arr.size and np.issubdtype(vals_arr.dtype, np.floating):
            # One weighted-bincount pass sums duplicates into the
            # dense blocks (np.add.at is ~6x slower at this size).
            # int64 remainder is the hidden cost here: a bitwise mask
            # when bh is a power of two (8/16/32/64/128; not 24 etc.)
            # is ~5x cheaper than %.
            rrem = rows & (bh - 1) if bh & (bh - 1) == 0 else rows % bh
            cell = max(nb, 1) * bh * BLOCK
            idx_t = np.int32 if cell < (1 << 31) else np.int64
            flat = (inv.astype(idx_t, copy=False) * idx_t(bh * BLOCK)
                    + rrem.astype(idx_t, copy=False) * idx_t(BLOCK)
                    + (cols & (BLOCK - 1)))
            blocks = np.bincount(
                flat, weights=vals_arr, minlength=max(nb, 1) * bh * BLOCK
            ).astype(VALUE_DTYPE, copy=False).reshape(
                max(nb, 1), bh, BLOCK)
        else:
            blocks = np.zeros((max(nb, 1), bh, BLOCK), dtype=VALUE_DTYPE)
            np.add.at(
                blocks, (inv, rows % bh, cols % BLOCK), vals
            )
        u_bi = (uniq // (num_columns // BLOCK + 1)).astype(np.int64)
        u_bj = (uniq % (num_columns // BLOCK + 1)).astype(np.int32)
        if nb == 0:
            u_bi = u_bi[:0]
            u_bj = u_bj[:0]
            blocks = blocks[:0]
        # The Pallas kernel initializes an output block only when its
        # first block arrives: give every EMPTY block-row one inert
        # zero block so no output tile stays unwritten.
        lengths = np.bincount(u_bi, minlength=nbr)
        empty = np.nonzero(lengths == 0)[0]
        if empty.size:
            u_bi = np.concatenate([u_bi, empty])
            u_bj = np.concatenate(
                [u_bj, np.zeros(empty.size, dtype=np.int32)]
            )
            blocks = np.concatenate([
                blocks,
                np.zeros((empty.size, bh, BLOCK), dtype=VALUE_DTYPE),
            ])
            order = np.argsort(u_bi, kind="stable")
            u_bi, u_bj, blocks = u_bi[order], u_bj[order], blocks[order]
            lengths = np.bincount(u_bi, minlength=nbr)
        rowptr = np.zeros(nbr + 1, dtype=np.int64)
        np.cumsum(lengths, out=rowptr[1:])
        return cls(
            num_rows=int(num_rows),
            num_columns=int(num_columns),
            num_entries=int(rows.size),
            blocks=blocks,
            block_col=u_bj,
            block_rowptr=rowptr,
            block_rows=bh,
        )

    # ------------------------------------------------------------------
    @property
    def num_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def num_block_rows(self) -> int:
        return int(self.block_rowptr.size - 1)

    @property
    def fill_ratio(self) -> float:
        return self.blocks.size / max(self.num_entries, 1)

    def memory_usage_bytes(self) -> int:
        return (self.blocks.nbytes + self.block_col.nbytes
                + self.block_rowptr.nbytes)

    def spmm(self, X: np.ndarray) -> np.ndarray:
        """NumPy reference SpMM (fp64 correctness gate)."""
        X = np.asarray(X)
        k = X.shape[1]
        ncb = -(-self.num_columns // BLOCK)
        Xp = np.zeros((ncb * BLOCK, k), dtype=np.result_type(
            self.blocks, X))
        Xp[: X.shape[0]] = X
        bh = self.block_rows
        Y = np.zeros((self.num_block_rows * bh, k), dtype=Xp.dtype)
        for br in range(self.num_block_rows):
            s, e = self.block_rowptr[br], self.block_rowptr[br + 1]
            for t in range(s, e):
                bj = int(self.block_col[t])
                Y[br * bh:(br + 1) * bh] += (
                    self.blocks[t] @ Xp[bj * BLOCK:(bj + 1) * BLOCK]
                )
        return Y[: self.num_rows]

    def spmv(self, x: np.ndarray) -> np.ndarray:
        return self.spmm(np.asarray(x)[:, None])[:, 0]

    def __matmul__(self, x):
        x = np.asarray(x)
        return self.spmv(x) if x.ndim == 1 else self.spmm(x)

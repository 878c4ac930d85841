"""WELL: windowed sliced-ELLPACK — the TPU-native general-sparse format.

No reference counterpart (the reference's general formats are
gather-based CSR/ELL, src/matrix/csr-matrix.cpp / ell-matrix.cpp, which
assume cheap random access to x).  TPUs have no gather hardware, and on
the target chip arbitrary sublane gathers inside Pallas miscompile
(experiments/tpu_probe3_gather2.py); the one reliable primitive is the
*lane shuffle* — an arbitrary per-lane pick from a 128-wide row
(take_along_axis axis=1, probe 11a).  WELL re-expresses SpMV so that
every x access is such a pick:

- rows are grouped into **groups of 128 consecutive rows** (one lane
  row of the framework's (.., 128) 2-D vector layout);
- a group's entries are stored slot-major in **chunks of (8 slots x
  128 rows)**: element (s, r) of a chunk is the (chunk_slot*8+s)-th
  stored nonzero of row (group*128 + r) — the sliced-ELL idea with the
  *row* dimension in lanes, so that a slot's columns track the row
  index and stay within a narrow window even for banded matrices;
- each (chunk, slot) sublane carries its **own column window start**;
  slot s's local indices address x[ws[s]*128 ... ws[s]*128 + m*128).
  Because a slot's columns track the row index, 128 consecutive rows
  span ~128 + jitter columns, so m = window_rows stays tiny (2 for
  stencil matrices, 2-4 after RCM).  The kernel assembles the (8, 128)
  gather table with one dynamic (1, 128) slice per slot and does one
  lane shuffle + select per window row (probe 11d);
- entries whose column falls outside their chunk's window **spill** to
  a CSR remainder evaluated on the XLA segment-sum path and added in.

The spill fraction and fill ratio are reported so callers can pick
window_rows per matrix (models.reorder's RCM reduces both).

The port's copy of ``spmv_tpu/models/well.py``: the same code, importing
the port's copies instead of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.io.matrix_market import MatrixMarket, VALUE_DTYPE
from spmv_tpu_torch.models._convert import sorted_entries_0based
from spmv_tpu_torch.models.csr import CsrMatrix

__all__ = ["WellMatrix", "GROUP_ROWS", "SLOT_SUBLANES"]

GROUP_ROWS = 128       # rows per group (lane dimension)
SLOT_SUBLANES = 8      # slots per chunk (sublane dimension)
LANE = 128


@dataclasses.dataclass
class WellMatrix:
    num_rows: int
    num_columns: int
    num_entries: int            # total stored nonzeros (incl. spilled)
    window_rows: int            # m: window = m * 128 columns
    value: np.ndarray           # (chunks, 8, 128) float64
    local_index: np.ndarray     # (chunks, 8, 128) int32, in [0, m*128)
    window_start: np.ndarray    # (chunks, 8) int32 — per-slot x2d row
    group_of_chunk: np.ndarray  # (chunks,) int32 — owning 128-row group
    spill: CsrMatrix | None     # out-of-window remainder (or None)

    format_name = "well"

    # ------------------------------------------------------------------
    @classmethod
    def from_matrix_market(
        cls, mm: MatrixMarket, window_rows: int = 4
    ) -> "WellMatrix":
        rows, cols, vals, row_ptr = sorted_entries_0based(mm)
        return cls._build(
            mm.num_rows, mm.num_columns, row_ptr, cols, vals, window_rows
        )

    @classmethod
    def from_csr(cls, m: CsrMatrix, window_rows: int = 4) -> "WellMatrix":
        if int(m.row_ptr[-1]) != m.num_entries:
            raise MatrixError(
                "WellMatrix.from_csr requires an unpadded CSR"
            )
        return cls._build(
            m.num_rows, m.num_columns, m.row_ptr,
            np.asarray(m.column_index), np.asarray(m.value), window_rows
        )

    @staticmethod
    def _best_window(c: np.ndarray, wcols: int) -> int:
        """Lane-aligned window start covering the most of sorted cols c."""
        if c.size == 0:
            return 0
        starts = (c // LANE) * LANE
        # two-pointer: for each aligned candidate start, count covered
        ends = np.searchsorted(c, starts + wcols, side="left")
        begins = np.arange(c.size)
        best = int(np.argmax(ends - begins))
        return int(starts[best] // LANE)

    @classmethod
    def _build(cls, num_rows, num_columns, row_ptr, cols, vals,
               window_rows, max_rounds: int = 4,
               use_native: bool = True):
        if window_rows < 1:
            raise MatrixError("window_rows must be >= 1")
        row_ptr = np.asarray(row_ptr, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=VALUE_DTYPE)

        from spmv_tpu_torch.models import _well_native

        if use_native and _well_native.available():
            (value, local_index, window_start, group_of_chunk,
             sp_r, sp_c, sp_v) = _well_native.pack(
                num_rows, num_columns, row_ptr, cols, vals,
                window_rows, max_rounds,
            )
        else:
            (value, local_index, window_start, group_of_chunk,
             sp_r, sp_c, sp_v) = cls._pack_py(
                num_rows, row_ptr, cols, vals, window_rows, max_rounds
            )

        spill = None
        if sp_r.size:
            order = np.lexsort((sp_c, sp_r))
            r, c, v = sp_r[order], sp_c[order], sp_v[order]
            sp_lengths = np.bincount(r, minlength=num_rows)
            sp_ptr = np.zeros(num_rows + 1, dtype=np.int64)
            np.cumsum(sp_lengths, out=sp_ptr[1:])
            spill = CsrMatrix(
                num_rows, num_columns, int(r.size), 1,
                sp_ptr, c.astype(np.int32), v,
            )

        return cls(
            num_rows=int(num_rows),
            num_columns=int(num_columns),
            num_entries=int(row_ptr[-1]),
            window_rows=int(window_rows),
            value=value,
            local_index=local_index,
            window_start=window_start,
            group_of_chunk=group_of_chunk,
            spill=spill,
        )

    @classmethod
    def _pack_py(cls, num_rows, row_ptr, cols, vals, window_rows,
                 max_rounds):
        m = int(window_rows)
        wcols = m * LANE
        row_ptr = np.asarray(row_ptr, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        num_groups = max(-(-num_rows // GROUP_ROWS), 1)

        chunk_val, chunk_loc, chunk_ws, chunk_grp = [], [], [], []

        # Entries are packed in rounds: each round packs per-row runs
        # of up to 8 slots into chunks with best-coverage windows;
        # entries a window cannot cover go to the next round, and only
        # the final leftovers spill to the CSR remainder.
        rows_cur = np.repeat(
            np.arange(num_rows, dtype=np.int64), np.diff(row_ptr)
        )
        cols_cur, vals_cur = cols, vals

        for round_no in range(max_rounds):
            if rows_cur.size == 0:
                break
            if round_no > 0:
                # Only spend another packing round when the leftovers
                # are dense enough that the new chunks would be at
                # least ~25% full — sparse stragglers (e.g. 1-2
                # boundary entries per group) cost a whole 1024-slot
                # chunk each and are cheaper on the CSR spill path.
                n_groups_left = np.unique(
                    rows_cur // GROUP_ROWS
                ).size
                if rows_cur.size < 256 * n_groups_left:
                    break
            next_r, next_c, next_v = [], [], []
            lengths = np.bincount(rows_cur, minlength=num_rows)
            rp = np.zeros(num_rows + 1, dtype=np.int64)
            np.cumsum(lengths, out=rp[1:])
            for g in range(num_groups):
                r0 = g * GROUP_ROWS
                r1 = min(r0 + GROUP_ROWS, num_rows)
                glen = lengths[r0:r1]
                max_len = int(glen.max()) if r1 > r0 else 0
                n_sc = -(-max_len // SLOT_SUBLANES) if max_len else 0
                for sc in range(n_sc):
                    s0 = sc * SLOT_SUBLANES
                    val_t = np.zeros((SLOT_SUBLANES, GROUP_ROWS),
                                     dtype=VALUE_DTYPE)
                    loc_t = np.zeros((SLOT_SUBLANES, GROUP_ROWS),
                                     dtype=np.int64)
                    col_t = np.full((SLOT_SUBLANES, GROUP_ROWS), -1,
                                    dtype=np.int64)
                    for s in range(SLOT_SUBLANES):
                        has = glen > (s0 + s)
                        ridx = np.nonzero(has)[0]
                        if ridx.size == 0:
                            continue
                        k = rp[r0:r1][has] + s0 + s
                        col_t[s, ridx] = cols_cur[k]
                        val_t[s, ridx] = vals_cur[k]
                    present = col_t >= 0
                    if not present.any():
                        continue
                    ws = np.zeros(SLOT_SUBLANES, dtype=np.int64)
                    for s in range(SLOT_SUBLANES):
                        pr = present[s]
                        if pr.any():
                            ws[s] = cls._best_window(
                                np.sort(col_t[s][pr]), wcols
                            )
                    local = col_t - ws[:, None] * LANE
                    inside = present & (local >= 0) & (local < wcols)
                    loc_t[inside] = local[inside]
                    out = present & ~inside
                    if out.any():
                        s_idx, r_idx = np.nonzero(out)
                        next_r.extend((r0 + r_idx).tolist())
                        next_c.extend(col_t[out].tolist())
                        next_v.extend(val_t[out].tolist())
                        val_t[out] = 0.0
                    chunk_val.append(val_t)
                    chunk_loc.append(loc_t.astype(np.int32))
                    chunk_ws.append(ws.astype(np.int32))
                    chunk_grp.append(g)
            if next_r:
                order = np.lexsort((next_c, next_r))
                rows_cur = np.asarray(next_r, dtype=np.int64)[order]
                cols_cur = np.asarray(next_c, dtype=np.int64)[order]
                vals_cur = np.asarray(next_v, dtype=VALUE_DTYPE)[order]
            else:
                rows_cur = np.empty(0, dtype=np.int64)
                break

        n_sp = rows_cur.size
        sp_r = rows_cur
        sp_c = cols_cur[:n_sp] if n_sp else np.empty(0, np.int64)
        sp_v = vals_cur[:n_sp] if n_sp else np.empty(0, VALUE_DTYPE)

        # The Pallas kernel zeroes an output block only when its first
        # chunk arrives: any 8-group output block with NO chunks at all
        # would stay uninitialized.  Insert one zero chunk per empty
        # block and keep chunks sorted by group.
        num_groups = max(-(-num_rows // GROUP_ROWS), 1)
        num_blocks = -(-num_groups // 8)
        seen = {g // 8 for g in chunk_grp}
        for blk in range(num_blocks):
            if blk not in seen:
                chunk_val.append(np.zeros((SLOT_SUBLANES, GROUP_ROWS),
                                          dtype=VALUE_DTYPE))
                chunk_loc.append(np.zeros((SLOT_SUBLANES, GROUP_ROWS),
                                          dtype=np.int32))
                chunk_ws.append(np.zeros(SLOT_SUBLANES, dtype=np.int32))
                chunk_grp.append(blk * 8)
        order = np.argsort(np.asarray(chunk_grp), kind="stable")
        value = np.stack([chunk_val[i] for i in order])
        local_index = np.stack(
            [chunk_loc[i] for i in order]
        ).astype(np.int32)
        window_start = np.stack(
            [chunk_ws[i] for i in order]
        ).astype(np.int32)
        group_of_chunk = np.asarray(
            [chunk_grp[i] for i in order], dtype=np.int32
        )
        return (value, local_index, window_start, group_of_chunk,
                sp_r, sp_c, sp_v)

    # ------------------------------------------------------------------
    @property
    def num_chunks(self) -> int:
        return int(self.value.shape[0])

    @property
    def num_groups(self) -> int:
        return max(-(-self.num_rows // GROUP_ROWS), 1)

    @property
    def num_spilled(self) -> int:
        return 0 if self.spill is None else self.spill.num_entries

    @property
    def spill_fraction(self) -> float:
        return self.num_spilled / max(self.num_entries, 1)

    @property
    def fill_ratio(self) -> float:
        """stored slots / nonzeros kept in WELL chunks."""
        kept = self.num_entries - self.num_spilled
        return self.value.size / max(kept, 1)

    def memory_usage_bytes(self) -> int:
        b = (self.value.nbytes + self.local_index.nbytes
             + self.window_start.nbytes + self.group_of_chunk.nbytes)
        if self.spill is not None:
            b += self.spill.memory_usage_bytes()
        return b

    def spmv(self, x: np.ndarray) -> np.ndarray:
        """NumPy reference SpMV (fp64 correctness gate)."""
        x = np.asarray(x)
        n = self.num_rows
        y = np.zeros(self.num_groups * GROUP_ROWS,
                     dtype=np.result_type(self.value, x))
        xcol = (self.window_start[:, :, None] * LANE
                + self.local_index)                # (chunks, 8, 128)
        xc = np.clip(xcol, 0, self.num_columns - 1)
        contrib = (self.value * x[xc]).sum(axis=1)  # (chunks, 128)
        np.add.at(y.reshape(self.num_groups, GROUP_ROWS),
                  self.group_of_chunk, contrib)
        y = y[:n]
        if self.spill is not None:
            for i in range(n):
                s, e = self.spill.row_ptr[i], self.spill.row_ptr[i + 1]
                if e > s:
                    y[i] += (
                        self.spill.value[s:e]
                        * x[self.spill.column_index[s:e]]
                    ).sum()
        return y

    def __matmul__(self, x):
        return self.spmv(x)

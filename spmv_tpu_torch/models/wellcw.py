"""WELL-CW: chunk-window WELL — the TPU format for *scattered* sparsity.

The per-slot-window WELL (models.well) excels when a row's stored
columns cluster (stencils, RCM-reordered meshes): slot windows hug the
data and fill approaches 1.  When columns are scattered across a wide
band — the irregular-matrix case the reference covers with its hybrid
format (src/matrix/hybrid-matrix.cpp:329-410) — per-slot windows blow
up (31% spill on random-banded, probe 12) and the kernel's per-slot
gather-table assembly (8 single-row dynamic slices per window row per
chunk) is VPU-bound at ~6 Gnnz/s even with zero spill (probe 26).

WELL-CW restructures both the layout and the gather (probes 27-28):

- Each **chunk** of (8 slots x 128 rows) has ONE fixed column window
  of ``8*d`` x2d rows (``1024*d`` columns); windows tile the column
  space (window id = column // (1024 d)), so *every* entry fits some
  window by construction — spill is only multiplicity overflow.
- **Cell positions are forced**: an entry of row r with window-row
  offset w = (col // 128) - anchor lives at slot ``w // d``, lane
  ``r % 128``.  Packing is a vectorized numpy group-by: the k-th
  entry landing on the same (window, slot, lane) goes to the k-th
  chunk at that window ("multiplicity rank").
- The kernel pre-splits x into ``d`` stride-d tables
  ``xt[p] = x2d[p::d]``; slot s of a chunk reads x2d row
  ``anchor + d*s + p`` = ``xt[p][anchor/d + s]`` — so each of the d
  gather tables is ONE contiguous, sublane-aligned dynamic slice
  ``xt[p][a4 : a4+8]``, followed by one lane shuffle
  (take_along_axis) and a select on the entry's phase ``p``.
  ~10x less VPU work per chunk than per-slot windows.
- **Band-adaptive, rank-alternating anchors** (probe 35): anchors are
  per-chunk scalars and the chip handles unaligned dynamic sublane
  slices, so each group's rank-k chunk anchors at its own band start
  (even k) or end (odd k) instead of a fixed column tiling — a
  centered band no longer straddles two windows (which halved cell
  occupancy), and colliding entries get a decorrelated second
  placement.  Measured rank fills on random-banded: 0.62 / 0.28, then
  a nearly-empty tail.
- **Pooled tail** (CwPoolLevel): everything past rank 1 goes to
  chunks shared across the 64 groups of an output block, with a
  per-cell row map freeing the group constraint; the kernel scatters
  each slot row separately there.  The scattered tail packs at ~5x
  the fill per-group chunks manage.
- **Capped stage-1 pool + wide-pool cascade** (probes 42-45): the
  64-group ladder's ranks past ~16 are near-empty queue-draining
  chunks (fill < 0.06), so the stage-1 pool caps at POOL_CAP=16 —
  which also fixes its padded chunk count at exactly 16 per output
  block — and the spill re-pools at 128-group width
  (DEFAULT_TAIL_SPECS), where the thin tail re-concentrates.  A
  spill too thin to fill pool chunks (< 64 entries/pool) goes to the
  CSR remainder instead, which is cheaper below that density.
- **Merged device grid** (probes 46-48, models.device.DeviceCwMerged):
  with cap=2 dense level slots and the 16-chunk stage-1 pool, every
  64-group output block is ONE static 144-chunk grid step — level
  scatter by static scalar row, pool rowmap folded into local_index
  bits 14+.  Removes ~280 ns/step grid overhead and the separate
  pool call entirely.

Measured (honest long-chain timing, random banded n=1M bw=4096
8 nnz/row, the VERDICT #4 cliff case): round 1 tiled windows
5.6 Gnnz/s; round 2 band-adaptive + pooled tail 14.2 Gnnz/s at
588 us; round 3 merged grid + capped cascade **17.8 Gnnz/s at
470 us** (raw CSR: 0.06 Gnnz/s).

The port's copy of ``spmv_tpu/models/wellcw.py``: the same code,
importing the port's copies instead of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from spmv_tpu_torch.errors import MatrixError
from spmv_tpu_torch.io.matrix_market import MatrixMarket, VALUE_DTYPE
from spmv_tpu_torch.models._convert import sorted_entries_0based
from spmv_tpu_torch.models.csr import CsrMatrix

__all__ = ["WellCwMatrix", "CwLevel", "CwPoolLevel", "DEFAULT_LEVELS", "POOL_GROUPS"]

LANE = 128
SUBLANE = 8
GROUP_ROWS = 128

# (d, multiplicity cap, min chunk population) per level.  With
# band-adaptive anchors, per-group ranks 0-1 hold ~90% of a scattered
# matrix's entries at fill ~0.45 (measured: rank fills 0.62 / 0.28,
# then a nearly-empty tail); everything deeper goes to the POOLED
# level (chunks shared across the 64 groups of an output block, cells
# freed by a per-cell row map), which packs the scattered tail at
# ~0.5+ fill where per-group chunks manage ~0.07.
DEFAULT_LEVELS: Tuple[Tuple[int, int, float], ...] = (
    (4, 2, 0.0),
)

POOL_GROUPS = 64          # groups pooled per chunk = one output block
                          # (device uses blocks_per_out=8 when pooled)

# Stage-1 pool ladder depth.  Probes 42-45: ranks past ~16 of a
# 64-group ladder are near-empty queue-draining chunks (fill < 0.06)
# — 2/3 of the pool chunks for ~5% of its entries.  Capping at 16
# keeps the pool at fill ~0.38 AND makes every pool emit exactly 16
# padded chunks (kp=16), which is what lets the device merge pool
# chunks into the level grid (one 144-chunk step per output block).
POOL_CAP = 16

# Spill cascade after the capped stage-1 pool: re-pool the thin tail
# at wider pooling (128 groups re-concentrates what a 64-group ladder
# would chase with junk ranks), then a deep 64-group catch-all so
# extreme-multiplicity matrices (40 entries/row into 64 columns kind)
# still end with a ~zero CSR remainder; whatever survives all stages
# is the true pathological tail.
DEFAULT_TAIL_SPECS: Tuple[Tuple[int, int], ...] = ((128, 16),
                                                   (64, 256))


@dataclasses.dataclass
class CwPoolLevel:
    """Pooled tail level: chunks shared across POOL_GROUPS groups.

    A cell (slot, lane) of a pooled chunk may hold an entry of ANY row
    ``r`` with ``r % 128 == lane`` inside the chunk's pool;
    ``rowmap[c, s, l]`` records the entry's global group.  The kernel
    scatters each slot row separately (8 masked adds per chunk instead
    of one), which only pays on this small level; in exchange the
    scattered tail packs at ~0.5+ fill instead of ~0.07.
    """

    d: int
    value: np.ndarray           # (chunks, 8, 128)
    local_index: np.ndarray     # (chunks, 8, 128) int32: w*128 + lane
    anchor4: np.ndarray         # (chunks,) int32
    rowmap: np.ndarray          # (chunks, 8, 128) int32: global group
    pool_of_chunk: np.ndarray   # (chunks,) int32, non-decreasing
    pool_groups: int = POOL_GROUPS   # groups pooled per chunk
    cap: int = 0                # ladder depth the pool was packed with

    @property
    def num_chunks(self) -> int:
        return int(self.value.shape[0])


@dataclasses.dataclass
class CwLevel:
    """One packing level: all chunks share the window width 1024*d."""

    d: int                      # window = 8*d x2d rows = 1024*d cols
    value: np.ndarray           # (chunks, 8, 128)
    local_index: np.ndarray     # (chunks, 8, 128) int32: w*128 + lane
    anchor4: np.ndarray         # (chunks,) int32: window start / d
                                # (row units of the stride-d tables)
    group_of_chunk: np.ndarray  # (chunks,) int32, non-decreasing
    cap: int = 0                # rank cap the level was packed with
    rank_of_chunk: Optional[np.ndarray] = None  # (chunks,) int64

    @property
    def num_chunks(self) -> int:
        return int(self.value.shape[0])



def _grouped_minmax(key: np.ndarray, vals: np.ndarray, nkeys: int):
    """Per-key (min, max) of ``vals``; fast reduceat path when ``key``
    is non-decreasing (entries are row-sorted on every construction
    path), ufunc.at fallback otherwise (ufunc.at is ~10x slower)."""
    lo = np.full(nkeys, np.iinfo(np.int64).max, dtype=np.int64)
    hi = np.full(nkeys, -1, dtype=np.int64)
    if vals.size == 0:
        return lo, hi
    if np.all(key[1:] >= key[:-1]):
        starts = np.flatnonzero(
            np.concatenate(([True], key[1:] != key[:-1])))
        ks = key[starts]
        lo[ks] = np.minimum.reduceat(vals, starts)
        hi[ks] = np.maximum.reduceat(vals, starts)
    else:
        np.minimum.at(lo, key, vals)
        np.maximum.at(hi, key, vals)
    return lo, hi


def _pack_level(
    num_rows: int,
    num_columns: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    d: int,
    cap: int,
    min_pop: float,
) -> Tuple[CwLevel, np.ndarray]:
    """Pack entries into chunk-window form; returns (level, spilled).

    Band-adaptive, rank-alternating anchors (probe 35): the kernel
    takes an arbitrary per-chunk anchor (and the chip handles
    unaligned dynamic sublane slices), so windows need not tile the
    column space.  Each group's rank-k chunk anchors at the group's
    column-range *start* for even k and *end* for odd k:

    - a centered band never straddles two fixed windows (the tiled
      scheme halved cell occupancy exactly that way), and
    - entries near the top of a wider-than-window band, or colliding
      in a cell, get a decorrelated second placement at the next rank
      instead of stacking at the same cell forever.

    An entry is placed at the first rank whose window contains it and
    whose (slot, lane) cell is free; ``spilled`` returns the rest
    (rank >= cap, or rank >= 1 in a chunk filled below ``min_pop``).
    """
    wd = 8 * d                                 # window rows (x2d)
    g = rows >> 7
    x2drow = cols >> 7
    lane = rows & (GROUP_ROWS - 1)
    ng = max(-(-num_rows // GROUP_ROWS), 1)

    # per-group column range, in xt-row (= d x2d-rows) units
    glo, ghi = _grouped_minmax(g, x2drow, ng)
    a_low = np.maximum(glo // d, 0)
    a_high = np.maximum(-(-(ghi + 1) // d) - SUBLANE, 0)
    a_low = np.where(ghi < 0, 0, a_low)
    a_high = np.where(ghi < 0, 0, a_high)

    placed_rank = np.full(rows.size, -1, dtype=np.int64)
    anchors = np.empty((cap, ng), dtype=np.int64)
    # iterate only over still-unplaced entries: deep caps would
    # otherwise rescan all nnz per rank pass
    remaining = np.arange(rows.size)
    for k in range(cap):
        a4 = a_low if (k % 2 == 0) else a_high
        anchors[k] = a4
        if remaining.size == 0:
            break
        w = x2drow[remaining] - a4[g[remaining]] * d
        cand = (w >= 0) & (w < wd)
        ci = remaining[cand]
        if ci.size == 0:
            continue
        cell = ((g[ci] * SUBLANE) + (w[cand]) // d) * GROUP_ROWS \
            + lane[ci]
        order = np.argsort(cell, kind="stable")
        cs = cell[order]
        first = np.empty(cs.size, dtype=bool)
        first[0] = True
        np.not_equal(cs[1:], cs[:-1], out=first[1:])
        placed_rank[ci[order[first]]] = k
        remaining = remaining[placed_rank[remaining] < 0]

    keep = placed_rank >= 0

    def enumerate_chunks(keep):
        ckey = g[keep] * cap + placed_rank[keep]
        corder = np.argsort(ckey, kind="stable")
        cs = ckey[corder]
        cnew = np.empty(cs.size, dtype=bool)
        if cs.size:
            cnew[0] = True
            np.not_equal(cs[1:], cs[:-1], out=cnew[1:])
        chunk_of = np.empty(cs.size, dtype=np.int64)
        chunk_of[corder] = np.cumsum(cnew) - 1
        # the (group, rank) key of each chunk, for anchor lookup
        ckeys = cs[cnew] if cs.size else cs
        return chunk_of, (int(cnew.sum()) if cs.size else 0), ckeys

    chunk_of, n_chunks, ckeys = enumerate_chunks(keep)
    if min_pop > 0.0 and n_chunks:
        # prune near-empty overflow chunks (a single high-multiplicity
        # cell would otherwise force a whole ~empty chunk)
        pop = np.bincount(chunk_of, minlength=n_chunks)
        prune = (pop < min_pop * SUBLANE * GROUP_ROWS) & (
            ckeys % cap > 0
        )
        if prune.any():
            keep_idx = np.nonzero(keep)[0]
            placed_rank[keep_idx[prune[chunk_of]]] = -1
            keep = placed_rank >= 0
            chunk_of, n_chunks, ckeys = enumerate_chunks(keep)

    value = np.zeros((n_chunks, SUBLANE, GROUP_ROWS), dtype=VALUE_DTYPE)
    loc = np.zeros((n_chunks, SUBLANE, GROUP_ROWS), dtype=np.int32)
    kg = keep
    a4_of_entry = anchors[placed_rank[kg], g[kg]]
    w = x2drow[kg] - a4_of_entry * d
    s = w // d
    value[chunk_of, s, lane[kg]] = vals[kg]
    loc[chunk_of, s, lane[kg]] = (
        (w << 7) | (cols[kg] & (LANE - 1))
    ).astype(np.int32)
    anchor4 = anchors[ckeys % cap, ckeys // cap].astype(np.int32)
    grp = (ckeys // cap).astype(np.int32)
    level = CwLevel(d=d, value=value, local_index=loc, anchor4=anchor4,
                    group_of_chunk=grp, cap=cap,
                    rank_of_chunk=(ckeys % cap).astype(np.int64))
    return level, np.nonzero(~keep)[0]


def _pack_pool(
    num_rows: int,
    num_columns: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    d: int,
    cap: int,
    pool_groups: int = POOL_GROUPS,
) -> Tuple[Optional[CwPoolLevel], np.ndarray]:
    """Pack tail entries into pooled chunks (see CwPoolLevel).

    Same rank-with-anchor placement as :func:`_pack_level`, but cells
    are pooled across ``pool_groups`` groups (the per-cell row map
    frees the group constraint) and the anchor ladder steps through
    the pool's wider column span (pool bands span several windows).
    Wider ``pool_groups`` (128/256) re-concentrate a thin spill tail
    that a 64-group ladder would chase with near-empty junk ranks
    (probes 42-45)."""
    if rows.size == 0:
        return None, np.zeros(0, dtype=np.int64)
    wd = 8 * d
    g = rows >> 7
    pool = g // pool_groups
    x2drow = cols >> 7
    lane = rows & (GROUP_ROWS - 1)
    npool = max(-(-max(num_rows, 1) // (GROUP_ROWS * pool_groups)), 1)

    glo, ghi = _grouped_minmax(pool, x2drow, npool)
    a_low = np.where(ghi < 0, 0, np.maximum(glo // d, 0))
    a_high = np.where(
        ghi < 0, 0, np.maximum(-(-(ghi + 1) // d) - SUBLANE, 0))
    a_high = np.maximum(a_high, a_low)
    npos = (a_high - a_low + 7) // SUBLANE + 1

    placed_rank = np.full(rows.size, -1, dtype=np.int64)
    anchors = np.empty((cap, npool), dtype=np.int64)
    idx_all = np.arange(rows.size)
    remaining = idx_all
    empty_streak = 0
    for k in range(cap):
        a4 = np.minimum(a_low + SUBLANE * (k % npos), a_high)
        anchors[k] = a4
        if remaining.size == 0:
            break
        w = x2drow[remaining] - a4[pool[remaining]] * d
        cand = (w >= 0) & (w < wd)
        ci = remaining[cand]
        if ci.size == 0:
            # Pools with different npos sit at different ladder
            # phases, so a single candidate-free rank does not prove
            # later ranks are empty too (cell collisions defer
            # entries to later ranks); only a full cycle of the
            # widest ladder with no candidates anywhere does.
            empty_streak += 1
            if empty_streak >= int(npos.max()):
                break
            continue
        empty_streak = 0
        cell = ((pool[ci] * SUBLANE) + w[cand] // d) * GROUP_ROWS \
            + lane[ci]
        order = np.argsort(cell, kind="stable")
        cs = cell[order]
        first = np.empty(cs.size, dtype=bool)
        first[0] = True
        np.not_equal(cs[1:], cs[:-1], out=first[1:])
        placed_rank[ci[order[first]]] = k
        remaining = remaining[placed_rank[remaining] < 0]

    keep = placed_rank >= 0
    if not keep.any():
        return None, idx_all

    ckey = pool[keep] * cap + placed_rank[keep]
    corder = np.argsort(ckey, kind="stable")
    cs = ckey[corder]
    cnew = np.empty(cs.size, dtype=bool)
    cnew[0] = True
    np.not_equal(cs[1:], cs[:-1], out=cnew[1:])
    chunk_of = np.empty(cs.size, dtype=np.int64)
    chunk_of[corder] = np.cumsum(cnew) - 1
    ckeys = cs[cnew]
    n_chunks = int(cnew.sum())

    value = np.zeros((n_chunks, SUBLANE, GROUP_ROWS), dtype=VALUE_DTYPE)
    loc = np.zeros((n_chunks, SUBLANE, GROUP_ROWS), dtype=np.int32)
    pool_of_chunk = (ckeys // cap).astype(np.int32)
    anchor4 = anchors[ckeys % cap, ckeys // cap].astype(np.int32)
    # padding cells point at the pool's base group (value 0 adds 0)
    rowmap = np.broadcast_to(
        (pool_of_chunk * pool_groups)[:, None, None],
        (n_chunks, SUBLANE, GROUP_ROWS),
    ).astype(np.int32).copy()

    kg = keep
    a4_of_entry = anchors[placed_rank[kg], pool[kg]]
    w = x2drow[kg] - a4_of_entry * d
    s = w // d
    value[chunk_of, s, lane[kg]] = vals[kg]
    loc[chunk_of, s, lane[kg]] = (
        (w << 7) | (cols[kg] & (LANE - 1))
    ).astype(np.int32)
    rowmap[chunk_of, s, lane[kg]] = g[kg].astype(np.int32)
    level = CwPoolLevel(d=d, value=value, local_index=loc,
                        anchor4=anchor4, rowmap=rowmap,
                        pool_of_chunk=pool_of_chunk,
                        pool_groups=pool_groups, cap=cap)
    return level, np.nonzero(~keep)[0]


@dataclasses.dataclass
class WellCwMatrix:
    num_rows: int
    num_columns: int
    num_entries: int
    levels: Tuple[CwLevel, ...]
    remainder: Optional[CsrMatrix]   # pathological multiplicity tail
    pool: Optional[CwPoolLevel] = None
    tail_pools: Tuple[CwPoolLevel, ...] = ()

    format_name = "wellcw"

    # ------------------------------------------------------------------
    @classmethod
    def from_matrix_market(
        cls,
        mm: MatrixMarket,
        levels: Sequence[Tuple[int, int, float]] = DEFAULT_LEVELS,
        pool_cap: int = POOL_CAP,
        tail_specs: Sequence[Tuple[int, int]] = DEFAULT_TAIL_SPECS,
    ) -> "WellCwMatrix":
        rows, cols, vals, _ = sorted_entries_0based(mm)
        return cls._build(mm.num_rows, mm.num_columns, rows, cols,
                          vals, levels, pool_cap=pool_cap,
                          tail_specs=tail_specs)

    @classmethod
    def from_csr(
        cls,
        m: CsrMatrix,
        levels: Sequence[Tuple[int, int, float]] = DEFAULT_LEVELS,
        pool_cap: int = POOL_CAP,
        tail_specs: Sequence[Tuple[int, int]] = DEFAULT_TAIL_SPECS,
    ) -> "WellCwMatrix":
        if int(m.row_ptr[-1]) != m.num_entries:
            raise MatrixError(
                "WellCwMatrix.from_csr requires an unpadded CSR")
        rows = np.repeat(
            np.arange(m.num_rows, dtype=np.int64), np.diff(m.row_ptr))
        return cls._build(
            m.num_rows, m.num_columns, rows,
            m.column_index.astype(np.int64), m.value, levels,
            pool_cap=pool_cap, tail_specs=tail_specs)

    @classmethod
    def _build(cls, num_rows, num_columns, rows, cols, vals, levels,
               pool_cap=None, tail_specs=None, use_native=True):
        from spmv_tpu_torch.models import _cw_native

        if pool_cap is None:
            pool_cap = POOL_CAP
        if tail_specs is None:
            tail_specs = DEFAULT_TAIL_SPECS
        if not levels:
            raise MatrixError("WellCwMatrix needs at least one level")
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=VALUE_DTYPE)
        native = use_native and _cw_native.available()
        if native:
            def pack_level(r, c, v, d, cap, mp):
                return _cw_native.pack_level(
                    num_rows, num_columns, r, c, v, d, cap, mp)

            def pack_pool(r, c, v, d, cap, pg):
                return _cw_native.pack_pool(
                    num_rows, num_columns, r, c, v, d, cap, pg)
        else:
            def pack_level(r, c, v, d, cap, mp):
                return _pack_level(num_rows, num_columns, r, c, v,
                                   d, cap, mp)

            def pack_pool(r, c, v, d, cap, pg):
                return _pack_pool(num_rows, num_columns, r, c, v,
                                  d, cap, pool_groups=pg)
        built = []
        cur = np.arange(rows.size)
        for d, cap, min_pop in levels:
            if d & (d - 1):
                raise MatrixError(f"level width d={d} must be a power "
                                  "of two (phase select uses masks)")
            lvl, spilled = pack_level(
                rows[cur], cols[cur], vals[cur], d, cap, min_pop)
            built.append(lvl)
            cur = cur[spilled]
            if cur.size == 0:
                break
        pool = None
        if cur.size and pool_cap > 0:
            pool, spilled = pack_pool(
                rows[cur], cols[cur], vals[cur], 4, pool_cap,
                POOL_GROUPS)
            cur = cur[spilled]
        tails = []
        if pool_cap <= 0:
            tail_specs = ()       # pool_cap=0 disables pooling wholesale
        ng = max(-(-num_rows // GROUP_ROWS), 1)
        for tg, tcap in tail_specs:
            if not cur.size:
                break
            # a stage only pays when the spill is dense enough that
            # its padded per-pool chunks won't be junk; a thin spill
            # is cheaper on the CSR remainder (probe 47: 2K entries
            # cost ~18 us there vs ~100 us as 1-entry pool chunks)
            npool = -(-ng // tg)
            if cur.size < 64 * npool:
                continue
            tp, spilled = pack_pool(
                rows[cur], cols[cur], vals[cur], 4, tcap, tg)
            if tp is None:
                continue
            tails.append(tp)
            cur = cur[spilled]
        remainder = None
        if cur.size:
            order = np.argsort(rows[cur], kind="stable")
            r, c, v = rows[cur][order], cols[cur][order], vals[cur][order]
            rp = np.zeros(num_rows + 1, dtype=np.int64)
            np.add.at(rp, r + 1, 1)
            np.cumsum(rp, out=rp)
            remainder = CsrMatrix(
                num_rows=num_rows, num_columns=num_columns,
                num_entries=int(v.size), row_alignment=1,
                row_ptr=rp, column_index=c.astype(np.int32), value=v)
        return cls(num_rows=num_rows, num_columns=num_columns,
                   num_entries=int(rows.size), levels=tuple(built),
                   remainder=remainder, pool=pool,
                   tail_pools=tuple(tails))

    # ------------------------------------------------------------------
    @property
    def num_groups(self) -> int:
        return max(-(-self.num_rows // GROUP_ROWS), 1)

    def _pools(self):
        return ([] if self.pool is None else [self.pool]) + list(
            self.tail_pools)

    @property
    def num_chunks(self) -> int:
        return sum(lv.num_chunks for lv in self.levels) + sum(
            p.num_chunks for p in self._pools())

    @property
    def num_remainder(self) -> int:
        return 0 if self.remainder is None else self.remainder.num_entries

    @property
    def remainder_fraction(self) -> float:
        return self.num_remainder / max(self.num_entries, 1)

    @property
    def fill_ratio(self) -> float:
        cells = sum(lv.value.size for lv in self.levels)
        cells += sum(p.value.size for p in self._pools())
        return (self.num_entries - self.num_remainder) / max(cells, 1)

    def memory_usage_bytes(self) -> int:
        total = 0
        for lv in self.levels:
            total += lv.value.nbytes + lv.local_index.nbytes
            total += lv.anchor4.nbytes + lv.group_of_chunk.nbytes
        for p in self._pools():
            total += (p.value.nbytes + p.local_index.nbytes
                      + p.anchor4.nbytes + p.rowmap.nbytes
                      + p.pool_of_chunk.nbytes)
        if self.remainder is not None:
            total += self.remainder.memory_usage_bytes()
        return total

    # ------------------------------------------------------------------
    def spmv(self, x: np.ndarray) -> np.ndarray:
        """Host (numpy) reference evaluation, all levels + remainder."""
        if x.shape[0] != self.num_columns:
            raise MatrixError(
                f"x has {x.shape[0]} entries, matrix has "
                f"{self.num_columns} columns")
        y = np.zeros(self.num_rows, dtype=np.result_type(x, VALUE_DTYPE))
        for lv in self.levels:
            t, s, lane = np.nonzero(lv.value)
            if t.size == 0:
                continue
            loc = lv.local_index[t, s, lane].astype(np.int64)
            col = ((lv.anchor4[t].astype(np.int64) * lv.d
                    + (loc >> 7)) << 7) | (loc & (LANE - 1))
            row = lv.group_of_chunk[t].astype(np.int64) * GROUP_ROWS \
                + lane
            np.add.at(y, row, lv.value[t, s, lane] * x[col])
        for p in self._pools():
            t, s, lane = np.nonzero(p.value)
            if t.size:
                loc = p.local_index[t, s, lane].astype(np.int64)
                col = ((p.anchor4[t].astype(np.int64) * p.d
                        + (loc >> 7)) << 7) | (loc & (LANE - 1))
                row = p.rowmap[t, s, lane].astype(np.int64) \
                    * GROUP_ROWS + lane
                np.add.at(y, row, p.value[t, s, lane] * x[col])
        if self.remainder is not None:
            y += self.remainder.spmv(x)
        return y

    def spmm(self, X: np.ndarray) -> np.ndarray:
        return np.stack(
            [self.spmv(X[:, j]) for j in range(X.shape[1])], axis=1)

    def __matmul__(self, x):
        return self.spmm(x) if x.ndim == 2 else self.spmv(x)

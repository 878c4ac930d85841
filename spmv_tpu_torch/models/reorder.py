"""Bandwidth-reducing and locality reordering.

Counterpart of the reference's src/matrix/matrix-market-reorder.cpp:

- ``find_new_order_rcm``: Reverse Cuthill-McKee with the reference's
  exact strategy (matrix-market-reorder.cpp:60-170): adjacency from
  row-wise off-diagonal entries, BFS restarted from the globally
  minimum-degree untaken node, neighbors enqueued in increasing degree
  order, final order reversed; returns an old->new index map.
- ``find_new_order_gp``: graph-partition clustering.  The reference
  calls METIS_PartGraphKway (183-279) and degrades to the identity
  without METIS (172-180).  METIS is not in this image, so we implement
  recursive BFS (level-set) bisection into ``num_parts`` clusters and
  order rows by cluster — same role (grouping tightly coupled rows to
  cut remote x-traffic / halo volume), different partitioner.

On the TPU side, reordering is *the* lever for halo volume over ICI:
after RCM, a banded matrix's row-block shards only need neighbor
x-segments (see spmv_tpu.parallel.halo).

The port's copy of ``spmv_tpu/models/reorder.py``: the same code,
importing the port's copies instead of the JAX package.
``find_new_order_coloring`` is left out: it serves the IC(0) / ILU(0)
preconditioners, which are not ported yet, and its native core lives in
the JAX package's ``ops``.
"""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np

from spmv_tpu_torch.io.matrix_market import MatrixMarket

__all__ = ["find_new_order_rcm", "find_new_order_gp",
           "find_new_order_sigma",
           "bandwidth", "partition_graph", "edge_cut"]


def _adjacency(mm: MatrixMarket):
    """CSR-style adjacency of off-diagonal row-wise entries.

    Matches generate_degree_and_adjacency
    (matrix-market-reorder.cpp:14-57): directed i->j edges, duplicates
    kept, diagonal dropped.  Requires a square matrix.
    """
    if mm.num_rows != mm.num_columns:
        raise ValueError("Expected a square matrix")
    i = mm.rows_1based.astype(np.int64) - 1
    j = mm.cols_1based.astype(np.int64) - 1
    offdiag = i != j
    i, j = i[offdiag], j[offdiag]
    order = np.argsort(i, kind="stable")
    i, j = i[order], j[order]
    degrees = np.bincount(i, minlength=mm.num_rows)
    ptr = np.zeros(mm.num_rows + 1, dtype=np.int64)
    np.cumsum(degrees, out=ptr[1:])
    return degrees, ptr, j


def bandwidth(mm: MatrixMarket, new_order: np.ndarray = None) -> int:
    """max |i - j| over entries, optionally under a relabeling."""
    i = mm.rows_1based.astype(np.int64) - 1
    j = mm.cols_1based.astype(np.int64) - 1
    if new_order is not None:
        p = np.asarray(new_order, dtype=np.int64)
        i, j = p[i], p[j]
    if i.size == 0:
        return 0
    return int(np.abs(i - j).max())


def find_new_order_rcm(mm: MatrixMarket) -> np.ndarray:
    """Reverse Cuthill-McKee old->new map (reorder.cpp:60-170)."""
    n = mm.num_rows
    degrees, ptr, adj = _adjacency(mm)

    taken = np.zeros(n, dtype=bool)
    visited = np.zeros(n, dtype=bool)
    R: List[int] = []

    # Min-degree order for component restarts: stable argsort by degree
    # gives the same node the reference's linear scan would find.
    restart_order = np.argsort(degrees, kind="stable")
    restart_pos = 0

    while len(R) < n:
        while restart_pos < n and taken[restart_order[restart_pos]]:
            restart_pos += 1
        start = int(restart_order[restart_pos])
        R.append(start)
        taken[start] = True
        visited[start] = True

        q = deque()
        nbrs = adj[ptr[start]:ptr[start + 1]]
        fresh = nbrs[~visited[nbrs]]
        # Dedup preserving first occurrence, then sort by degree
        # (stable, like std::sort with the reference's comparator on
        # first-occurrence order).
        fresh = fresh[np.sort(np.unique(fresh, return_index=True)[1])]
        visited[fresh] = True
        q.extend(fresh[np.argsort(degrees[fresh], kind="stable")].tolist())

        while q:
            u = q.popleft()
            if not taken[u]:
                R.append(int(u))
                taken[u] = True
                nbrs = adj[ptr[u]:ptr[u + 1]]
                fresh = nbrs[~visited[nbrs]]
                fresh = fresh[np.sort(np.unique(fresh, return_index=True)[1])]
                visited[fresh] = True
                q.extend(
                    fresh[np.argsort(degrees[fresh], kind="stable")].tolist()
                )

    R_arr = np.array(R[::-1], dtype=np.int64)
    new_order = np.empty(n, dtype=np.int64)
    new_order[R_arr] = np.arange(n, dtype=np.int64)
    return new_order


def find_new_order_gp(
    mm: MatrixMarket, num_parts: int = 16, method: str = "multilevel",
    seed: int = 0,
) -> np.ndarray:
    """Graph-partition clustering order (METIS replacement).

    ``method="multilevel"`` (default) follows the METIS recipe the
    reference links against (matrix-market-reorder.cpp:183-279,
    METIS_PartGraphKway, ubvec=1.05): heavy-edge-matching coarsening,
    BFS bisection of the coarsest graph, then projection with
    boundary Fiedler-Mattheyses refinement at every level, applied
    recursively for K-way.  Measured on the partition-quality suite
    (tests/test_reorder_quality.py): 25-60% lower edge cut than the
    single-level BFS bisection on irregular fixtures, matching cuts
    on regular stencils.

    ``method="bfs"`` keeps the round-2 single-level recursive BFS
    bisection (balanced level sets, no refinement).

    Rows are ordered by cluster id (stable); returns an old->new map
    like the reference's find_new_order_GP.
    """
    n = mm.num_rows
    if num_parts <= 1 or n == 0:
        return np.arange(n, dtype=np.int64)
    if method == "multilevel":
        from spmv_tpu_torch.models import _partition_native as _pn

        if n > 50_000 and not _pn.available():
            # the pure-Python matching/FM loops are ~90x slower than
            # the native cores (181 s vs 2 s at 100k irregular rows);
            # without a compiler, large graphs keep the fast
            # single-level BFS default instead of hanging
            import warnings

            warnings.warn(
                "native partition cores unavailable; falling back to "
                "single-level BFS bisection for this large graph "
                "(build csrc/ or pass method='multilevel' on a "
                "smaller matrix for refined cuts)", stacklevel=2)
            method = "bfs"
    if method == "multilevel":
        labels = partition_graph(mm, num_parts, seed=seed)
        order = np.argsort(labels, kind="stable")
        new_order = np.empty(n, dtype=np.int64)
        new_order[order] = np.arange(n, dtype=np.int64)
        return new_order
    if method != "bfs":
        raise ValueError(f"unknown gp method {method!r}")

    degrees, ptr, adj = _adjacency(mm)

    def bfs_halves(nodes: np.ndarray) -> tuple:
        """Split a node set roughly in half by BFS level sets."""
        node_set = np.zeros(n, dtype=bool)
        node_set[nodes] = True
        target = nodes.size // 2
        visited = np.zeros(n, dtype=bool)
        first: List[int] = []
        # Start from the minimum-degree node in the set.
        start = int(nodes[np.argmin(degrees[nodes])])
        q = deque([start])
        visited[start] = True
        while len(first) < target:
            if not q:
                # Disconnected: restart from an unvisited node.
                rest = nodes[~visited[nodes]]
                if rest.size == 0:
                    break
                s = int(rest[np.argmin(degrees[rest])])
                visited[s] = True
                q.append(s)
                continue
            u = q.popleft()
            first.append(u)
            nbrs = adj[ptr[u]:ptr[u + 1]]
            nbrs = nbrs[node_set[nbrs] & ~visited[nbrs]]
            visited[nbrs] = True
            q.extend(nbrs.tolist())
        first_arr = np.array(first, dtype=np.int64)
        in_first = np.zeros(n, dtype=bool)
        in_first[first_arr] = True
        second = nodes[~in_first[nodes]]
        return first_arr, second

    labels = np.zeros(n, dtype=np.int64)

    def recurse(nodes: np.ndarray, parts: int, base: int) -> None:
        if parts <= 1 or nodes.size <= 1:
            labels[nodes] = base
            return
        left_parts = parts // 2
        right_parts = parts - left_parts
        a, b = bfs_halves(nodes)
        recurse(a, left_parts, base)
        recurse(b, right_parts, base + left_parts)

    recurse(np.arange(n, dtype=np.int64), num_parts, 0)
    order = np.argsort(labels, kind="stable")
    new_order = np.empty(n, dtype=np.int64)
    new_order[order] = np.arange(n, dtype=np.int64)
    return new_order


# ---------------------------------------------------------------------------
# Multilevel K-way partitioner (the METIS recipe, VERDICT r4 item 5):
# heavy-edge matching coarsening -> BFS bisection of the coarsest graph
# -> projection with boundary FM refinement per level -> recursive K-way.
# ---------------------------------------------------------------------------


def _sym_csr(mm: MatrixMarket):
    """Undirected weighted adjacency: symmetrized, deduplicated,
    diagonal dropped; edge weight = multiplicity."""
    n = mm.num_rows
    i = mm.rows_1based.astype(np.int64) - 1
    j = mm.cols_1based.astype(np.int64) - 1
    off = i != j
    i, j = i[off], j[off]
    u = np.concatenate([i, j])
    v = np.concatenate([j, i])
    key = u * n + v
    uniq, counts = np.unique(key, return_counts=True)
    uu = (uniq // n).astype(np.int64)
    vv = (uniq % n).astype(np.int64)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(uu, minlength=n), out=ptr[1:])
    return ptr, vv, counts.astype(np.int64)


def _edge_cut(ptr, adj, wgt, labels) -> int:
    """Total weight of edges crossing parts (each edge counted once)."""
    src = np.repeat(np.arange(ptr.size - 1, dtype=np.int64),
                    np.diff(ptr))
    cross = labels[src] != labels[adj]
    return int(wgt[cross].sum() // 2)


def _heavy_edge_matching(ptr, adj, wgt, vwgt, rng, native=True):
    """Greedy heavy-edge matching; returns coarse-node map (n,).

    The per-node loop runs through csrc/partition.cpp when available
    (same visit order, bit-identical output — pinned by test); the
    Python loop below is the reference implementation and fallback.
    (The FM refinement's native path, by contrast, is only
    algorithm-identical: its heap tie-breaking differs — see
    _partition_native.)
    """
    n = ptr.size - 1
    order = rng.permutation(n)
    # visit light vertices first (standard HEM tie-break)
    order = order[np.argsort(vwgt[order], kind="stable")]
    if native:
        from spmv_tpu_torch.models import _partition_native as pn

        if pn.available():
            return pn.hem_match(ptr, adj, wgt, order)
    match = np.full(n, -1, dtype=np.int64)
    for u in order:
        if match[u] >= 0:
            continue
        nbrs = adj[ptr[u]:ptr[u + 1]]
        ws = wgt[ptr[u]:ptr[u + 1]]
        free = match[nbrs] < 0
        nbrs, ws = nbrs[free], ws[free]
        if nbrs.size:
            v = int(nbrs[np.argmax(ws)])
            match[u] = v
            match[v] = u
        else:
            match[u] = u
    # coarse ids: one per matched pair / singleton
    cid = np.full(n, -1, dtype=np.int64)
    nxt = 0
    for u in range(n):
        if cid[u] < 0:
            cid[u] = nxt
            cid[match[u]] = nxt
            nxt += 1
    return cid, nxt


def _coarsen(ptr, adj, wgt, vwgt, cid, nc):
    """Contract matched pairs into the coarse weighted graph."""
    src = np.repeat(np.arange(ptr.size - 1, dtype=np.int64),
                    np.diff(ptr))
    cu, cv = cid[src], cid[adj]
    keep = cu != cv
    cu, cv, cw = cu[keep], cv[keep], wgt[keep]
    key = cu * nc + cv
    uniq, inv = np.unique(key, return_inverse=True)
    w2 = np.bincount(inv, weights=cw).astype(np.int64)
    uu = (uniq // nc).astype(np.int64)
    vv = (uniq % nc).astype(np.int64)
    p2 = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum(np.bincount(uu, minlength=nc), out=p2[1:])
    vw2 = np.bincount(cid, weights=vwgt, minlength=nc).astype(np.int64)
    return p2, vv, w2, vw2


def _bfs_bisect_w(ptr, adj, vwgt, rng, frac=0.5):
    """Weight-balanced BFS level-set bisection; ``side=True`` nodes
    carry ~``frac`` of the total weight."""
    n = ptr.size - 1
    total = int(vwgt.sum())
    target = int(total * frac)
    side = np.zeros(n, dtype=bool)
    visited = np.zeros(n, dtype=bool)
    acc = 0
    deg = np.diff(ptr)
    start = int(np.argmin(deg))
    q = deque([start])
    visited[start] = True
    while acc < target:
        if not q:
            rest = np.flatnonzero(~visited)
            if rest.size == 0:
                break
            s = int(rest[rng.integers(rest.size)])
            visited[s] = True
            q.append(s)
            continue
        u = q.popleft()
        side[u] = True
        acc += int(vwgt[u])
        nbrs = adj[ptr[u]:ptr[u + 1]]
        nbrs = nbrs[~visited[nbrs]]
        visited[nbrs] = True
        q.extend(nbrs.tolist())
    return side


def _fm_refine(ptr, adj, wgt, vwgt, side, ubvec=1.05, passes=4,
               frac=0.5):
    """Boundary Fiduccia-Mattheyses refinement of a bisection.

    Lazy-heap FM restricted to boundary vertices; each pass moves
    positive-gain (or best-available) vertices under the ubvec
    balance bound (side True targets ``frac`` of the weight), keeps
    the best prefix, reverts the rest — the refinement step METIS
    runs at every uncoarsening level
    (matrix-market-reorder.cpp:183-279 calls it with ubvec=1.05).
    """
    import heapq

    n = ptr.size - 1
    total = int(vwgt.sum())
    limit_b = ubvec * total * frac          # side True budget
    limit_a = ubvec * total * (1.0 - frac)  # side False budget
    from spmv_tpu_torch.models import _partition_native as pn

    if pn.available():
        # same algorithm, C++ heap loop (csrc/partition.cpp)
        return pn.fm_refine(ptr, adj, wgt, vwgt, side, limit_a,
                            limit_b, passes=passes)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))

    for _ in range(passes):
        wA = int(vwgt[~side].sum())
        wB = total - wA
        # gains: external - internal weighted degree
        same = side[src] == side[adj]
        ext = np.bincount(src[~same], weights=wgt[~same], minlength=n)
        internal = np.bincount(src[same], weights=wgt[same],
                               minlength=n)
        gain = (ext - internal).astype(np.int64)
        boundary = ext > 0
        stamp = np.zeros(n, dtype=np.int64)
        locked = np.zeros(n, dtype=bool)
        heap = [(-int(gain[v]), int(v), 0)
                for v in np.flatnonzero(boundary)]
        heapq.heapify(heap)
        moves = []
        cut_delta = 0
        best_delta = 0
        best_len = 0
        cur_side = side.copy()
        while heap:
            ng, v, st = heapq.heappop(heap)
            if locked[v] or st != stamp[v]:
                continue
            wv = int(vwgt[v])
            # balance check for moving v to the other side
            if cur_side[v]:  # B -> A
                if wA + wv > limit_a:
                    continue
                wA += wv
                wB -= wv
            else:            # A -> B
                if wB + wv > limit_b:
                    continue
                wA -= wv
                wB += wv
            locked[v] = True
            cut_delta -= int(gain[v])
            moves.append(v)
            cur_side[v] = ~cur_side[v]
            if cut_delta < best_delta:
                best_delta = cut_delta
                best_len = len(moves)
            # update neighbor gains
            nbrs = adj[ptr[v]:ptr[v + 1]]
            ws = wgt[ptr[v]:ptr[v + 1]]
            for u, w in zip(nbrs.tolist(), ws.tolist()):
                if locked[u]:
                    continue
                # v changed side: edges to v flip internal<->external
                if cur_side[u] == cur_side[v]:
                    gain[u] -= 2 * w
                else:
                    gain[u] += 2 * w
                stamp[u] += 1
                heapq.heappush(heap, (-int(gain[u]), int(u),
                                      int(stamp[u])))
            if len(moves) > 4 * int(np.count_nonzero(boundary)) + 16:
                break
        if best_len == 0:
            break
        side[np.array(moves[:best_len], dtype=np.int64)] ^= True
    return side


_COARSEST = 64


def _bisect_multilevel(ptr, adj, wgt, vwgt, rng, ubvec=1.05,
                       frac=0.5):
    """Multilevel bisection of one (weighted) graph; returns side."""
    n = ptr.size - 1
    if n <= _COARSEST:
        side = _bfs_bisect_w(ptr, adj, vwgt, rng, frac=frac)
        return _fm_refine(ptr, adj, wgt, vwgt, side, ubvec=ubvec,
                          frac=frac)
    cid, nc = _heavy_edge_matching(ptr, adj, wgt, vwgt, rng)
    if nc >= 0.95 * n:   # matching stalled: stop coarsening
        side = _bfs_bisect_w(ptr, adj, vwgt, rng, frac=frac)
        return _fm_refine(ptr, adj, wgt, vwgt, side, ubvec=ubvec,
                          frac=frac)
    p2, a2, w2, vw2 = _coarsen(ptr, adj, wgt, vwgt, cid, nc)
    side_c = _bisect_multilevel(p2, a2, w2, vw2, rng, ubvec=ubvec,
                                frac=frac)
    side = side_c[cid]          # project
    return _fm_refine(ptr, adj, wgt, vwgt, side, ubvec=ubvec,
                      frac=frac)


def edge_cut(mm: MatrixMarket, labels: np.ndarray) -> int:
    """Weighted edge cut of a K-way node labeling (each edge once) —
    the partition-quality metric that prices sharded halo bytes."""
    ptr, adj, wgt = _sym_csr(mm)
    return _edge_cut(ptr, adj, wgt, np.asarray(labels, np.int64))


def partition_graph(
    mm: MatrixMarket, num_parts: int, seed: int = 0, ubvec: float = 1.05
) -> np.ndarray:
    """Multilevel recursive-bisection K-way labels (0..num_parts-1).

    The METIS role (matrix-market-reorder.cpp:183-279) implemented
    natively: recursive multilevel bisection with boundary FM
    refinement and the same 1.05 balance bound.
    """
    n = mm.num_rows
    labels = np.zeros(n, dtype=np.int64)
    if num_parts <= 1 or n == 0:
        return labels
    ptr, adj, wgt = _sym_csr(mm)
    vwgt = np.ones(n, dtype=np.int64)
    rng = np.random.default_rng(seed)
    # recursive bisection compounds each level's imbalance, so the
    # per-level bound is the ubvec-th root over the recursion depth
    # (METIS's recursive mode applies the same correction)
    depth = max(int(np.ceil(np.log2(num_parts))), 1)
    ub_lv = float(ubvec) ** (1.0 / depth)

    def sub(nodes, ptr_s, adj_s, wgt_s, vwgt_s, parts, base):
        if parts <= 1 or nodes.size <= 1:
            labels[nodes] = base
            return
        frac_true = (parts - parts // 2) / parts
        side = _bisect_multilevel(ptr_s, adj_s, wgt_s, vwgt_s, rng,
                                  ubvec=ub_lv, frac=frac_true)
        left_parts = parts // 2
        right_parts = parts - left_parts
        for flag, p_cnt, b in ((False, left_parts, base),
                               (True, right_parts, base + left_parts)):
            sel = np.flatnonzero(side == flag)
            if sel.size == 0:
                continue
            if p_cnt <= 1:
                labels[nodes[sel]] = b
                continue
            # induced subgraph
            remap = np.full(ptr_s.size - 1, -1, dtype=np.int64)
            remap[sel] = np.arange(sel.size, dtype=np.int64)
            src = np.repeat(np.arange(ptr_s.size - 1, dtype=np.int64),
                            np.diff(ptr_s))
            keep = (remap[src] >= 0) & (remap[adj_s] >= 0)
            su, sv, sw = (remap[src[keep]], remap[adj_s[keep]],
                          wgt_s[keep])
            p_n = sel.size
            p_ptr = np.zeros(p_n + 1, dtype=np.int64)
            order = np.argsort(su, kind="stable")
            su, sv, sw = su[order], sv[order], sw[order]
            np.cumsum(np.bincount(su, minlength=p_n), out=p_ptr[1:])
            sub(nodes[sel], p_ptr, sv, sw, vwgt_s[sel], p_cnt, b)

    sub(np.arange(n, dtype=np.int64), ptr, adj, wgt, vwgt,
        num_parts, 0)
    return labels


def find_new_order_sigma(
    mm: MatrixMarket, sigma: int = 1024
) -> np.ndarray:
    """SELL-sigma row ordering: sort rows by descending length within
    windows of ``sigma`` rows.

    No reference counterpart (the reference's orders are RCM and
    graph-partition, matrix-market-reorder.cpp); this one serves the
    WELL format (models.well): rows of similar length land in the same
    128-row group, so slot columns stay aligned and chunk padding
    shrinks.  Like every order here it composes with
    ``MatrixMarket.permute`` — the matrix is permuted once on the host
    and vectors are permuted at the boundary, which is the TPU-correct
    place for a permutation (no device gather).
    """
    lengths = np.zeros(mm.num_rows, dtype=np.int64)
    np.add.at(lengths, mm.rows_1based - 1, 1)
    order = np.arange(mm.num_rows, dtype=np.int64)
    for start in range(0, mm.num_rows, max(int(sigma), 1)):
        stop = min(start + sigma, mm.num_rows)
        window = order[start:stop]
        # stable: equal lengths keep their relative (e.g. RCM) order
        key = np.argsort(-lengths[window], kind="stable")
        order[start:stop] = window[key]
    # new_order maps old index -> new position (permute() convention)
    new_order = np.empty_like(order)
    new_order[order] = np.arange(mm.num_rows, dtype=np.int64)
    return new_order


"""Exact backpointer tie resolution for the CDQ affine chain engine.

The CDQ value engine (native/chain_affine_cdq.cpp) computes bit-identical
DP values but flags query results where several predecessors attain the
same f32 range max. The reference resolves such ties by the traversal
order of its search trees (MaxSearchTree / OrthogonalMaxSearchTree,
reference max_search_tree.hpp:361-445, orthogonal_max_search_tree.hpp:
343-545); this module replicates that walk on the static Eytzinger
layouts without building the trees — it is only invoked for the (rare)
tied steps on the traceback path.

Tie semantics replicated (verified against the native replica engine,
native/chain_parity.cpp, which is itself byte-parity-tested against the
reference):

- gap-free trees (MaxTreeP<(offset, id), f32>, one per shift): plain f32
  strict-> comparisons everywhere, so the winner among equal values is
  the first max-valued source in range_max's visit order (split node,
  left-boundary walk with right-subtree submaxes, right-boundary walk),
  and a subtree's submax points at its first-UPDATED max entry — update
  order is the sweep order, i.e. ascending (end1 position, match id).
- ortho trees (MultiOrthoTreeP): the OUTER walk also uses plain f32
  strict->, visiting on-path nodes and cross trees in a fixed order; but
  the inner cross trees compare (f32 value, outer heap index)
  LEXICOGRAPHICALLY (reference CrossVal, orthogonal_max_search_tree.hpp),
  so a cross subtree's winner among equal values is simply the entry with
  the LARGEST outer heap index — independent of update order.

The trees of one (path1, path2) family are _Family: a chain x chain
input has one (AffineTieResolver), a graph x graph input one per pair of
paths (GraphTieResolver). An entry takes part in a query when the sweep
inserted it at or before the query's time.

Copy of centrolign_tpu/chain_ties.py, carrying _subtree_interval and
_heap_rank (verbatim from centrolign_tpu/ops/chain_scan.py:103-133)
instead of importing them: that module imports jax.
"""

from __future__ import annotations

import numpy as np


def _subtree_interval(x, n):
    """In-order rank interval [lo, hi) of heap node x in a complete binary
    tree of n nodes (Eytzinger layout), plus x's own rank."""
    lo, hi = 0, n
    path = []
    y = x + 1
    while y > 1:
        path.append(y & 1)  # 0 = left child, 1 = right child
        y >>= 1
    for bit in reversed(path):
        root = _heap_rank(lo, hi)
        if bit == 0:
            hi = root
        else:
            lo = root + 1
    return lo, hi, _heap_rank(lo, hi)


def _heap_rank(lo, hi):
    """In-order rank of the root of the heap-layout subtree spanning ranks
    [lo, hi): lo + size of its left heap subtree."""
    m = hi - lo
    if m <= 0:
        return lo
    # left subtree size of a complete tree with m nodes
    h = m.bit_length() - 1          # full levels below root exist for 2^h-1
    full = (1 << h) - 1             # nodes in a perfect tree of height h-1
    last = m - full                 # nodes on the bottom level
    left_last = min(last, (full + 1) // 2)
    left = (full - 1) // 2 + left_last if h > 0 else 0
    return lo + left


def _rank_to_heap(n, r):
    """Heap-layout index of in-order rank r in a complete binary tree of
    n nodes (inverse of the in-order fill)."""
    lo, hi, x = 0, n, 0
    while True:
        root = _heap_rank(lo, hi)
        if root == r:
            return x
        if r < root:
            x = 2 * x + 1
            hi = root
        else:
            x = 2 * x + 2
            lo = root + 1


def _walk_first_candidate(n, qlo, qhi, cand_ranks, on_path_hit,
                          subtree_hit):
    """Replicates MaxTreeP.range_max / the ortho outer walk over in-order
    ranks [qlo, qhi) of a complete binary tree with n nodes. Everything
    outside `cand_ranks` holds a strictly smaller value, so the winner is
    the first candidate source in visit order:

      on_path_hit(rank) -> candidate id or None      (node's own entry)
      subtree_hit(lo, hi) -> candidate id or None    (opposite-child
          subtree spanning ranks [lo, hi): submax / cross-tree source)

    Returns the candidate id or None if no candidate is visited (a bug —
    callers treat None as unresolvable and fall back).
    """
    if len(cand_ranks) == 0 or n == 0:
        return None

    def rank_of(x):
        return _subtree_interval(x, n)[2]

    cursor = 0
    while cursor < n:
        r = rank_of(cursor)
        if r >= qhi:
            cursor = 2 * cursor + 1
        elif r < qlo:
            cursor = 2 * cursor + 2
        else:
            break
    if cursor >= n:
        return None
    hit = on_path_hit(rank_of(cursor))
    if hit is not None:
        return hit
    # left-boundary walk (>= lo side): node first, then the right
    # subtree's submax / cross tree
    lc = 2 * cursor + 1
    while lc < n:
        if rank_of(lc) >= qlo:
            hit = on_path_hit(rank_of(lc))
            if hit is not None:
                return hit
            rgt = 2 * lc + 2
            if rgt < n:
                lo, hi, _ = _subtree_interval(rgt, n)
                hit = subtree_hit(lo, hi)
                if hit is not None:
                    return hit
            lc = 2 * lc + 1
        else:
            lc = 2 * lc + 2
    # right-boundary walk (< hi side): node first, then the left subtree
    rc = 2 * cursor + 2
    while rc < n:
        if rank_of(rc) < qhi:
            hit = on_path_hit(rank_of(rc))
            if hit is not None:
                return hit
            lft = 2 * rc + 1
            if lft < n:
                lo, hi, _ = _subtree_interval(lft, n)
                hit = subtree_hit(lo, hi)
                if hit is not None:
                    return hit
            rc = 2 * rc + 2
        else:
            rc = 2 * rc + 1
    return None


class _Family:
    """The static trees of one (path1, path2) family: the ortho tree over
    (shift, id) and, per shift, the gap-free tree over (offset, id). Each
    entry is an anchor of the family with its shift, offset and insert
    time (when the sweep updated it), and its final f32 dp. A query at
    time t_q sees the entries inserted at or before t_q; the others still
    hold MININF in the trees and never win."""

    def __init__(self, ids, shift, offset, t_ins, dp, ck):
        order = np.lexsort((ids, shift))
        self.ids = ids[order]
        self.shift = shift[order]
        self.offset = offset[order]
        self.t_ins = t_ins[order]
        self.dp = dp[self.ids]
        self.ck = ck
        self._gf = None            # shift -> its gap-free tree's entries
        self._sv = {}              # pw -> stored channel values (f32)

    # ---------------- gap-free (struct 0) ----------------

    def resolve_gf(self, t_q, q, o, vmax):
        if self._gf is None:
            # each shift's tree is keyed by (offset, id)
            order = np.lexsort((self.ids, self.offset, self.shift))
            sh = self.shift[order]
            starts = np.flatnonzero(np.r_[True, sh[1:] != sh[:-1]])
            ends = np.r_[starts[1:], len(sh)]
            self._gf = {int(sh[a]): order[a:b] for a, b in zip(starts, ends)}
        grp = self._gf.get(int(q))
        if grp is None:
            return None
        n = len(grp)
        qhi = int(np.searchsorted(self.offset[grp], o, side="left"))
        gate = (self.t_ins[grp] <= t_q) & (self.dp[grp] == vmax)
        gate[qhi:] = False
        cand_ranks = np.flatnonzero(gate)
        if len(cand_ranks) == 0:
            return None
        cset = set(cand_ranks.tolist())
        # first-updated = min (insert time, id): the sweep applies updates
        # in its node order, within a node in MatchBank id order
        t_g, id_g = self.t_ins[grp], self.ids[grp]

        def on_path_hit(r):
            return int(id_g[r]) if r in cset else None

        def subtree_hit(lo, hi):
            inside = cand_ranks[(cand_ranks >= lo) & (cand_ranks < hi)]
            if len(inside) == 0:
                return None
            k = np.lexsort((id_g[inside], t_g[inside]))[0]
            return int(id_g[inside[k]])

        return _walk_first_candidate(n, 0, qhi, cand_ranks, on_path_hit,
                                     subtree_hit)

    # ---------------- ortho channels (struct 1..6) ----------------

    def _stored_vals(self, pw):
        sv = self._sv.get(pw)
        if sv is None:
            k = pw // 2
            sgn = 1.0 if pw % 2 == 1 else -1.0
            sv = (self.dp.astype(np.float64)
                  + sgn * self.ck[k] * self.shift).astype(np.float32)
            self._sv[pw] = sv
        return sv

    def resolve_ortho(self, pw, t_q, q, o, vmax):
        n = len(self.ids)
        if pw % 2 == 1:   # ascending channels: shift < qshift
            qlo = 0
            qhi = int(np.searchsorted(self.shift, q, side="left"))
        else:             # descending channels: shift > qshift
            qlo = int(np.searchsorted(self.shift, q, side="right"))
            qhi = n
        gate = ((self.t_ins <= t_q) & (self.offset < o)
                & (self._stored_vals(pw) == vmax))
        gate[:qlo] = False
        gate[qhi:] = False
        cand_ranks = np.flatnonzero(gate)
        if len(cand_ranks) == 0:
            return None
        cset = set(cand_ranks.tolist())
        heap_idx = {int(r): _rank_to_heap(n, int(r)) for r in cand_ranks}
        ids = self.ids

        def on_path_hit(r):
            return int(ids[r]) if r in cset else None

        def subtree_hit(lo, hi):
            # cross trees compare (value, outer heap index)
            # lexicographically: winner = largest heap index
            inside = cand_ranks[(cand_ranks >= lo) & (cand_ranks < hi)]
            if len(inside) == 0:
                return None
            best = max((heap_idx[int(r)], int(r)) for r in inside.tolist())
            return int(ids[best[1]])

        return _walk_first_candidate(n, qlo, qhi, cand_ranks, on_path_hit,
                                     subtree_hit)

    def resolve(self, struct, t_q, q, o, vmax):
        """The tree-order winner of the family's query at time t_q with
        shift q and exclusive offset bound o whose winning structure was
        `struct` (0 = gap-free, 1 + pw = piecewise channel) with range max
        vmax, or None."""
        vmax = np.float32(vmax)
        if struct == 0:
            return self.resolve_gf(t_q, q, o, vmax)
        if 1 <= struct <= 6:
            return self.resolve_ortho(int(struct) - 1, t_q, q, o, vmax)
        return None


class AffineTieResolver:
    """Per-subproblem context for resolving CDQ backpointer ties of a
    chain x chain input: one family, whose anchor i has shift pe1 - pe2,
    offset pe2 and insert time pe1, and whose anchor j queries at time
    ps1 - 1 with shift ps1 - ps2 and offset bound ps2.

    Arrays are the CDQ engine's flat per-anchor inputs/outputs (chain
    positions of walk endpoints, final f32 dp). Sort orders are built
    once and cached across the (typically few) tied traceback steps.
    """

    def __init__(self, ps1, pe1, ps2, pe2, dp, gap_extend, scale):
        self.ps1, self.ps2 = ps1, ps2
        ck = [float(scale) * float(g) for g in gap_extend]
        self._family = _Family(np.arange(len(pe1)), pe1 - pe2, pe2, pe1,
                               dp.astype(np.float32, copy=False), ck)

    def resolve(self, anchor, struct, stored):
        """Exact tree-order predecessor of `anchor` whose winning query
        structure was `struct` (0 = gap-free, 1+pw = piecewise channel)
        with range-max value `stored`, or None if the replica cannot
        resolve it (caller falls back to the tree engine)."""
        j = int(anchor)
        return self._family.resolve(
            struct, self.ps1[j] - 1, self.ps1[j] - self.ps2[j],
            self.ps2[j], stored)


class GraphTieResolver:
    """Per-subproblem context for resolving the ties of the graph x graph
    CDQ pass (native chain_affine_graph_cdq): one _Family per (path1,
    path2), built on first use. e1/e2 are the anchors' end nodes in
    MatchBank id order, index_on1/index_on2 the PathMerges' (C, V) chain
    indices, rank1 each graph1 node's position in the sweep's order."""

    def __init__(self, e1, e2, index_on1, index_on2, rank1, dp, gap_extend,
                 scale):
        self.e1, self.e2 = e1, e2
        self.index_on1, self.index_on2 = index_on1, index_on2
        self.rank1 = rank1
        self.dp = dp.astype(np.float32, copy=False)
        self.ck = [float(scale) * float(g) for g in gap_extend]
        self._families = {}

    def _family(self, p1, p2):
        fam = self._families.get((p1, p2))
        if fam is None:
            i1 = np.asarray(self.index_on1[p1], dtype=np.int64)[self.e1]
            i2 = np.asarray(self.index_on2[p2], dtype=np.int64)[self.e2]
            ids = np.flatnonzero((i1 >= 0) & (i2 >= 0))
            fam = _Family(ids, i1[ids] - i2[ids], i2[ids],
                          self.rank1[self.e1[ids]], self.dp, self.ck)
            self._families[(p1, p2)] = fam
        return fam

    def resolve(self, anchor, struct, stored, qtime, p1, p2, qshift, qoff):
        """The tree-order predecessor of `anchor`, whose winning query was
        family (p1, p2)'s at sweep position qtime with shift qshift and
        offset bound qoff, its structure `struct` with range max `stored`;
        None if the replica cannot resolve it (the caller falls back to
        the tree engine)."""
        return self._family(int(p1), int(p2)).resolve(
            struct, int(qtime), int(qshift), int(qoff), stored)

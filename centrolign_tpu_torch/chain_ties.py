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

Only chain x chain inputs reach this path (the CDQ engine's own
applicability guard), so there is exactly one (path1, path2) tree family.

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


class AffineTieResolver:
    """Per-subproblem context for resolving CDQ backpointer ties.

    Arrays are the CDQ engine's flat per-anchor inputs/outputs (chain
    positions of walk endpoints, final f32 dp). Sort orders are built
    lazily and cached across the (typically few) tied traceback steps.
    """

    def __init__(self, ps1, pe1, ps2, pe2, dp, gap_extend, scale):
        self.ps1, self.pe1 = ps1, pe1
        self.ps2, self.pe2 = ps2, pe2
        self.dp = dp.astype(np.float32, copy=False)
        self.shift = pe1 - pe2
        self.ck = [float(scale) * float(g) for g in gap_extend]
        self._gf_groups = None     # shift -> sorted member ids
        self._outer_order = None   # ids sorted by (shift, id)
        self._outer_shift = None
        self._sv = {}              # pw -> stored channel values (f32)

    # ---------------- gap-free (struct 0) ----------------

    def _gf_group(self, s):
        if self._gf_groups is None:
            order = np.lexsort((np.arange(len(self.shift)), self.shift))
            shifts_sorted = self.shift[order]
            # group boundaries per distinct shift
            starts = np.flatnonzero(
                np.r_[True, shifts_sorted[1:] != shifts_sorted[:-1]])
            ends = np.r_[starts[1:], len(order)]
            self._gf_groups = {
                int(shifts_sorted[a]): order[a:b]
                for a, b in zip(starts, ends)}
        # members sorted by id; gf keys are (e2 offset, id)
        mem = self._gf_groups.get(int(s))
        if mem is None:
            return None, None
        skey = np.lexsort((mem, self.pe2[mem]))
        return mem[skey], self.pe2[mem[skey]]

    def _resolve_gf(self, j, vmax):
        mem, e2s = self._gf_group(self.ps1[j] - self.ps2[j])
        if mem is None:
            return None
        n = len(mem)
        qhi = int(np.searchsorted(e2s, self.ps2[j], side="left"))
        gate = (self.pe1[mem] < self.ps1[j]) & (self.dp[mem] == vmax)
        gate[qhi:] = False
        cand_ranks = np.flatnonzero(gate)
        if len(cand_ranks) == 0:
            return None
        cset = set(cand_ranks.tolist())
        # first-updated = min (e1 position, id): sweep applies updates in
        # ascending end-node order, within a node in MatchBank id order
        pe1m, idm = self.pe1[mem], mem

        def on_path_hit(r):
            return int(mem[r]) if r in cset else None

        def subtree_hit(lo, hi):
            inside = cand_ranks[(cand_ranks >= lo) & (cand_ranks < hi)]
            if len(inside) == 0:
                return None
            k = np.lexsort((idm[inside], pe1m[inside]))[0]
            return int(mem[inside[k]])

        return _walk_first_candidate(n, 0, qhi, cand_ranks, on_path_hit,
                                     subtree_hit)

    # ---------------- ortho channels (struct 1..6) ----------------

    def _outer(self):
        if self._outer_order is None:
            self._outer_order = np.lexsort(
                (np.arange(len(self.shift)), self.shift))
            self._outer_shift = self.shift[self._outer_order]
        return self._outer_order, self._outer_shift

    def _stored_vals(self, pw):
        sv = self._sv.get(pw)
        if sv is None:
            k = pw // 2
            sgn = 1.0 if pw % 2 == 1 else -1.0
            sv = (self.dp.astype(np.float64)
                  + sgn * self.ck[k] * self.shift).astype(np.float32)
            self._sv[pw] = sv
        return sv

    def _resolve_ortho(self, j, pw, vmax):
        order, shift_sorted = self._outer()
        n = len(order)
        qshift = self.ps1[j] - self.ps2[j]
        if pw % 2 == 1:   # ascending channels: shift < qshift
            qlo = 0
            qhi = int(np.searchsorted(shift_sorted, qshift, side="left"))
        else:             # descending channels: shift > qshift
            qlo = int(np.searchsorted(shift_sorted, qshift, side="right"))
            qhi = n
        sv = self._stored_vals(pw)
        ids = order
        gate = ((self.pe1[ids] < self.ps1[j])
                & (self.pe2[ids] < self.ps2[j]) & (sv[ids] == vmax))
        gate[:qlo] = False
        gate[qhi:] = False
        cand_ranks = np.flatnonzero(gate)
        if len(cand_ranks) == 0:
            return None
        cset = set(cand_ranks.tolist())
        heap_idx = {int(r): _rank_to_heap(n, int(r)) for r in cand_ranks}

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

    # ---------------- public ----------------

    def resolve(self, anchor, struct, stored):
        """Exact tree-order predecessor of `anchor` whose winning query
        structure was `struct` (0 = gap-free, 1+pw = piecewise channel)
        with range-max value `stored`, or None if the replica cannot
        resolve it (caller falls back to the tree engine)."""
        j = int(anchor)
        vmax = np.float32(stored)
        if struct == 0:
            return self._resolve_gf(j, vmax)
        if 1 <= struct <= 6:
            return self._resolve_ortho(j, int(struct) - 1, vmax)
        return None


def resolve_affine_tie(anchor, ps1, pe1, ps2, pe2, dp, init, go, ge, scale,
                       struct, stored, cache=None):
    """Compatibility wrapper: build (or reuse via `cache`) an
    AffineTieResolver and resolve one tied step."""
    if cache is not None and "resolver" in cache:
        res = cache["resolver"]
    else:
        res = AffineTieResolver(ps1, pe1, ps2, pe2, dp, ge, scale)
        if cache is not None:
            cache["resolver"] = res
    return res.resolve(anchor, struct, stored)


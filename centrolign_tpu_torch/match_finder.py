"""Minimal-rare-match finding over the embedded paths of two graphs.

Behavioral equivalent of the reference's PathMatchFinder / PathESA / ESA
minimal-rare-match machinery (reference match_finder.hpp:144-212,
path_esa.hpp:80-170, esa.hpp:196-491):

- The label sequences of every path of both graphs are concatenated, each
  wrapped in its graph's (src, snk) sentinel characters, +1-shifted, with a
  terminal 0 (path_esa.hpp:88-113).
- A suffix array + LCP array is built over the joined text.
- A *minimal rare match* is an LCP-interval-tree node C (with parent P) whose
  match string is the length-(depth(P)+1) prefix of C's suffixes, such that
  the per-graph counts of **distinct starting nodes** are all nonzero, their
  product is <= max_count, and both dropping the last characters (P's
  interval) and dropping the first character (the suffix-link interval)
  strictly increase the count on some graph (esa.hpp:382-407). Children of
  the root only need the count condition (esa.hpp:296-350).
- Matches are walked out into node-id paths, deduplicated by (graph, start
  node), in suffix-array order (esa.hpp:613-665).

This module is pure numpy host code (index construction is not a TPU-shaped
workload); the joined-text suffix array uses prefix-doubling with
numpy lexsort, O(N log^2 N) vectorized.

Copy of centrolign_tpu/match_finder.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_I64 = np.int64


@dataclass
class MatchSet:
    """A set of walks of one shared string in both graphs (reference
    match_finder.hpp:21-34)."""

    walks1: np.ndarray  # (count1, L) node ids in graph1
    walks2: np.ndarray  # (count2, L) node ids in graph2
    count1: int
    count2: int
    full_length: int


def suffix_array_doubling(text: np.ndarray) -> np.ndarray:
    """Suffix array by prefix doubling (numpy-vectorized). text values >= 0;
    the terminal element must be the unique minimum."""
    n = len(text)
    rank = np.asarray(text, dtype=_I64)
    idx = np.arange(n, dtype=_I64)
    k = 1
    while True:
        rank2 = np.full(n, -1, dtype=_I64)
        rank2[: n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        # new ranks: increment where (rank, rank2) differs from predecessor
        r_sorted = rank[order]
        r2_sorted = rank2[order]
        new_rank = np.empty(n, dtype=_I64)
        diff = np.empty(n, dtype=bool)
        diff[0] = True
        diff[1:] = (r_sorted[1:] != r_sorted[:-1]) | (r2_sorted[1:] != r2_sorted[:-1])
        new_rank[order] = np.cumsum(diff) - 1
        rank = new_rank
        if rank[order[-1]] == n - 1:
            return order
        k *= 2


def lcp_kasai_doubling(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """LCP array (lcp[i] = lcp(SA[i-1], SA[i]), lcp[0]=0) via doubling ranks,
    vectorized O(N log N)."""
    n = len(sa)
    lcp = np.zeros(n, dtype=_I64)
    if n <= 1:
        return lcp
    a = sa[:-1].copy()
    b = sa[1:].copy()
    ell = np.zeros(n - 1, dtype=_I64)
    # build rank tables for powers of two
    ranks = []
    rank = np.asarray(text, dtype=_I64)
    k = 1
    while k < n:
        ranks.append(rank)
        rank2 = np.full(n, -1, dtype=_I64)
        rank2[: n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        r_sorted, r2_sorted = rank[order], rank2[order]
        diff = np.empty(n, dtype=bool)
        diff[0] = True
        diff[1:] = (r_sorted[1:] != r_sorted[:-1]) | (r2_sorted[1:] != r2_sorted[:-1])
        new_rank = np.empty(n, dtype=_I64)
        new_rank[order] = np.cumsum(diff) - 1
        rank = new_rank
        k *= 2
    for p in range(len(ranks) - 1, -1, -1):
        step = 1 << p
        rk = ranks[p]
        ok = (a + step <= n) & (b + step <= n)
        ina = np.where(a < n, a, 0)
        inb = np.where(b < n, b, 0)
        same = ok & (rk[ina] == rk[inb])
        ell[same] += step
        a[same] += step
        b[same] += step
    lcp[1:] = ell
    return lcp


@dataclass
class PathIndex:
    """Joined-path suffix index over a list of (graph, tableau) pairs."""

    text: np.ndarray          # +1-shifted labels with terminal 0
    ids: np.ndarray           # node id per text position
    comp: np.ndarray          # component (graph index) per text position
    sa: np.ndarray
    isa: np.ndarray
    lcp: np.ndarray

    @classmethod
    def build(cls, graphs, tableaus, use_native: bool = True) -> "PathIndex":
        texts, ids, comps = [], [], []
        for gi, (graph, tab) in enumerate(zip(graphs, tableaus)):
            for pid in range(graph.path_size):
                p = graph.path(pid)
                texts.append(np.array([tab.src_sentinel + 1], dtype=np.int64))
                ids.append(np.array([tab.src_id], dtype=_I64))
                texts.append(graph.labels[p].astype(np.int64) + 1)
                ids.append(p)
                texts.append(np.array([tab.snk_sentinel + 1], dtype=np.int64))
                ids.append(np.array([tab.snk_id], dtype=_I64))
                comps.append(np.full(len(p) + 2, gi, dtype=np.int8))
        texts.append(np.zeros(1, dtype=np.int64))
        ids.append(np.array([graphs[-1].node_size], dtype=_I64))
        comps.append(np.full(1, len(graphs) - 1, dtype=np.int8))
        text = np.concatenate(texts)
        idarr = np.concatenate(ids)
        comp = np.concatenate(comps)
        if use_native:
            from . import native
            sa, isa, lcp = native.esa_build(text)
        else:
            sa = suffix_array_doubling(text)
            isa = np.empty(len(sa), dtype=_I64)
            isa[sa] = np.arange(len(sa))
            lcp = lcp_kasai_doubling(text, sa)
        return cls(text, idarr, comp, sa, isa, lcp)


def _sparse_table_min(a: np.ndarray):
    """Sparse table for range-min queries over a."""
    n = len(a)
    levels = [a]
    k = 1
    while (1 << k) <= n:
        prev = levels[-1]
        m = n - (1 << k) + 1
        levels.append(np.minimum(prev[:m], prev[(1 << (k - 1)):(1 << (k - 1)) + m]))
        k += 1
    return levels


def _rmq(levels, l, r):
    """min over a[l:r] (r > l)."""
    k = int(r - l).bit_length() - 1
    lev = levels[k]
    return min(lev[l], lev[r - (1 << k)])


def find_minimal_rare_matches(index: PathIndex, num_comps: int, max_count: int):
    """Enumerate minimal rare matches, in the reference's LCP-tree traversal
    order. Returns a list of (sa_begin, sa_end, length, counts)."""
    lcp = index.lcp
    sa = index.sa
    comp = index.comp
    n = len(sa)

    # per-SA-position: start node id, component, and previous SA position
    # with the same (comp, id) — for distinct-start counting
    start_comp = comp[sa]
    start_id = index.ids[sa]
    key = start_comp.astype(_I64) * (int(index.ids.max()) + 2) + start_id
    order = np.argsort(key, kind="stable")
    prev_occ = np.full(n, -1, dtype=_I64)
    ks = key[order]
    same = ks[1:] == ks[:-1]
    prev_occ[order[1:][same]] = order[:-1][same]

    # distinct count of comp c in SA range [b, e]: number of positions i in
    # [b, e] with comp==c and prev_occ[i] < b
    comp_pos = [np.flatnonzero(start_comp == c) for c in range(num_comps)]
    comp_prev = [prev_occ[p] for p in comp_pos]

    def counts_of(b, e):
        out = np.zeros(num_comps, dtype=_I64)
        for c in range(num_comps):
            pos = comp_pos[c]
            lo = np.searchsorted(pos, b, side="left")
            hi = np.searchsorted(pos, e, side="right")
            if hi > lo:
                out[c] = int(np.count_nonzero(comp_prev[c][lo:hi] < b))
        return out

    levels = _sparse_table_min(lcp)

    def link_interval(b, thr):
        """SA interval of the suffix-link string: drop the first character of
        the length-thr prefix of suffix SA[b] -> interval at depth thr - 1."""
        if thr <= 1:
            return (0, n - 1)
        t = sa[b] + 1
        q = int(index.isa[t])
        # expand [lo, hi] around q while min lcp over boundary >= thr - 1
        # lo: smallest lo such that lcp[lo+1..q] all >= thr-1
        lo, hi = q, q
        # binary search left boundary
        lo_lo, lo_hi = 0, q
        while lo_lo < lo_hi:
            mid = (lo_lo + lo_hi) // 2
            if _rmq(levels, mid + 1, q + 1) >= thr - 1:
                lo_hi = mid
            else:
                lo_lo = mid + 1
        lo = lo_lo
        hi_lo, hi_hi = q, n - 1
        while hi_lo < hi_hi:
            mid = (hi_lo + hi_hi + 1) // 2
            if _rmq(levels, q + 1, mid + 1) >= thr - 1:
                hi_lo = mid
            else:
                hi_hi = mid - 1
        hi = hi_lo
        return (lo, hi)

    matches = []

    def consider(cb, ce, parent_depth):
        """Apply the reference's match conditions to child interval [cb, ce]
        with unique length parent_depth+1 (esa.hpp:296-430)."""
        L = parent_depth + 1
        cnt = counts_of(cb, ce)
        if (cnt == 0).any():
            return False
        total = int(np.prod(cnt.astype(np.float64)))
        if total > max_count:
            return True  # too frequent
        if L == 1:
            matches.append((cb, ce, L, cnt))
            return False
        pb, pe = parent_iv
        pcnt = counts_of(pb, pe)
        lb, le = link_interval(cb, L)
        lcnt = counts_of(lb, le)
        if (lcnt > cnt).any() and (pcnt > cnt).any():
            matches.append((cb, ce, L, cnt))
        return False

    # LCP-interval tree traversal (bottom-up stack walk); each internal node
    # is tested as a match against its parent's depth
    stack = [[0, 0, []]]  # [depth, left, children=[(b, e, flagged)]]
    parent_iv = None

    def process(node_b, node_e, depth, children):
        """Process internal node: test each unflagged child."""
        nonlocal parent_iv
        parent_iv = (node_b, node_e)
        any_freq = False
        for (cb, ce, flagged) in children:
            if flagged:
                any_freq = True
                continue
            any_freq |= consider(cb, ce, depth)
        return any_freq

    for i in range(1, n):
        last = None  # (b, e, flagged)
        left = i - 1
        while stack[-1][0] > lcp[i]:
            depth, b, children = stack.pop()
            node = (b, i - 1)
            flag = process(b, i - 1, depth, children)
            last = (b, i - 1, flag)
            left = b
            if stack[-1][0] >= lcp[i]:
                stack[-1][2].append(last)
                last = None
        if stack[-1][0] < lcp[i]:
            stack.append([lcp[i], left, [last] if last is not None else []])
    while stack:
        depth, b, children = stack.pop()
        flag = process(b, n - 1, depth, children)
        if stack:
            stack[-1][2].append((b, n - 1, flag))

    return matches


def walk_matches(index: PathIndex, b: int, e: int, length: int, num_comps: int):
    """Walk out the occurrences of a match interval into node-id paths,
    deduplicated by (comp, start id), in SA order (esa.hpp:613-665)."""
    pos = index.sa[b:e + 1]
    comps = index.comp[pos]
    starts = index.ids[pos]
    key = comps.astype(_I64) * (int(index.ids.max()) + 2) + starts
    _, first = np.unique(key, return_index=True)
    first.sort()
    pos, comps = pos[first], comps[first]
    walks = index.ids[pos[:, None] + np.arange(length)[None, :]]
    return comps, walks


def find_minimal_rare_matches_native(index: PathIndex, max_count: int):
    """Native (C++) minimal-rare-match enumeration; same results and order as
    find_minimal_rare_matches."""
    from . import native
    rows = native.esa_minimal_rare_matches(
        index.sa, index.isa, index.lcp,
        index.comp[index.sa], index.ids[index.sa], max_count)
    return [(int(b), int(e), int(L), np.array([c0, c1], dtype=_I64))
            for (b, e, L, c0, c1) in rows]


def find_matches(graph1, graph2, tableau1, tableau2, max_count: int,
                 score_function=None, use_native: bool = True) -> list[MatchSet]:
    """Top-level equivalent of PathMatchFinder::find_matches
    (match_finder.hpp:73-87,144-212): find minimal rare matches with positive
    anchor weight and walk them out into MatchSets."""
    index = PathIndex.build([graph1, graph2], [tableau1, tableau2],
                            use_native=use_native)
    if use_native:
        from . import native
        rows = native.esa_minimal_rare_matches(
            index.sa, index.isa, index.lcp,
            index.comp[index.sa], index.ids[index.sa], max_count)
        if score_function is not None and len(rows):
            keep = np.array([
                score_function.anchor_weight(int(c0), int(c1), int(L)) > 0.0
                for (_b, _e, L, c0, c1) in rows], dtype=bool)
            rows = rows[keep]
        walks, offsets = native.esa_walk_matches(
            rows, index.sa, index.ids, index.comp)
        match_sets = []
        for m in range(len(rows)):
            L, c0, c1 = (int(rows[m, 2]), int(rows[m, 3]), int(rows[m, 4]))
            w = walks[int(offsets[m]):int(offsets[m]) + (c0 + c1) * L]
            w = w.reshape(c0 + c1, L)
            match_sets.append(MatchSet(
                walks1=w[:c0], walks2=w[c0:], count1=c0, count2=c1,
                full_length=L))
        return match_sets
    raw = find_minimal_rare_matches(index, 2, max_count)
    match_sets = []
    for (b, e, L, cnt) in raw:
        if score_function is not None:
            if score_function.anchor_weight(int(cnt[0]), int(cnt[1]), L) <= 0.0:
                continue
        comps, walks = walk_matches(index, b, e, L, 2)
        w1 = walks[comps == 0]
        w2 = walks[comps == 1]
        match_sets.append(MatchSet(
            walks1=w1, walks2=w2, count1=len(w1), count2=len(w2),
            full_length=L))
    return match_sets


class GESAMatchFinder:
    """Alternative matcher over a prefix-sorted automaton (reference
    match_finder.hpp:92-115, src/match_finder.cpp:7-59): simplify both
    graphs, build a GESA with a size limit, and on GESASizeException
    re-simplify the blowup regions and retry recursively."""

    def __init__(self, score_function=None, max_count: int = 3000):
        from .simplifier import Simplifier
        self.score_function = score_function
        self.max_count = max_count
        self.size_limit_factor = 16
        self.simplifier = Simplifier()
        self.use_color_set_size = True

    def find_matches(self, graph1, graph2, tableau1, tableau2):
        expanded1 = self.simplifier.simplify(graph1, tableau1)
        expanded2 = self.simplifier.simplify(graph2, tableau2)
        return self._index_and_query(expanded1, expanded2)

    def _index_and_query(self, expanded1, expanded2):
        from .gesa import GESA, GESASizeException
        try:
            size_limit = self.size_limit_factor * (
                expanded1.graph.node_size + expanded2.graph.node_size)
            gesa = GESA([expanded1.graph, expanded2.graph],
                        [expanded1.back_translation,
                         expanded2.back_translation],
                        size_limit=size_limit)
            return self._query_index(gesa)
        except GESASizeException as ex:
            from . import logging as logmod
            logmod.log(logmod.Verbose,
                       "Graph not simple enough to index, resimplifying.")
            targets = self.simplifier.identify_target_nodes(ex.curr_counts)
            simplify_dist = 1 << ex.step
            pre1 = expanded1.graph.node_size
            pre2 = expanded2.graph.node_size
            more1 = self.simplifier.targeted_simplify(
                expanded1.graph, expanded1.tableau, targets[0],
                simplify_dist)
            more2 = self.simplifier.targeted_simplify(
                expanded2.graph, expanded2.tableau, targets[1],
                simplify_dist)
            more1.back_translation = [
                expanded1.back_translation[t] for t in more1.back_translation]
            more2.back_translation = [
                expanded2.back_translation[t] for t in more2.back_translation]
            if (pre1 == more1.graph.node_size
                    and pre2 == more2.graph.node_size):
                raise RuntimeError(
                    "Simplification algorithm failed to simplify graph")
            return self._index_and_query(more1, more2)

    def _query_index(self, gesa):
        """The shared query (reference BaseMatchFinder::query_index,
        match_finder.hpp:144-212) over the GESA."""
        match_sets = []
        for node, length, counts in gesa.minimal_rare_matches(
                self.max_count, use_css=self.use_color_set_size):
            if self.score_function is not None:
                if self.score_function.anchor_weight(
                        counts[0], counts[1], length) <= 0.0:
                    continue
            walks1, walks2 = [], []
            for comp, walk in gesa.walk_matches(node, length):
                (walks1 if comp == 0 else walks2).append(walk)
            if not walks1 or not walks2:
                continue
            match_sets.append(MatchSet(
                walks1=np.array(walks1, dtype=np.int64),
                walks2=np.array(walks2, dtype=np.int64),
                count1=len(walks1), count2=len(walks2),
                full_length=length))
        return match_sets

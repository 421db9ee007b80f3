"""Tandem-duplication ("bond") identification for cyclization.

Behavioral twin of the reference Bonder (reference bonder.hpp:47-470,
src/bonder.cpp): project the secondary self-chain onto the optimal chain,
split into shared/intervening segments, and select long near-optimal
deviation-constrained intervals with the O(n^2) partition DP (run natively,
chain_parity.cpp bonder_dev_constrained_partition); trim window ends and
deduplicate reciprocal self-bonds.

Copy of centrolign_tpu/bonder.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_I64 = np.int64
_MININF = float(np.finfo(np.float64).min)


@dataclass
class Bond:
    """(reference bond_t, bonder.hpp:22-36)"""
    path1: str
    path2: str
    offset1: int
    offset2: int
    length: int
    score: float = 0.0


class MinDistanceOracle:
    """min_distance(u, v): min hop count u->v, or -1 (semantics of the
    reference SuperbubbleDistanceOracle; validated equal to
    minmax_distance(graph, {u})[v].first). Chain graphs (the cyclization
    projection graphs) answer in O(1); general DAGs fall back to a memoized
    BFS."""

    def __init__(self, graph):
        self.graph = graph
        self._chain_pos = None
        if graph.path_size >= 1:
            p = graph.path(0)
            if len(p) + 2 >= graph.node_size:  # chain + sentinels
                pos = np.full(graph.node_size, -2, dtype=_I64)
                pos[p] = np.arange(len(p))
                self._chain_pos = pos
                nptr, nind = graph.next_csr()
                pptr, pind = graph.prev_csr()
                self._nptr, self._nind = nptr, nind
        self._memo = {}

    def min_distance(self, u: int, v: int) -> int:
        if self._chain_pos is not None:
            pu, pv = int(self._chain_pos[u]), int(self._chain_pos[v])
            if pu >= 0 and pv >= 0:
                return pv - pu if pv >= pu else -1
        d = self._memo.get(u)
        if d is None:
            g = self.graph
            nptr, nind = g.next_csr()
            d = np.full(g.node_size, -1, dtype=_I64)
            d[u] = 0
            frontier = [u]
            while frontier:
                nxt = []
                for x in frontier:
                    for k in range(nptr[x], nptr[x + 1]):
                        y = int(nind[k])
                        if d[y] == -1:
                            d[y] = d[x] + 1
                            nxt.append(y)
                frontier = nxt
            self._memo[u] = d
        return int(d[v])


@dataclass
class Bonder:
    min_opt_proportion: float = 0.2
    include_gap_scores: bool = True
    min_length: float = 100000.0
    window_length: float = 75000.0
    deviation_drift_factor: float = 150.0
    separation_drift_factor: float = 50.0
    deduplication_slosh_proportion: float = 0.1
    trim_window_proportion: float = 0.1

    def identify_bonds(self, graph1, graph2, tableau1, tableau2,
                       xmerge1, xmerge2, opt_chain, secondary_chain):
        """Returns a list of bond intervals (lists of Bond). (reference
        bonder.hpp:113-470)"""
        from .extractor import extract_graphs_between, source_sink_minmax, StepIndex

        bonds = []
        for on_graph1 in (True, False):
            proj_graph = graph1 if on_graph1 else graph2
            bond_graph = graph2 if on_graph1 else graph1

            def proj_walk(a):
                return a.walk1 if on_graph1 else a.walk2

            def bond_walk(a):
                return a.walk2 if on_graph1 else a.walk1

            node_loc = np.full((proj_graph.node_size, 2), -1, dtype=_I64)
            for i, a in enumerate(opt_chain):
                w = proj_walk(a)
                node_loc[w, 0] = i
                node_loc[w, 1] = np.arange(len(w))

            # records of (sec anchor, idx, opt anchor, idx, length)
            shared_sub = []
            for i, a in enumerate(secondary_chain):
                prev_k = prev_l = -1
                w = proj_walk(a)
                ks = node_loc[w, 0]
                ls = node_loc[w, 1]
                for j in range(len(w)):
                    k, l = int(ks[j]), int(ls[j])
                    if k != -1:
                        if prev_k == k and prev_l == l - 1:
                            shared_sub[-1][4] += 1
                        else:
                            shared_sub.append([i, j, k, l, 1])
                    prev_k, prev_l = k, l

            if not shared_sub:
                continue

            # distance between opt anchors on the projecting graph
            dist_between = np.zeros(max(len(opt_chain) - 1, 0))
            subgraphs_between = extract_graphs_between(
                opt_chain, graph1, graph2, tableau1, tableau2,
                xmerge1, xmerge2)
            for i in range(1, len(subgraphs_between) - 1):
                sub = (subgraphs_between[i][0] if on_graph1
                       else subgraphs_between[i][1])
                if sub.subgraph.node_size != 0:
                    dist_between[i - 1] = source_sink_minmax(sub)[0]

            n = len(shared_sub)
            shared_segments = np.zeros((n, 3))
            intervening = np.zeros((max(n - 1, 1), 3))
            deviation = np.zeros((max(n - 1, 1), 2), dtype=_I64)
            shared_node_ids = np.zeros((n, 4), dtype=_I64)
            for idx in range(n):
                i, j, k, l, length = shared_sub[idx]
                shared_node_ids[idx] = (
                    bond_walk(opt_chain[k])[l],
                    bond_walk(opt_chain[k])[l + length - 1],
                    bond_walk(secondary_chain[i])[j],
                    bond_walk(secondary_chain[i])[j + length - 1])
                shared_segments[idx, 0] = length
                shared_segments[idx, 1] = (
                    length * opt_chain[k].score) / len(opt_chain[k].walk1)
                shared_segments[idx, 2] = (
                    length * secondary_chain[i].score) / len(
                        secondary_chain[i].walk1)
                if idx != 0:
                    pi, pj, pk, pl, plength = shared_sub[idx - 1]
                    b = intervening[idx - 1]
                    if pk == k:
                        b[0] = l - pl - plength
                        b[1] = (b[0] * opt_chain[k].score) / len(
                            opt_chain[k].walk1)
                    else:
                        offset = pl + plength
                        for x in range(pk, k + 1):
                            sublen = (l if x == k
                                      else len(opt_chain[x].walk1) - offset)
                            b[0] += sublen
                            b[1] += (sublen * opt_chain[x].score) / len(
                                opt_chain[x].walk1)
                            if x != k:
                                b[0] += dist_between[x]
                                if self.include_gap_scores:
                                    b[1] += opt_chain[x].gap_score_after
                                deviation[idx - 1, 0] += opt_chain[x].gap_after
                            offset = 0
                    if pi == i:
                        b[2] = ((j - pj - plength)
                                * secondary_chain[i].score) / len(
                                    secondary_chain[i].walk1)
                    else:
                        offset = pj + plength
                        for x in range(pi, i + 1):
                            sublen = (j if x == i
                                      else len(secondary_chain[x].walk1)
                                      - offset)
                            b[2] += (sublen * secondary_chain[x].score) / len(
                                secondary_chain[x].walk1)
                            if x != i:
                                if self.include_gap_scores:
                                    b[2] += secondary_chain[x].gap_score_after
                                deviation[idx - 1, 1] += \
                                    secondary_chain[x].gap_after
                            offset = 0

            # separation per shared segment (LongestNearOptDevConstrained)
            oracle = MinDistanceOracle(proj_graph)
            separation = np.empty(n)
            for idx in range(n):
                s = oracle.min_distance(int(shared_node_ids[idx, 0]),
                                        int(shared_node_ids[idx, 2]))
                if s == -1:
                    s = oracle.min_distance(int(shared_node_ids[idx, 2]),
                                            int(shared_node_ids[idx, 0]))
                separation[idx] = float(s)  # -1 encodes "skip"

            from .native import bonder_partition
            partition = bonder_partition(
                shared_segments, intervening[:n - 1] if n > 1 else
                np.zeros((0, 3)), deviation[:n - 1] if n > 1 else
                np.zeros((0, 2), dtype=_I64), separation,
                self.min_opt_proportion, self.min_length,
                self.deviation_drift_factor, self.separation_drift_factor)

            partition = self.trim_partition_ends(
                partition, shared_segments,
                intervening[:n - 1] if n > 1 else np.zeros((0, 3)))

            if not partition:
                continue
            step_index = StepIndex(bond_graph)
            for (lo, hi) in partition:
                bond_interval = []
                for idx in range(lo, hi):
                    i, j, k, l, length = shared_sub[idx]
                    walk_opt = bond_walk(opt_chain[k])
                    walk_sec = bond_walk(secondary_chain[i])
                    cur1 = cur2 = -1
                    for x in range(length):
                        pid1, off1 = step_index.path_steps(
                            int(walk_opt[l + x]))[0]
                        pid2, off2 = step_index.path_steps(
                            int(walk_sec[j + x]))[0]
                        if (not bond_interval or pid1 != cur1 or pid2 != cur2
                                or bond_interval[-1].offset1
                                + bond_interval[-1].length != off1
                                or bond_interval[-1].offset2
                                + bond_interval[-1].length != off2):
                            if bond_interval:
                                bond_interval[-1].score = (
                                    bond_interval[-1].length
                                    * secondary_chain[i].score) / len(walk_sec)
                            bond_interval.append(Bond(
                                path1=bond_graph.path_name(pid1),
                                path2=bond_graph.path_name(pid2),
                                offset1=off1, offset2=off2, length=1))
                        else:
                            bond_interval[-1].length += 1
                        if bond_interval:
                            bond_interval[-1].score = (
                                bond_interval[-1].length
                                * secondary_chain[i].score) / len(walk_sec)
                        cur1, cur2 = pid1, pid2
                bonds.append(bond_interval)
        return bonds

    # ------------------------------------------------------------------

    def trim_partition_ends(self, partition, shared, intervening):
        """(reference src/bonder.cpp:595-800)"""
        window_length = self.trim_window_proportion * self.min_length
        out = []
        for (first, second) in partition:
            first, second = int(first), int(second)

            def window_fwd(first, second):
                curr_len, opt_w, sec_w = shared[first]
                window_end = first + 1
                p_opt = p_sec = 0.0
                while window_end < second:
                    added = (intervening[window_end - 1, 0]
                             + shared[window_end, 0])
                    if curr_len + added > window_length:
                        if (curr_len + intervening[window_end - 1, 0]
                                < window_length):
                            frac = (window_length - curr_len
                                    - intervening[window_end - 1, 0]) / \
                                shared[window_end, 0]
                            p_opt = intervening[window_end - 1, 1] + \
                                frac * shared[window_end, 1]
                            p_sec = intervening[window_end - 1, 2] + \
                                frac * shared[window_end, 2]
                        else:
                            frac = (window_length - curr_len) / \
                                intervening[window_end - 1, 0]
                            p_opt = frac * intervening[window_end - 1, 1]
                            p_sec = frac * intervening[window_end - 1, 2]
                        break
                    curr_len += added
                    opt_w += (intervening[window_end - 1, 1]
                              + shared[window_end, 1])
                    sec_w += (intervening[window_end - 1, 2]
                              + shared[window_end, 2])
                    window_end += 1
                return curr_len, opt_w, sec_w, p_opt, p_sec, window_end

            curr_len, opt_w, sec_w, p_opt, p_sec, window_end = \
                window_fwd(first, second)
            while (first < second
                   and sec_w + p_sec < self.min_opt_proportion
                   * (opt_w + p_opt)):
                curr_len -= shared[first, 0]
                opt_w -= shared[first, 1]
                sec_w -= shared[first, 2]
                # NOTE: the reference indexes intervening_segments[first]
                # unguarded here (src/bonder.cpp:655), which reads out of
                # bounds when the window has collapsed; we define that case
                # as "no intervening segment"
                if first + 1 != window_end and first < len(intervening):
                    curr_len -= intervening[first, 0]
                    opt_w -= intervening[first, 1]
                    sec_w -= intervening[first, 2]
                first += 1
                p_opt = p_sec = 0.0
                while window_end < second:
                    added = (intervening[window_end - 1, 0]
                             + shared[window_end, 0])
                    if curr_len + added > window_length:
                        if (curr_len + intervening[window_end - 1, 0]
                                < window_length):
                            frac = (window_length - curr_len
                                    - intervening[window_end - 1, 0]) / \
                                shared[window_end, 0]
                            p_opt = intervening[window_end - 1, 1] + \
                                frac * shared[window_end, 1]
                            p_sec = intervening[window_end - 1, 2] + \
                                frac * shared[window_end, 2]
                        else:
                            frac = (window_length - curr_len) / \
                                intervening[window_end - 1, 0]
                            p_opt = frac * intervening[window_end - 1, 1]
                            p_sec = frac * intervening[window_end - 1, 2]
                        break
                    curr_len += added
                    opt_w += (intervening[window_end - 1, 1]
                              + shared[window_end, 1])
                    sec_w += (intervening[window_end - 1, 2]
                              + shared[window_end, 2])
                    window_end += 1

            if first == second:
                continue

            # trim from the end
            curr_len, opt_w, sec_w = shared[second - 1]
            window_begin = second - 1
            p_opt = p_sec = 0.0
            while window_begin > first:
                added = (intervening[window_begin - 1, 0]
                         + shared[window_begin - 1, 0])
                if curr_len + added > window_length:
                    if (curr_len + intervening[window_begin - 1, 0]
                            < window_length):
                        frac = (window_length - curr_len
                                - intervening[window_begin - 1, 0]) / \
                            shared[window_begin - 1, 0]
                        p_opt = intervening[window_begin - 1, 1] + \
                            frac * shared[window_begin - 1, 1]
                        p_sec = intervening[window_begin - 1, 2] + \
                            frac * shared[window_begin - 1, 2]
                    else:
                        frac = (window_length - curr_len) / \
                            intervening[window_begin - 1, 0]
                        p_opt = frac * intervening[window_begin - 1, 1]
                        p_sec = frac * intervening[window_begin - 1, 2]
                    break
                curr_len += added
                window_begin -= 1
                opt_w += (intervening[window_begin, 1]
                          + shared[window_begin, 1])
                sec_w += (intervening[window_begin, 2]
                          + shared[window_begin, 2])
            while (first < second
                   and sec_w + p_sec < self.min_opt_proportion
                   * (opt_w + p_opt)):
                second -= 1
                curr_len -= shared[second, 0]
                opt_w -= shared[second, 1]
                sec_w -= shared[second, 2]
                if window_begin != second and second < len(intervening):
                    curr_len -= intervening[second, 0]
                    opt_w -= intervening[second, 1]
                    sec_w -= intervening[second, 2]
                p_opt = p_sec = 0.0
                while window_begin > first:
                    added = (intervening[window_begin - 1, 0]
                             + shared[window_begin - 1, 0])
                    if curr_len + added > window_length:
                        if (curr_len + intervening[window_begin - 1, 0]
                                < window_length):
                            frac = (window_length - curr_len
                                    - intervening[window_begin - 1, 0]) / \
                                shared[window_begin - 1, 0]
                            p_opt = intervening[window_begin - 1, 1] + \
                                frac * shared[window_begin - 1, 1]
                            p_sec = intervening[window_begin - 1, 2] + \
                                frac * shared[window_begin - 1, 2]
                        else:
                            frac = (window_length - curr_len) / \
                                intervening[window_begin - 1, 0]
                            p_opt = frac * intervening[window_begin - 1, 1]
                            p_sec = frac * intervening[window_begin - 1, 2]
                        break
                    curr_len += added
                    window_begin -= 1
                    opt_w += (intervening[window_begin, 1]
                              + shared[window_begin, 1])
                    sec_w += (intervening[window_begin, 2]
                              + shared[window_begin, 2])
            if first != second:
                out.append((first, second))
        return out

    def deduplicate_self_bonds(self, bonds):
        """(reference src/bonder.cpp:473-560)"""
        import math
        for bi in bonds:
            for b in bi:
                if b.path1 != b.path2 or b.path1 != bi[0].path1:
                    raise RuntimeError(
                        "bond deduplication requires self-bonds")
        slosh = math.ceil(self.deduplication_slosh_proportion
                          * self.min_length)

        def match_or_include(b1, e1, b2, e2):
            return ((b1 - slosh <= b2 and e1 + slosh >= e2)
                    or (b2 - slosh <= b1 and e2 + slosh >= e1))

        keep = [True] * len(bonds)
        for i in range(len(bonds)):
            if not keep[i]:
                continue
            i1 = bonds[i]
            b11, b21 = i1[0].offset1, i1[0].offset2
            e11 = i1[-1].offset1 + i1[-1].length
            e21 = i1[-1].offset2 + i1[-1].length
            for j in range(i + 1, len(bonds)):
                i2 = bonds[j]
                if i1[0].path1 != i2[0].path2:
                    continue
                b12, b22 = i2[0].offset1, i2[0].offset2
                e12 = i2[-1].offset1 + i2[-1].length
                e22 = i2[-1].offset2 + i2[-1].length
                if ((match_or_include(b11, e11, b12, e12)
                     and match_or_include(b21, e21, b22, e22))
                        or (match_or_include(b11, e11, b22, e22)
                            and match_or_include(b21, e21, b12, e12))):
                    len1 = sum(b.length for b in i1)
                    len2 = sum(b.length for b in i2)
                    if len1 > len2:
                        keep[j] = False
                    else:
                        keep[i] = False
                        break
        return [b for k, b in zip(keep, bonds) if k]

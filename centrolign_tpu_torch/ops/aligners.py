"""Host-side fallback aligners used by stitching (reference alignment.hpp):

- shortest_path over a DAG weighted by label size (shortest_path.hpp:16-107)
- pure_deletion_alignment: align the whole graph as a deletion along its
  shortest source-to-sink path (alignment.hpp:1179-1210)
- greedy_partial_alignment: greedy exact-match from both ends plus a double
  deletion through the middle, for unalignable gaps (alignment.hpp:1213-1610)

Copy of centrolign_tpu/ops/aligners.py.
"""

from __future__ import annotations

import numpy as np

from ..alignment import GAP
from ..graph_algs import topological_order

_I64 = np.int64
_INTMAX = np.iinfo(np.int64).max


def shortest_path(graph, node_ids1, node_ids2) -> np.ndarray:
    """Shortest (in bases) path between the node sets, inclusive; empty if
    unreachable. Ties: traceback prefers the first predecessor in adjacency
    order (reference shortest_path.hpp:33-107)."""
    V = graph.node_size
    dp = np.full(V, _INTMAX, dtype=_I64)
    dp[np.asarray(node_ids1, dtype=_I64)] = 0
    next_ptr, next_ind = graph.next_csr()
    for v in topological_order(graph):
        if dp[v] == _INTMAX:
            continue
        thru = dp[v] + 1  # label_size == 1
        nxt = next_ind[next_ptr[v]:next_ptr[v + 1]]
        np.minimum.at(dp, nxt, thru)
    end = -1
    for n in node_ids2:
        if dp[n] != _INTMAX and (end == -1 or dp[n] < dp[end]):
            end = int(n)
    if end == -1:
        return np.empty(0, dtype=_I64)
    prev_ptr, prev_ind = graph.prev_csr()
    path = [end]
    while dp[path[-1]] != 0:
        for p in prev_ind[prev_ptr[path[-1]]:prev_ptr[path[-1] + 1]]:
            # the _INTMAX sentinel would wrap under the +1
            if dp[p] != _INTMAX and dp[p] + 1 == dp[path[-1]]:
                path.append(int(p))
                break
    path.reverse()
    return np.array(path, dtype=_I64)


def pure_deletion_alignment(graph, sources, sinks, params) -> np.ndarray:
    path = np.empty(0, dtype=_I64)
    if graph.node_size != 0:
        path = shortest_path(graph, sources, sinks)
    aln = np.empty((len(path), 2), dtype=_I64)
    aln[:, 0] = path
    aln[:, 1] = GAP
    return aln


def _greedy_extend(graph1, graph2, starts1, starts2, forward: bool):
    """Longest greedy co-linear exact match walk (DFS over the match graph)."""
    lab1, lab2 = graph1.labels, graph2.labels
    if forward:
        ptr1, ind1 = graph1.next_csr()
        ptr2, ind2 = graph2.next_csr()
    else:
        ptr1, ind1 = graph1.prev_csr()
        ptr2, ind2 = graph2.prev_csr()
    backptr = {}
    stack = []
    for n1 in starts1:
        for n2 in starts2:
            if lab1[n1] == lab2[n2]:
                key = (int(n1), int(n2))
                if key not in backptr:
                    backptr[key] = None
                    stack.append((int(n1), int(n2), 1))
    max_len = 0
    path_end = None
    while stack:
        n1, n2, plen = stack.pop()
        if plen > max_len:
            max_len = plen
            path_end = (n1, n2)
        for v1 in ind1[ptr1[n1]:ptr1[n1 + 1]]:
            for v2 in ind2[ptr2[n2]:ptr2[n2 + 1]]:
                if lab1[v1] == lab2[v2] and (int(v1), int(v2)) not in backptr:
                    backptr[(int(v1), int(v2))] = (n1, n2)
                    stack.append((int(v1), int(v2), plen + 1))
    pairs = []
    while path_end is not None:
        pairs.append(path_end)
        path_end = backptr[path_end]
    if forward:
        pairs.reverse()
    return pairs


def greedy_partial_alignment(graph1, graph2, sources1, sources2,
                             sinks1, sinks2, params) -> np.ndarray:
    """(reference alignment.hpp:1213-1610). Reachability tests use
    shortest_path directly (behaviorally equal to the reference's staged
    oracle)."""
    aln_fwd = _greedy_extend(graph1, graph2, sources1, sources2, True)
    aln_rev = _greedy_extend(graph1, graph2, sinks1, sinks2, False)

    left_trim = 0
    right_trim = 0
    sp1 = np.empty(0, dtype=_I64)
    sp2 = np.empty(0, dtype=_I64)
    found = False

    if (not aln_fwd or not aln_rev
            or (aln_fwd[-1][0] != aln_rev[0][0] and aln_fwd[-1][1] != aln_rev[0][1])):
        start1 = [aln_fwd[-1][0]] if aln_fwd else list(sources1)
        end1 = [aln_rev[0][0]] if aln_rev else list(sinks1)
        if start1 and end1:
            sp1 = shortest_path(graph1, start1, end1)
        if len(sp1):
            start2 = [aln_fwd[-1][1]] if aln_fwd else list(sources2)
            end2 = [aln_rev[0][1]] if aln_rev else list(sinks2)
            sp2 = shortest_path(graph2, start2, end2) if (start2 and end2) else np.empty(0, dtype=_I64)
            if len(sp2):
                found = True
                if aln_fwd:
                    sp1, sp2 = sp1[1:], sp2[1:]
                if aln_rev:
                    sp1, sp2 = sp1[:-1], sp2[:-1]

    if not found:
        # The reference's trim search answers its reachability queries
        # through a SuperbubbleDistanceOracle after 8 unindexed probes
        # (alignment.hpp:1430-1520). Equivalent near-O(1) queries here come
        # from three linear DPs per graph: S[v] = latest fwd-walk index
        # that strictly reaches v, srcR[v]/sinkR[v] = strictly
        # reachable-from-source / reaches-sink. Decisions are identical to
        # the shortest_path-existence tests (reachability is reachability).
        oracles = []
        for graph, fwd_col, rev_col, srcs, snks in (
                (graph1, 0, 0, sources1, sinks1),
                (graph2, 1, 1, sources2, sinks2)):
            V = graph.node_size
            order = topological_order(graph)
            nptr, nind = graph.next_csr()
            pptr, pind = graph.prev_csr()
            idx_fwd = np.full(V, -1, dtype=_I64)
            for i, pr in enumerate(aln_fwd):
                idx_fwd[pr[fwd_col]] = i
            is_src = np.zeros(V, dtype=bool)
            is_src[np.asarray(list(srcs), dtype=_I64)] = True
            is_snk = np.zeros(V, dtype=bool)
            is_snk[np.asarray(list(snks), dtype=_I64)] = True
            S = np.full(V, -1, dtype=_I64)
            srcR = np.zeros(V, dtype=bool)
            for v in order:
                ps = pind[pptr[v]:pptr[v + 1]]
                if len(ps):
                    S[v] = max(int(S[ps].max()), int(idx_fwd[ps].max()))
                    srcR[v] = bool(srcR[ps].any() or is_src[ps].any())
            sinkR = np.zeros(V, dtype=bool)
            for v in order[::-1]:
                ns = nind[nptr[v]:nptr[v + 1]]
                if len(ns):
                    sinkR[v] = bool(sinkR[ns].any() or is_snk[ns].any())
            oracles.append((S, srcR, sinkR, is_src, is_snk))

        def _src_reach_eq(g, node):
            S, srcR, sinkR, is_src, is_snk = oracles[g]
            return bool(is_src[node] or srcR[node])

        def _sink_reach_eq(g, node):
            S, srcR, sinkR, is_src, is_snk = oracles[g]
            return bool(is_snk[node] or sinkR[node])

        both_boundary = all(
            bool(o[3].any() and (o[4][o[3]].any() or o[1][o[4]].any()))
            for o in oracles)

        def test_reachability(tl, tr):
            if tl == len(aln_fwd) and tr == len(aln_rev):
                return both_boundary
            if tl == len(aln_fwd):
                r1, r2 = aln_rev[tr]
                return _src_reach_eq(0, r1) and _src_reach_eq(1, r2)
            if tr == len(aln_rev):
                l1, l2 = aln_fwd[len(aln_fwd) - 1 - tl]
                return _sink_reach_eq(0, l1) and _sink_reach_eq(1, l2)
            l1, l2 = aln_fwd[len(aln_fwd) - 1 - tl]
            r1, r2 = aln_rev[tr]
            if l1 == r1 or l2 == r2:
                return False
            li = len(aln_fwd) - 1 - tl
            return (int(oracles[0][0][r1]) >= li
                    and int(oracles[1][0][r2]) >= li)

        lo, hi = 1, len(aln_fwd) + len(aln_rev)
        while lo <= hi:
            total = (lo + hi) // 2
            success = False
            l_min = max(0, total - len(aln_rev))
            l_max = min(total, len(aln_fwd))
            for l in range(l_min, l_max + 1):
                if test_reachability(l, total - l):
                    left_trim, right_trim = l, total - l
                    success = True
                    break
            if success:
                hi = total - 1
            else:
                lo = total + 1

        if left_trim == len(aln_fwd):
            ss1, ss2 = list(sources1), list(sources2)
        else:
            p = aln_fwd[len(aln_fwd) - left_trim - 1]
            ss1, ss2 = [p[0]], [p[1]]
        if right_trim == len(aln_rev):
            kk1, kk2 = list(sinks1), list(sinks2)
        else:
            p = aln_rev[right_trim]
            kk1, kk2 = [p[0]], [p[1]]
        sp1 = shortest_path(graph1, ss1, kk1)
        sp2 = shortest_path(graph2, ss2, kk2)
        if left_trim != len(aln_fwd):
            sp1, sp2 = sp1[1:], sp2[1:]
        if right_trim != len(aln_rev):
            sp1, sp2 = sp1[:-1], sp2[:-1]

    rows = []
    for i in range(len(aln_fwd) - left_trim):
        rows.append(aln_fwd[i])
    for v in sp1:
        rows.append((int(v), GAP))
    for v in sp2:
        rows.append((GAP, int(v)))
    for i in range(right_trim, len(aln_rev)):
        rows.append(aln_rev[i])
    return np.array(rows, dtype=_I64).reshape(-1, 2)

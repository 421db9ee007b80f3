"""Core graph algorithms over BaseGraph, vectorized with numpy.

Equivalents of the reference's header-only algorithms (reference
include/centrolign/topological_order.hpp:12, count_walks.hpp,
minmax_distance.hpp, ...), reformulated as frontier-parallel numpy sweeps so
they stay fast on chain-heavy megabase graphs and so their outputs (orders,
levels) are directly consumable by device kernels.

Copy of centrolign_tpu/graph_algs.py.
"""

from __future__ import annotations

import numpy as np

_I64 = np.int64


def topological_order(graph) -> np.ndarray:
    """Kahn's algorithm, processed frontier-at-a-time.

    Returns a valid topological order. DP results over the graph depend only
    on its topological validity, not on the specific order (the reference's
    order is a stack-based variant; see topological_order.hpp:12).
    """
    V = graph.node_size
    if V == 0:
        return np.empty(0, dtype=_I64)
    indptr, indices = graph.next_csr()
    indeg = graph.in_degrees().copy()
    order = np.empty(V, dtype=_I64)
    frontier = np.flatnonzero(indeg == 0)
    pos = 0
    while len(frontier):
        order[pos : pos + len(frontier)] = frontier
        pos += len(frontier)
        # gather all out-edges of the frontier
        starts, ends = indptr[frontier], indptr[frontier + 1]
        total = (ends - starts).sum()
        if total == 0:
            frontier = np.empty(0, dtype=_I64)
            continue
        targets = indices[_multi_range(starts, ends)]
        dec = np.bincount(targets, minlength=V)
        indeg -= dec
        frontier = np.flatnonzero((indeg == 0) & (dec > 0))
    if pos != V:
        raise ValueError("graph contains a cycle")
    return order


def reference_topological_order(graph) -> np.ndarray:
    """Kahn's algorithm with a LIFO stack, reproducing the reference's exact
    node order (reference topological_order.hpp:12-60): initial sources pushed
    in ascending id order, successors pushed in adjacency order; the stack is
    popped from the back. Use this wherever downstream behavior depends on the
    specific order (path projection, tie-breaking); use topological_order for
    plain DP sweeps."""
    V = graph.node_size
    indeg = graph.in_degrees().copy()
    indptr, indices = graph.next_csr()
    # single-source unary chains have a unique topological order; the
    # vectorized sweep is then exact and much faster
    if (V and (np.diff(indptr) <= 1).all() and (indeg <= 1).all()
            and int((indeg == 0).sum()) == 1):
        return topological_order(graph)
    stack = list(np.flatnonzero(indeg == 0))
    order = np.empty(V, dtype=_I64)
    pos = 0
    while stack:
        v = stack.pop()
        order[pos] = v
        pos += 1
        for w in indices[indptr[v]:indptr[v + 1]]:
            indeg[w] -= 1
            if indeg[w] == 0:
                stack.append(int(w))
    if pos != V:
        raise ValueError("graph contains a cycle")
    return order


def topological_levels(graph) -> np.ndarray:
    """Longest-path depth of each node (level(v) > level(u) for every edge
    u->v). Nodes at equal level are mutually unreachable, which makes levels
    the wavefront index for anti-diagonal DP kernels."""
    V = graph.node_size
    indptr, indices = graph.next_csr()
    indeg = graph.in_degrees().copy()
    level = np.zeros(V, dtype=_I64)
    frontier = np.flatnonzero(indeg == 0)
    depth = 0
    while len(frontier):
        level[frontier] = depth
        starts, ends = indptr[frontier], indptr[frontier + 1]
        if (ends - starts).sum() == 0:
            break
        targets = indices[_multi_range(starts, ends)]
        dec = np.bincount(targets, minlength=V)
        indeg -= dec
        frontier = np.flatnonzero((indeg == 0) & (dec > 0))
        depth += 1
    return level


def _multi_range(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Concatenate arange(starts[i], ends[i]) for all i, vectorized."""
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=_I64)
    nz = lens > 0
    s, l = starts[nz], lens[nz]
    out = np.ones(total, dtype=_I64)
    offsets = np.cumsum(l)[:-1]
    out[0] = s[0]
    if len(s) > 1:
        out[offsets] = s[1:] - (s[:-1] + l[:-1] - 1)
    return np.cumsum(out)


def is_acyclic(graph) -> bool:
    try:
        topological_order(graph)
        return True
    except ValueError:
        return False


def is_reachable(graph, from_id: int, to_id: int) -> bool:
    """BFS reachability (test oracle; production uses XMerge tables)."""
    V = graph.node_size
    seen = np.zeros(V, dtype=bool)
    frontier = np.array([from_id], dtype=_I64)
    seen[from_id] = True
    indptr, indices = graph.next_csr()
    while len(frontier):
        if seen[to_id]:
            return True
        starts, ends = indptr[frontier], indptr[frontier + 1]
        targets = indices[_multi_range(starts, ends)]
        targets = np.unique(targets[~seen[targets]])
        seen[targets] = True
        frontier = targets
    return bool(seen[to_id])


def connected_components(graph) -> list[np.ndarray]:
    """Weakly connected components via label propagation."""
    V = graph.node_size
    if V == 0:
        return []
    ef, et = graph.edges()
    comp = np.arange(V, dtype=_I64)
    # iterate min-label propagation until fixpoint (few rounds in practice
    # thanks to path-halving style jumps)
    while True:
        changed = False
        if len(ef):
            lo = np.minimum(comp[ef], comp[et])
            new = comp.copy()
            np.minimum.at(new, ef, lo)
            np.minimum.at(new, et, lo)
            if not np.array_equal(new, comp):
                comp = new
                changed = True
        # pointer jumping
        jumped = comp[comp]
        if not np.array_equal(jumped, comp):
            comp = jumped
            changed = True
        if not changed:
            break
    groups: dict[int, list[int]] = {}
    roots, inverse = np.unique(comp, return_inverse=True)
    out = [np.flatnonzero(inverse == i) for i in range(len(roots))]
    return out


def antichain_partition(graph) -> np.ndarray:
    """Partition nodes into antichains = the topological levels."""
    return topological_levels(graph)


def count_walks(graph, saturate_at: int = np.iinfo(np.int64).max // 4) -> np.ndarray:
    """Number of source-to-node walks per node, saturating."""
    order = topological_order(graph)
    V = graph.node_size
    counts = np.zeros(V, dtype=np.float64)
    indeg = graph.in_degrees()
    counts[indeg == 0] = 1.0
    indptr, indices = graph.prev_csr()
    for v in order:
        ps = indices[indptr[v] : indptr[v + 1]]
        if len(ps):
            counts[v] = min(float(saturate_at), counts[ps].sum())
    return counts


def shortest_path(graph, from_id: int, to_id: int) -> np.ndarray:
    """A shortest (fewest-nodes) path from from_id to to_id, or empty."""
    V = graph.node_size
    parent = np.full(V, -2, dtype=_I64)
    parent[from_id] = -1
    frontier = np.array([from_id], dtype=_I64)
    indptr, indices = graph.next_csr()
    while len(frontier) and parent[to_id] == -2:
        starts, ends = indptr[frontier], indptr[frontier + 1]
        idx = _multi_range(starts, ends)
        targets = indices[idx]
        srcs = np.repeat(frontier, (ends - starts))
        fresh = parent[targets] == -2
        targets, srcs = targets[fresh], srcs[fresh]
        targets, first = np.unique(targets, return_index=True)
        parent[targets] = srcs[first]
        frontier = targets
    if parent[to_id] == -2:
        return np.empty(0, dtype=_I64)
    path = [to_id]
    while path[-1] != from_id:
        path.append(int(parent[path[-1]]))
    return np.array(path[::-1], dtype=_I64)


def minmax_distance(graph, sources=None):
    """(min, max) walk distance (in nodes) from any source to each node.

    Unreachable nodes get (-1, -1). Mirrors reference minmax_distance.hpp.
    """
    V = graph.node_size
    order = topological_order(graph)
    mind = np.full(V, np.iinfo(np.int64).max, dtype=_I64)
    maxd = np.full(V, np.iinfo(np.int64).min, dtype=_I64)
    if sources is None:
        sources = np.flatnonzero(graph.in_degrees() == 0)
    mind[sources] = 0
    maxd[sources] = 0
    indptr, indices = graph.prev_csr()
    for v in order:
        ps = indices[indptr[v] : indptr[v + 1]]
        if len(ps):
            reach = maxd[ps] != np.iinfo(np.int64).min
            if reach.any():
                mind[v] = min(mind[v], mind[ps[reach]].min() + 1)
                maxd[v] = max(maxd[v], maxd[ps[reach]].max() + 1)
    unreach = maxd == np.iinfo(np.int64).min
    mind[unreach] = -1
    maxd[unreach] = -1
    return mind, maxd


def target_reachability(graph, targets) -> np.ndarray:
    """Whether each node can reach at least one target (reference
    target_reachability.hpp:16-32). Level-parallel reverse sweep: nodes of
    a topological level depend only on deeper levels, so each level is one
    vectorized gather + segmented any."""
    V = graph.node_size
    reachable = np.zeros(V, dtype=bool)
    if V == 0:
        return reachable
    reachable[np.asarray(targets, dtype=_I64)] = True
    levels = topological_levels(graph)
    nptr, nind = graph.next_csr()
    order = np.argsort(levels, kind="stable")
    bounds = np.searchsorted(levels[order], np.arange(levels.max() + 2))
    for lv in range(int(levels.max()), -1, -1):
        nodes = order[bounds[lv]:bounds[lv + 1]]
        if len(nodes) == 0:
            continue
        starts = nptr[nodes]
        ends = nptr[nodes + 1]
        has = ends > starts
        if not has.any():
            continue
        edges = _multi_range(starts[has], ends[has])
        seg = np.repeat(np.arange(len(nodes))[has], (ends - starts)[has])
        hit = np.zeros(len(nodes), dtype=bool)
        np.logical_or.at(hit, seg, reachable[nind[edges]])
        reachable[nodes] |= hit
    return reachable


def bridges(graph) -> np.ndarray:
    """Bridge edges of the graph viewed as undirected (reference
    bridges.hpp:35-139, Schmidt 2013 by way of a low-point DFS): edges
    whose removal disconnects their component, returned oriented forward
    (from, to) as stored in the graph. Parallel edges are never bridges.

    Returns an (M, 2) int64 array."""
    V = graph.node_size
    if V == 0:
        return np.empty((0, 2), dtype=_I64)
    nptr, nind = graph.next_csr()
    pptr, pind = graph.prev_csr()

    # undirected incidence: arcs (neighbor, edge_id) with one shared edge
    # id per stored forward edge — edge_id e is the e-th forward edge
    # (node-major in next_csr order)
    deg = (nptr[1:] - nptr[:-1]) + (pptr[1:] - pptr[:-1])
    aptr = np.zeros(V + 1, dtype=_I64)
    np.cumsum(deg, out=aptr[1:])
    a_nbr = np.empty(aptr[-1], dtype=_I64)
    a_eid = np.empty(aptr[-1], dtype=_I64)
    # forward edge ids in next_csr layout
    eids_fwd = np.arange(len(nind), dtype=_I64)
    # map each prev arc to its forward edge id: for (v, u) in prev arcs,
    # the matching forward arc is (u -> v); count occurrences in order
    cur = aptr[:-1].copy()
    for v in range(V):
        for k in range(nptr[v], nptr[v + 1]):
            a_nbr[cur[v]] = nind[k]
            a_eid[cur[v]] = eids_fwd[k]
            cur[v] += 1
    # prev arcs: pair the j-th parallel (u -> v) prev-arc with the j-th
    # parallel forward arc
    seen: dict = {}
    for v in range(V):
        for k in range(pptr[v], pptr[v + 1]):
            u = int(pind[k])
            j = seen.get((u, v), 0)
            seen[(u, v)] = j + 1
            # find the j-th occurrence of v in u's forward row
            row = nind[nptr[u]:nptr[u + 1]]
            occ = np.flatnonzero(row == v)[j]
            a_nbr[cur[v]] = u
            a_eid[cur[v]] = nptr[u] + occ
            cur[v] += 1

    # iterative low-point DFS over the undirected multigraph; an edge is a
    # bridge iff it is the unique tree edge to a subtree with low >= pre
    pre = np.zeros(V, dtype=_I64)
    low = np.zeros(V, dtype=_I64)
    out = []
    clock = 1
    for root in range(V):
        if pre[root]:
            continue
        stack = [(root, -1, aptr[root])]  # (v, entering edge id, cursor)
        pre[root] = clock
        low[root] = clock
        clock += 1
        while stack:
            v, in_eid, k = stack[-1]
            if k < aptr[v + 1]:
                stack[-1] = (v, in_eid, k + 1)
                u = int(a_nbr[k])
                eid = int(a_eid[k])
                if eid == in_eid:
                    continue  # the tree edge itself (parallel copies pass)
                if pre[u]:
                    low[v] = min(low[v], pre[u])
                else:
                    pre[u] = low[u] = clock
                    clock += 1
                    stack.append((u, eid, aptr[u]))
            else:
                stack.pop()
                if stack:
                    p, p_eid, _ = stack[-1]
                    if low[v] >= pre[v]:
                        e = in_eid
                        out.append((int(nptr.searchsorted(e, "right") - 1),
                                    int(nind[e])))
                    low[p] = min(low[p], low[v])
    return (np.array(sorted(out), dtype=_I64).reshape(-1, 2)
            if out else np.empty((0, 2), dtype=_I64))


def bridge_components(graph):
    """2-edge-connected components after censoring bridges (reference
    bridges.hpp:141-224): list of (node_ids, edges) with edges as (M, 2)
    original-id pairs, components ordered by smallest member id."""
    V = graph.node_size
    br = {(int(a), int(b)) for a, b in bridges(graph)}
    nptr, nind = graph.next_csr()
    pptr, pind = graph.prev_csr()
    comp = np.full(V, -1, dtype=_I64)
    n_comp = 0
    for root in range(V):
        if comp[root] != -1:
            continue
        comp[root] = n_comp
        stack = [root]
        while stack:
            v = stack.pop()
            for u in nind[nptr[v]:nptr[v + 1]]:
                if comp[u] == -1 and (v, int(u)) not in br:
                    comp[u] = n_comp
                    stack.append(int(u))
            for u in pind[pptr[v]:pptr[v + 1]]:
                if comp[u] == -1 and (int(u), v) not in br:
                    comp[u] = n_comp
                    stack.append(int(u))
        n_comp += 1
    out = []
    for c in range(n_comp):
        nodes = np.flatnonzero(comp == c).astype(_I64)
        es = []
        for v in nodes:
            for u in nind[nptr[v]:nptr[v + 1]]:
                if comp[u] == c and (int(v), int(u)) not in br:
                    es.append((int(v), int(u)))
        out.append((nodes, np.array(es, dtype=_I64).reshape(-1, 2)))
    return out


def integer_sort(indexes, ranks) -> np.ndarray:
    """Stable counting sort of `indexes` by small integer ranks (reference
    integer_sort.hpp:12-37): linear time when max(rank) is O(n)."""
    indexes = np.asarray(indexes, dtype=_I64)
    r = np.asarray(ranks, dtype=_I64)
    if len(indexes) == 0:
        return indexes.copy()
    counts = np.bincount(r)
    offsets = np.zeros(len(counts), dtype=_I64)
    np.cumsum(counts[:-1], out=offsets[1:])
    sorted_out = np.empty(len(indexes), dtype=_I64)
    pos = offsets.copy()
    for i, rank in zip(indexes, r):
        sorted_out[pos[rank]] = i
        pos[rank] += 1
    return sorted_out

"""Snarl-tree views, snarl distances, and inconsistency identification for
cyclized graphs.

Behavioral equivalents of the reference's structure_tree.hpp (chains_inside
discovery order, postorder, NetGraph), structure_distances.hpp
(SnarlDistances) and inconsistency_identifier.{hpp,cpp}
(InconsistencyIdentifier) on top of the native cactus/snarl decomposition
(native/cactus_snarls.cpp). All traversal orders replicate the reference so
that downstream realignment subproblems come out in the same order.

Copy of centrolign_tpu/snarls.py.
"""

from __future__ import annotations

import heapq
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from .native import SnarlTree as _NativeSnarlTree
from .utils.cpp_heap import make_heap, pop_heap, push_heap

_I64 = np.int64


def compacted_back_nodes(graph) -> np.ndarray:
    """Boolean mask of nodes that end a maximal unipath (the `back` nodes of
    the reference CompactedGraph, compacted_graph.hpp:65-84)."""
    V = graph.node_size
    nptr, nind = graph.next_csr()
    pptr, _ = graph.prev_csr()
    next_size = np.diff(nptr)
    prev_size = np.diff(pptr)
    back = np.ones(V, dtype=bool)
    one_next = np.flatnonzero(next_size == 1)
    nxt = nind[nptr[one_next]]
    back[one_next[prev_size[nxt] == 1]] = False
    return back


class Snarls:
    """Reference-API view over the snarl decomposition: adds the reference's
    chains_inside discovery order (structure_tree.hpp:233-272), postorder
    (structure_tree.cpp:7-49), and net-graph accessors to the native
    SnarlTree."""

    def __init__(self, graph, tableau):
        self._t = _NativeSnarlTree(graph, tableau)
        self._graph = graph
        self.structure_size = self._t.structure_size
        self.chain_size = self._t.chain_count
        self._compute_chains_inside()

    def _compute_chains_inside(self):
        graph, t = self._graph, self._t
        self._chains_inside = [[] for _ in range(self.structure_size)]
        self._chain_parent = [-1] * self.chain_size
        traversed = np.zeros(graph.node_size, dtype=bool)
        for sid in range(self.structure_size):
            start, end = t.structure_boundaries(sid)
            stack = [start]
            while stack:
                node_id = stack.pop()
                for nxt in graph.next(node_id):
                    nxt = int(nxt)
                    if nxt == end or traversed[nxt]:
                        continue
                    traversed[nxt] = True
                    ns = t.structure_beginning_at(nxt)
                    if ns != -1:
                        cid = t.chain_containing(ns)
                        self._chain_parent[cid] = sid
                        self._chains_inside[sid].append(cid)
                        final_s = t.structures_inside(cid)[-1]
                        final_node = t.structure_boundaries(final_s)[1]
                        traversed[final_node] = True
                        stack.append(final_node)
                    else:
                        stack.append(nxt)

    # ---- reference accessors ----

    def structure_boundaries(self, s):
        return self._t.structure_boundaries(s)

    def structure_beginning_at(self, v):
        return self._t.structure_beginning_at(v)

    def structure_ending_at(self, v):
        return self._t.structure_ending_at(v)

    def chain_containing(self, s):
        return self._t.chain_containing(s)

    def structures_inside(self, c):
        return self._t.structures_inside(c)

    def chains_inside(self, s):
        return self._chains_inside[s]

    def structure_containing(self, c):
        return self._chain_parent[c]

    def snarl_is_acyclic(self, s):
        return self._t.snarl_is_acyclic(s)

    def net_graph_is_acyclic(self, s):
        return bool(self._t.net_acyclic[s])

    def postorder(self):
        """(feature_id, is_chain) pairs, children before parents
        (structure_tree.cpp:7-49: LIFO stack, children pushed in order)."""
        result = []
        for chain_id in range(self.chain_size):
            if self.structure_containing(chain_id) != -1:
                continue
            stack = [[chain_id, True, False]]
            while stack:
                top = stack[-1]
                if top[2]:
                    result.append((top[0], top[1]))
                    stack.pop()
                else:
                    top[2] = True
                    if top[1]:
                        for child in self.structures_inside(top[0]):
                            stack.append([child, False, False])
                    else:
                        for child in self.chains_inside(top[0]):
                            stack.append([child, True, False])
        return result


class NetGraph:
    """A snarl's contents with contained chains condensed to single nodes
    (reference structure_tree.hpp:321-413)."""

    def __init__(self, graph, snarls, snarl_id):
        start, end = snarls.structure_boundaries(snarl_id)
        self.labels = [(start, False)]
        self.edges = [[]]
        fwd = {start: 0}
        stack = [start]
        while stack:
            node_id = stack.pop()
            if node_id == end:
                continue
            for nxt in graph.next(node_id):
                nxt = int(nxt)
                if nxt in fwd:
                    self.edges[fwd[node_id]].append(fwd[nxt])
                    continue
                ns = snarls.structure_beginning_at(nxt)
                if ns != -1 and nxt != end:
                    cid = snarls.chain_containing(ns)
                    net_id = len(self.labels)
                    self.labels.append((cid, True))
                    self.edges.append([])
                    final_s = snarls.structures_inside(cid)[-1]
                    final_node = snarls.structure_boundaries(final_s)[1]
                    fwd[nxt] = net_id
                    fwd[final_node] = net_id
                    self.edges[fwd[node_id]].append(net_id)
                    stack.append(final_node)
                else:
                    net_id = len(self.labels)
                    self.labels.append((nxt, False))
                    self.edges.append([])
                    fwd[nxt] = net_id
                    self.edges[fwd[node_id]].append(net_id)
                    stack.append(nxt)
        self.in_deg = [0] * len(self.labels)
        for es in self.edges:
            for t in es:
                self.in_deg[t] += 1


def _net_topological_order(ng: NetGraph):
    indeg = list(ng.in_deg)
    stack = [i for i in range(len(indeg)) if indeg[i] == 0]
    order = []
    while stack:
        u = stack.pop()
        order.append(u)
        for v in ng.edges[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                stack.append(v)
    return order


class SnarlDistances:
    """Min/max walk length (in nodes, inclusive of both boundaries) through
    each snarl and chain; max is -1 for features containing cycles
    (reference structure_distances.hpp with AssumeAcyclic=false; BaseGraph
    label_size is always 1)."""

    def __init__(self, snarls: Snarls, graph):
        self.struct_dists = [(0, 0)] * snarls.structure_size
        self.chain_dists = [(0, 0)] * snarls.chain_size
        for fid, is_chain in snarls.postorder():
            if is_chain:
                mn, mx = 0, 0
                for i, s in enumerate(snarls.structures_inside(fid)):
                    smn, smx = self.struct_dists[s]
                    mn += smn
                    mx = -1 if (mx == -1 or smx == -1) else mx + smx
                    if i != 0:
                        mn -= 1
                        if mx != -1:
                            mx -= 1
                self.chain_dists[fid] = (mn, mx)
            else:
                self.struct_dists[fid] = self._snarl_dist(snarls, graph, fid)

    def _snarl_dist(self, snarls, graph, fid):
        ng = NetGraph(graph, snarls, fid)
        acyclic = all(self.chain_dists[c][1] != -1
                      for c in snarls.chains_inside(fid))
        if acyclic:
            order = _net_topological_order(ng)
            acyclic = len(order) == len(ng.labels)
        if acyclic:
            INF = 1 << 62
            dp = [[INF, -1] for _ in ng.labels]
            dp[order[0]] = [1, 1]
            for u in order:
                du = dp[u]
                for v in ng.edges[u]:
                    feature_id, is_c = ng.labels[v]
                    if is_c:
                        cmn, cmx = self.chain_dists[feature_id]
                        mn_t, mx_t = du[0] + cmn, du[1] + cmx
                    else:
                        mn_t, mx_t = du[0] + 1, du[1] + 1
                    if mn_t < dp[v][0]:
                        dp[v][0] = mn_t
                    if mx_t > dp[v][1]:
                        dp[v][1] = mx_t
            return (dp[order[-1]][0], dp[order[-1]][1])
        # cyclic: dijkstra for the min distance; max is undefined
        src = next(i for i in range(len(ng.labels)) if ng.in_deg[i] == 0)
        pq = [(1, src)]
        popped = [False] * len(ng.labels)
        dist = [0] * len(ng.labels)
        while pq:
            d, u = heapq.heappop(pq)
            if popped[u]:
                continue
            popped[u] = True
            dist[u] = d
            for v in ng.edges[u]:
                fidv, is_c = ng.labels[v]
                size = self.chain_dists[fidv][0] if is_c else 1
                heapq.heappush(pq, (d + size, v))
        snk = next(i for i in range(len(ng.labels)) if not ng.edges[i])
        return (dist[snk], -1)

    def structure_min_max_dist(self, s):
        return self.struct_dists[s]

    def chain_min_max_dist(self, c):
        return self.chain_dists[c]


def _median(vals):
    """size_t median with floor-average midpoint for even counts
    (reference utility.hpp:289-296)."""
    vals = sorted(vals)
    mid = len(vals) // 2
    if len(vals) % 2 == 0:
        return (vals[mid] + vals[mid - 1]) // 2
    return vals[mid]


@dataclass
class _HeapFrame:
    """(reference inconsistency_identifier.hpp:197-223)"""
    expanded_left_min: int = 0
    expanded_right_min: int = 0
    expanded_left_max: int = 0
    expanded_right_max: int = 0
    can_expand_left: bool = True
    can_expand_right: bool = True
    left_boundary: int = -1
    right_boundary: int = -1
    origin: int = -1

    def frontier(self):
        if ((self.can_expand_left
             and self.expanded_left_min < self.expanded_right_min)
                or not self.can_expand_right):
            return (self.expanded_left_min, True)
        return (self.expanded_right_min, False)


class InconsistencyIdentifier:
    """Identify poorly normalized regions of a cyclized graph for
    realignment (reference inconsistency_identifier.{hpp,cpp})."""

    max_tight_cycle_size = 10000
    max_bond_inconsistency_window = 100
    min_inconsistency_disjoint_length = 8
    min_inconsistency_total_length = 50
    padding_target_min_length = 1000
    padding_max_length_limit = 10000

    def identify_inconsistencies(self, graph, tableau):
        from .extractor import StepIndex
        snarls = Snarls(graph, tableau)
        step_index = StepIndex(graph)
        nontrivial_left_boundary = compacted_back_nodes(graph)

        tight_cycles = self.identify_tight_cycles(
            snarls, step_index, nontrivial_left_boundary)
        inconsistent_bonds = self.identify_inconsistent_bonds(
            snarls, step_index, nontrivial_left_boundary)

        position_in_chain = [0] * snarls.structure_size
        for cid in range(snarls.chain_size):
            for i, s in enumerate(snarls.structures_inside(cid)):
                position_in_chain[s] = i

        snarl_inc = [-1] * snarls.structure_size
        for a, b in tight_cycles:
            snarl_inc[snarls.structure_beginning_at(a)] = \
                snarls.structure_ending_at(b)
        for a, b in inconsistent_bonds:
            sid = snarls.structure_beginning_at(a)
            other = snarls.structure_ending_at(b)
            if (snarl_inc[sid] == -1
                    or position_in_chain[snarl_inc[sid]]
                    < position_in_chain[other]):
                snarl_inc[sid] = other

        # top-down dedup in favor of larger structures
        merged = []
        queue = deque((cid, True) for cid in range(snarls.chain_size)
                      if snarls.structure_containing(cid) == -1)
        while queue:
            fid, is_chain = queue.popleft()
            if not is_chain:
                for cid in snarls.chains_inside(fid):
                    queue.append((cid, True))
                continue
            chain = snarls.structures_inside(fid)
            i = 0
            while i < len(chain):
                if snarl_inc[chain[i]] != -1:
                    if (merged and merged[-1][1]
                            == snarls.structure_boundaries(chain[i])[0]):
                        merged[-1] = (
                            merged[-1][0],
                            snarls.structure_boundaries(
                                snarl_inc[chain[i]])[1])
                    else:
                        merged.append((
                            snarls.structure_boundaries(chain[i])[0],
                            snarls.structure_boundaries(
                                snarl_inc[chain[i]])[1]))
                    while chain[i] != snarls.structure_ending_at(
                            merged[-1][1]):
                        i += 1
                else:
                    queue.append((chain[i], False))
                i += 1

        self.expand_inconsistencies(merged, graph, snarls)
        return merged

    # ---- tight cycles (inconsistency_identifier.cpp:324-469) ----

    def identify_tight_cycles(self, snarls, step_index,
                              nontrivial_left_boundary):
        chain_blocked = [False] * snarls.chain_size
        snarl_blocked = [False] * snarls.structure_size
        chain_desc = [[] for _ in range(snarls.chain_size)]
        snarl_desc = [[] for _ in range(snarls.structure_size)]

        for fid, is_chain in snarls.postorder():
            if is_chain:
                if chain_blocked[fid]:
                    sid = snarls.structure_containing(fid)
                    if sid != -1:
                        snarl_blocked[sid] = True
                    continue
                start = snarls.structure_boundaries(
                    snarls.structures_inside(fid)[0])[0]
                end = snarls.structure_boundaries(
                    snarls.structures_inside(fid)[-1])[1]
            else:
                if snarl_blocked[fid]:
                    chain_blocked[snarls.chain_containing(fid)] = True
                    continue
                start, end = snarls.structure_boundaries(fid)
                if not nontrivial_left_boundary[start]:
                    continue

            pp = {}
            for p, s in step_index.path_steps(start):
                pp.setdefault(p, ([], []))[0].append(s)
            for p, s in step_index.path_steps(end):
                pp.setdefault(p, ([], []))[1].append(s)
            max_path_size = 0
            for a, b in pp.values():
                a.sort()
                b.sort()
                for i in range(len(a)):
                    max_path_size = max(max_path_size, b[i] - a[i])

            if max_path_size > self.max_tight_cycle_size:
                if is_chain:
                    sid = snarls.structure_containing(fid)
                    if sid != -1:
                        snarl_blocked[sid] = True
                else:
                    chain_blocked[snarls.chain_containing(fid)] = True
            elif not is_chain:
                if not snarls.net_graph_is_acyclic(fid):
                    snarl_desc[fid] = [fid]

            if is_chain:
                sid = snarls.structure_containing(fid)
                if sid != -1:
                    snarl_desc[sid].extend(chain_desc[fid])
                    chain_desc[fid] = []
            else:
                cid = snarls.chain_containing(fid)
                chain_desc[cid].extend(snarl_desc[fid])
                snarl_desc[fid] = []

        out = []
        for lists in (chain_desc, snarl_desc):
            for lst in lists:
                for sid in lst:
                    out.append(snarls.structure_boundaries(sid))
        return out

    # ---- inconsistent bonds (inconsistency_identifier.cpp:17-321) ----

    @staticmethod
    def _query_path_positions(step_index, node_id):
        pp = {}
        for p, s in step_index.path_steps(node_id):
            pp.setdefault(p, []).append(s)
        for pos in pp.values():
            pos.sort()
        return pp

    def identify_inconsistent_bonds(self, snarls, step_index,
                                    nontrivial_left_boundary):
        qpp = self._query_path_positions
        out = []
        queue = deque((cid, True) for cid in range(snarls.chain_size)
                      if snarls.structure_containing(cid) == -1)
        while queue:
            fid, is_chain = queue.popleft()
            if not is_chain:
                for cid in snarls.chains_inside(fid):
                    queue.append((cid, True))
                continue
            chain = snarls.structures_inside(fid)
            nontrivial = [i for i in range(len(chain))
                          if nontrivial_left_boundary[
                              snarls.structure_boundaries(chain[i])[0]]]
            if not nontrivial:
                continue

            multipass = {p: pos[:] for p, pos in qpp(
                step_index,
                snarls.structure_boundaries(chain[0])[0]).items()
                if len(pos) > 1}
            used = [False] * len(nontrivial)

            if multipass:
                for p, pos in qpp(
                        step_index,
                        snarls.structure_boundaries(chain[-1])[1]).items():
                    if p in multipass:
                        multipass[p].extend(pos)
                        multipass[p].sort()

                def identify_pass(path_id, pos):
                    arr = multipass.get(path_id)
                    if arr is None:
                        return -1
                    i = bisect_right(arr, pos)
                    assert i % 2 == 1
                    return i // 2

                # per non-trivial snarl: path -> {pass-cover combo: length}
                snarl_psl = []
                for idx in nontrivial:
                    psl = {}
                    for chain_id in snarls.chains_inside(chain[idx]):
                        child = snarls.structures_inside(chain_id)
                        start_node = snarls.structure_boundaries(child[0])[0]
                        end_node = snarls.structure_boundaries(child[-1])[1]
                        csp = qpp(step_index, start_node)
                        cep = qpp(step_index, end_node)
                        for path_id, intervals in multipass.items():
                            which = [False] * (len(intervals) // 2)
                            if path_id not in csp:
                                length = _median(
                                    [cep[p][i] - csp[p][i] + 1
                                     for p in csp
                                     for i in range(len(csp[p]))])
                            else:
                                length = max(
                                    cep[path_id][i] - csp[path_id][i] + 1
                                    for i in range(len(csp[path_id])))
                                for position in csp[path_id]:
                                    which[identify_pass(path_id,
                                                        position)] = True
                            key = tuple(which)
                            d = psl.setdefault(path_id, {})
                            d[key] = d.get(key, 0) + length
                    snarl_psl.append(psl)

                window = [(i, {p: dict(d) for p, d in psl.items()})
                          for i, psl in enumerate(snarl_psl)]
                window_steps = 1
                while window:
                    next_window = []
                    # backwards so the window to the right is marked before
                    # we consider expanding into it
                    for i in range(len(window) - 1, -1, -1):
                        wfirst, psl = window[i]
                        is_susp = False
                        for pass_sets in psl.values():
                            num_passes = len(next(iter(pass_sets)))
                            for p1 in range(num_passes):
                                for p2 in range(p1 + 1, num_passes):
                                    d1 = d2 = nol = 0
                                    for key, length in pass_sets.items():
                                        if key[p1] and not key[p2]:
                                            d1 += length
                                        elif not key[p1] and key[p2]:
                                            d2 += length
                                        elif not key[p1] and not key[p2]:
                                            nol += length
                                    if (d1 >= self.min_inconsistency_disjoint_length
                                            and d2 >= self.min_inconsistency_disjoint_length
                                            and (d1 + d2) // 2 + nol
                                            >= self.min_inconsistency_total_length):
                                        is_susp = True
                                        break
                                if is_susp:
                                    break
                            if is_susp:
                                break
                        if is_susp:
                            out.append((
                                snarls.structure_boundaries(
                                    chain[nontrivial[wfirst]])[0],
                                snarls.structure_boundaries(
                                    chain[nontrivial[
                                        wfirst + window_steps - 1]])[1]))
                            for j in range(wfirst, wfirst + window_steps):
                                used[j] = True
                        elif (wfirst + window_steps < len(nontrivial)
                              and not used[wfirst + window_steps]
                              and nontrivial[wfirst + window_steps]
                              - nontrivial[wfirst]
                              < self.max_bond_inconsistency_window):
                            nxt_psl = snarl_psl[wfirst + window_steps]
                            for p, d_from in nxt_psl.items():
                                d_into = psl.get(p)
                                if d_into is None:
                                    psl[p] = dict(d_from)
                                else:
                                    for k, v in d_from.items():
                                        d_into[k] = d_into.get(k, 0) + v
                            next_window.append((wfirst, psl))
                    window_steps += 1
                    window = next_window

            for idx in range(len(nontrivial)):
                if not used[idx]:
                    queue.append((chain[nontrivial[idx]], False))
        return out

    # ---- padding expansion (inconsistency_identifier.hpp:190-340) ----

    def expand_inconsistencies(self, inconsistencies, graph, snarls):
        if not inconsistencies:
            return
        snarl_distances = SnarlDistances(snarls, graph)

        frames = []
        is_boundary = set()
        for i, (a, b) in enumerate(inconsistencies):
            is_boundary.add(a)
            is_boundary.add(b)
            frames.append(_HeapFrame(left_boundary=a, right_boundary=b,
                                     origin=i))

        def less(x, y):
            return x.frontier() > y.frontier()

        make_heap(frames, less)
        while frames:
            pop_heap(frames, less)
            nxt = frames[-1]
            if nxt.frontier()[1]:
                ns = snarls.structure_ending_at(nxt.left_boundary)
                if ns == -1:
                    nxt.can_expand_left = False
                else:
                    nb = snarls.structure_boundaries(ns)[0]
                    if nb in is_boundary:
                        nxt.can_expand_left = False
                    else:
                        mn, mx = snarl_distances.structure_min_max_dist(ns)
                        if mx == -1:
                            nxt.can_expand_left = False
                        else:
                            nmn = nxt.expanded_left_min + mn - 1
                            nmx = nxt.expanded_left_max + mx - 1
                            if (nmn > self.padding_target_min_length
                                    or nmx > self.padding_max_length_limit):
                                nxt.can_expand_left = False
                            else:
                                nxt.expanded_left_min = nmn
                                nxt.expanded_left_max = nmx
                                is_boundary.discard(nxt.left_boundary)
                                nxt.left_boundary = nb
                                is_boundary.add(nb)
            else:
                ns = snarls.structure_beginning_at(nxt.right_boundary)
                if ns == -1:
                    nxt.can_expand_right = False
                else:
                    nb = snarls.structure_boundaries(ns)[1]
                    if nb in is_boundary:
                        nxt.can_expand_right = False
                    else:
                        mn, mx = snarl_distances.structure_min_max_dist(ns)
                        if mx == -1:
                            nxt.can_expand_right = False
                        else:
                            nmn = nxt.expanded_right_min + mn - 1
                            nmx = nxt.expanded_right_max + mx - 1
                            if (nmn > self.padding_target_min_length
                                    or nmx > self.padding_max_length_limit):
                                nxt.can_expand_right = False
                            else:
                                nxt.expanded_right_min = nmn
                                nxt.expanded_right_max = nmx
                                is_boundary.discard(nxt.right_boundary)
                                nxt.right_boundary = nb
                                is_boundary.add(nb)
            if not nxt.can_expand_left and not nxt.can_expand_right:
                inconsistencies[nxt.origin] = (nxt.left_boundary,
                                               nxt.right_boundary)
                frames.pop()
            else:
                push_heap(frames, less)

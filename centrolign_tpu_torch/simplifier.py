"""Simplifier: blow apart high-walk-count superbubble regions by trie
expansion of path intervals so the GESA can index them (reference
simplifier.hpp:39-101, src/simplifier.cpp), plus the labeled Trie it uses
(reference trie.hpp:14, src/trie.cpp).

Windowed walk-count scanning over each superbubble chain marks intervals
whose walk product exceeds ``max_walks``; each marked interval's path
traversals are inserted (reversed, to preserve reverse determinism) into a
trie which replaces the interval in the expanded graph. Mergeable trie
leaves (same origin node, linear parents) are re-merged.

Node ordering of the expanded graph follows this implementation's
deterministic traversals; the GESA match-finding path has no byte-parity
obligation (it is validated against brute-force oracles, like the
reference's own tests).

Copy of centrolign_tpu/simplifier.py."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .graph import BaseGraph
from .modify_graph import SentinelTableau

_I64 = np.int64
NONE = -1


class Trie:
    """(reference trie.hpp:14; children kept in insertion order so
    traversals are deterministic)"""

    def __init__(self):
        self.label = [NONE]
        self.parent = [NONE]
        self.children = [{}]
        self.paths = []

    def insert_sequence(self, name, sequence):
        self.paths.append((name, []))
        path = self.paths[-1][1]
        here = 0
        for v in sequence:
            v = int(v)
            nxt = self.children[here].get(v, NONE)
            if nxt != NONE:
                path.append(nxt)
                here = nxt
            else:
                new_id = len(self.label)
                self.children[here][v] = new_id
                path.append(new_id)
                self.label.append(v)
                self.parent.append(here)
                self.children.append({})
                here = new_id
        return len(self.paths) - 1

    def clear(self):
        self.label = []
        self.parent = []
        self.children = []
        self.paths = []

    @property
    def node_size(self):
        return len(self.label)

    def get_root(self):
        return 0

    def get_parent(self, node_id):
        return self.parent[node_id]

    def next(self, node_id):
        return list(self.children[node_id].values())

    def next_size(self, node_id):
        return len(self.children[node_id])

    def follow(self, node_id, label):
        return self.children[node_id].get(int(label), NONE)

    def path_name(self, path_id):
        return self.paths[path_id][0]

    def path(self, path_id):
        return self.paths[path_id][1]

    @property
    def path_size(self):
        return len(self.paths)

    def count_walks(self):
        # walks = number of leaves (each root-to-leaf path)
        return sum(1 for c in self.children if not c) or 1


@dataclass
class ExpandedGraph:
    """(reference simplifier.hpp:20-34)"""
    graph: BaseGraph = field(default_factory=BaseGraph)
    back_translation: list = field(default_factory=list)
    tableau: SentinelTableau = None


class Simplifier:
    """(reference simplifier.hpp:39)"""

    def __init__(self):
        self.min_dist_window = 128
        self.preserve_bubble_size = 32
        self.max_walks = 24
        self.min_resimplify_fraction = 0.01
        self.max_resimplify_count = 1000

    # -- helpers over the native superbubble decomposition

    @staticmethod
    def _chain_postorder(bub):
        """Chain ids, children-first (chain_parent gives the enclosing
        structure)."""
        depth = {}

        def chain_depth(c):
            if c in depth:
                return depth[c]
            parent_struct = int(bub.chain_parent[c])
            d = 0 if parent_struct == NONE else 1 + chain_depth(
                int(bub.chain_of[parent_struct]))
            depth[c] = d
            return d

        order = sorted(range(bub.chain_count),
                       key=lambda c: -chain_depth(c))
        return order

    @staticmethod
    def _child_chains(bub, struct_id):
        return [c for c in range(bub.chain_count)
                if int(bub.chain_parent[c]) == struct_id]

    def _count_walks_bubble(self, graph, bub, struct_id, chain_subwalks):
        """Walk count through one superbubble, child chains contracted to
        single weighted nodes (the NetGraph + count_walks_hierarchical of
        the reference)."""
        s, t = bub.structure_boundaries(struct_id)
        # map: chain start boundary -> (chain end boundary, weight)
        contract = {}
        for c in self._child_chains(bub, struct_id):
            structs = bub.structures_inside(c)
            start = bub.structure_boundaries(structs[0])[0]
            end = bub.structure_boundaries(structs[-1])[1]
            contract[start] = (end, chain_subwalks[c])
        CAP = 1 << 64
        succs = {}

        def successors(v):
            # a contracted child chain acts as one node: enter at its start
            # boundary, exit from its end boundary
            if v in succs:
                return succs[v]
            if v == t:
                out = []
            elif v in contract and v != s:
                end, _w = contract[v]
                out = [] if end == t else [int(x) for x in graph.next(end)]
                if end == t:
                    out = [t]
            else:
                out = [int(x) for x in graph.next(v)]
            succs[v] = out
            return out

        # build interior node list
        interior = []
        stack = [s]
        visited = {s}
        while stack:
            v = stack.pop()
            interior.append(v)
            for w in successors(v):
                if w not in visited and w != t:
                    visited.add(w)
                    stack.append(w)
        visited.add(t)
        # in-degrees within the contracted region
        indeg = {t: 0}
        for v in interior:
            for w in successors(v):
                indeg[w] = indeg.get(w, 0) + 1
        indeg[s] = 0
        # Kahn
        counts = {v: 0 for v in visited}
        counts[s] = 1
        ready = [s]
        while ready:
            v = ready.pop()
            w_mult = 1
            if v in contract and v != s:
                w_mult = contract[v][1]
            out_count = min(counts[v] * w_mult, CAP)
            for w in successors(v):
                counts[w] = min(counts[w] + out_count, CAP)
                indeg[w] -= 1
                if indeg[w] == 0 and w != t:
                    ready.append(w)
        return max(counts.get(t, 0), 1)

    # -- the main entry points

    def simplify(self, graph, tableau) -> ExpandedGraph:
        """(src/simplifier.cpp:24-162)"""
        from .native import SuperbubbleTree
        from .extractor import StepIndex
        bub = SuperbubbleTree(graph, tableau)
        step_index = StepIndex(graph)

        chain_subwalks = [0] * bub.chain_count
        interval_rev_tries = []
        node_to_trie = [NONE] * graph.node_size

        for chain_id in self._chain_postorder(bub):
            chain = bub.structures_inside(chain_id)
            walk_sub_counts = [0] * len(chain)
            do_split = [False] * len(chain)
            factors = []
            prod = 1
            window_width = 0
            window_begin = 0
            for i, struct_id in enumerate(chain):
                walk_sub_counts[i] = self._count_walks_bubble(
                    graph, bub, struct_id, chain_subwalks)
                prod *= walk_sub_counts[i]
                factors.append(walk_sub_counts[i])
                mn, mx = bub.structure_min_max_dist(struct_id)
                if mx >= self.preserve_bubble_size:
                    window_begin = i + 1
                    window_width = 0
                    prod = 1
                    factors = []
                    continue
                window_width += mn
                if window_begin != i:
                    window_width -= 1
                while window_width > self.min_dist_window:
                    window_width -= bub.structure_min_max_dist(
                        chain[window_begin])[0]
                    if window_begin != i:
                        window_width += 1
                    prod //= factors.pop(0)
                    window_begin += 1
                if prod > self.max_walks:
                    j = i
                    while j >= window_begin and not do_split[j]:
                        do_split[j] = True
                        j -= 1

            simp_count = 1
            i = 0
            while i < len(do_split):
                if do_split[i]:
                    j = i + 1
                    while j < len(do_split) and do_split[j]:
                        j += 1
                    self._simplify_chain_interval(
                        graph, step_index, bub, interval_rev_tries,
                        node_to_trie, chain_id, i, j)
                    simp_count *= interval_rev_tries[-1][0].count_walks()
                    i = j
                else:
                    simp_count *= max(walk_sub_counts[i], 1)
                    i += 1
            chain_subwalks[chain_id] = simp_count

        return self._perform_simplification(
            graph, tableau, step_index, interval_rev_tries, node_to_trie)

    def _simplify_chain_interval(self, graph, step_index, bub,
                                 interval_rev_tries, node_to_trie,
                                 chain_id, begin, end):
        """(src/simplifier.cpp:163-222)"""
        chain = bub.structures_inside(chain_id)
        start_id = bub.structure_boundaries(chain[begin])[0]
        end_id = bub.structure_boundaries(chain[end - 1])[1]
        trie_idx = len(interval_rev_tries)
        trie = Trie()
        interval_rev_tries.append((trie, start_id))
        for pid, step in step_index.path_steps(end_id):
            path = graph.path(pid)
            rev_seq = []
            i = step
            while int(path[i]) != start_id:
                node_id = int(path[i])
                node_to_trie[node_id] = trie_idx
                rev_seq.append(node_id)
                i -= 1
            trie.insert_sequence(graph.path_name(pid), rev_seq)

    def _mergeable_nodes(self, trie):
        """(src/simplifier.cpp:616-662)"""
        mergeable = []
        stack = [[n for n in range(trie.node_size)
                  if trie.next_size(n) == 0]]
        while stack:
            node_set = stack.pop()
            sets = {}
            for n in node_set:
                sets.setdefault(trie.label[n], []).append(n)
            for lab, subset in sets.items():
                if len(subset) > 1:
                    parents = [trie.get_parent(n) for n in subset
                               if trie.next_size(trie.get_parent(n)) == 1]
                    mergeable.append(subset)
                    if len(parents) > 1:
                        stack.append(parents)
        return mergeable

    def _perform_simplification(self, graph, tableau, step_index,
                                interval_rev_tries, node_to_trie):
        """(src/simplifier.cpp:224-362)"""
        from .graph_algs import topological_order
        out = ExpandedGraph()
        for pid in range(graph.path_size):
            out.graph.add_path(graph.path_name(pid))
        forward = [NONE] * graph.node_size
        inserted = [False] * len(interval_rev_tries)
        for node_id in topological_order(graph):
            node_id = int(node_id)
            ti = node_to_trie[node_id]
            if ti == NONE:
                new_id = out.graph.add_node(graph.label(node_id))
                out.back_translation.append(node_id)
                forward[node_id] = new_id
                for prev_id in graph.previous(node_id):
                    out.graph.add_edge(forward[int(prev_id)], new_id)
                for pid, _step in step_index.path_steps(node_id):
                    out.graph.extend_path(pid, new_id)
            elif not inserted[ti]:
                inserted[ti] = True
                trie, entry_id = interval_rev_tries[ti]
                tft = [NONE] * trie.node_size
                assert trie.next_size(trie.get_root()) == 1
                trie_sink = trie.next(trie.get_root())[0]
                for group in self._mergeable_nodes(trie):
                    orig = trie.label[group[0]]
                    new_id = out.graph.add_node(graph.label(orig))
                    for tn in group:
                        tft[tn] = new_id
                    out.back_translation.append(orig)
                for tn in range(trie.node_size):
                    if tn == trie.get_root() or tft[tn] != NONE:
                        continue
                    orig = trie.label[tn]
                    new_id = out.graph.add_node(graph.label(orig))
                    tft[tn] = new_id
                    out.back_translation.append(orig)
                edges = set()
                for tn in range(trie.node_size):
                    if tn == trie.get_root() or tn == trie_sink:
                        continue
                    edges.add((tft[tn], tft[trie.get_parent(tn)]))
                for tpid in range(trie.path_size):
                    pid = graph.path_id(trie.path_name(tpid))
                    tpath = trie.path(tpid)
                    for i in range(len(tpath) - 1, -1, -1):
                        out.graph.extend_path(pid, tft[tpath[i]])
                    edges.add((forward[entry_id], tft[tpath[-1]]))
                for a, b in sorted(edges):
                    out.graph.add_edge(a, b)
                forward[trie.label[trie_sink]] = tft[trie_sink]
        out.tableau = SentinelTableau(
            src_id=forward[tableau.src_id],
            snk_id=forward[tableau.snk_id],
            src_sentinel=tableau.src_sentinel,
            snk_sentinel=tableau.snk_sentinel)
        return out

    def targeted_simplify(self, graph, tableau, node_ids,
                          distance) -> ExpandedGraph:
        """(src/simplifier.cpp:364-614): walk `distance` ahead of the target
        nodes, find the containing superbubbles, and trie-expand them."""
        from .native import SuperbubbleTree
        from .extractor import StepIndex

        # forward walk: collect nodes within `distance` after targets
        # (unipath compaction is an optimization in the reference; a plain
        # bounded multi-source BFS visits the same nodes)
        simplify_nodes = set()
        from collections import deque
        best = {}
        dq = deque()
        for n in node_ids:
            n = int(n)
            best[n] = 0
            dq.append(n)
        while dq:
            v = dq.popleft()
            d = best[v]
            if v not in (tableau.src_id, tableau.snk_id):
                simplify_nodes.add(v)
            if d >= distance:
                continue
            for w in graph.next(v):
                w = int(w)
                if w not in best or best[w] > d + 1:
                    best[w] = d + 1
                    dq.append(w)

        bub = SuperbubbleTree(graph, tableau)
        simplify_bubble = [False] * bub.structure_size
        traversed = [False] * graph.node_size
        for node_id in sorted(simplify_nodes):
            b = bub.structure_beginning_at(node_id)
            if b != NONE:
                simplify_bubble[b] = True
                continue
            stack = [] if traversed[node_id] else [node_id]
            while stack:
                here = stack.pop()
                if traversed[here]:
                    continue
                e = bub.structure_ending_at(here)
                if e != NONE:
                    simplify_bubble[e] = True
                    break
                traversed[here] = True
                for nxt in graph.next(here):
                    nxt = int(nxt)
                    nb = bub.structure_beginning_at(nxt)
                    if nb != NONE and bub.structure_ending_at(nxt) == NONE:
                        c = bub.chain_containing(nb)
                        final = bub.structures_inside(c)[-1]
                        stack.append(bub.structure_boundaries(final)[1])
                    else:
                        stack.append(nxt)

        interval_rev_tries = []
        node_to_trie = [NONE] * graph.node_size
        step_index = StepIndex(graph)
        for chain_id in self._chain_postorder(bub):
            chain = bub.structures_inside(chain_id)
            i = 0
            while i < len(chain):
                if simplify_bubble[chain[i]]:
                    j = i + 1
                    while j < len(chain) and simplify_bubble[chain[j]]:
                        j += 1
                    self._simplify_chain_interval(
                        graph, step_index, bub, interval_rev_tries,
                        node_to_trie, chain_id, i, j)
                    i = j
                else:
                    i += 1
        return self._perform_simplification(
            graph, tableau, step_index, interval_rev_tries, node_to_trie)

    def identify_target_nodes(self, node_counts):
        """(src/simplifier.cpp:664-714)"""
        flat = np.concatenate([np.asarray(c, dtype=_I64)
                               for c in node_counts]) \
            if any(len(c) for c in node_counts) else np.empty(0, _I64)
        if len(flat) == 0:
            return [[] for _ in node_counts]
        k = int(self.min_resimplify_fraction * len(flat))
        cutoff = min(int(np.partition(flat, k)[k]),
                     self.max_resimplify_count)
        targets = []
        for counts in node_counts:
            counts = np.asarray(counts, dtype=_I64)
            targets.append(np.flatnonzero(counts > cutoff).tolist())
        return targets

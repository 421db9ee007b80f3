"""GESA: an enhanced suffix array over a prefix-sorted automaton, built by
GCSA-style prefix doubling (reference gesa.hpp:24, path_graph.hpp:27,
src/gesa.cpp, src/path_graph.cpp, and the shared ESA machinery of
esa.hpp:37-720).

Structure:
 - ``PathGraph``: one graph per doubling phase; nodes are (from, to, rank)
   triples whose rank orders prefixes of length 2^step; a doubling step
   joins the relation on to==from, merges equal rank pairs, and maintains
   the LCP array via range-min queries over the previous LCP
   (path_graph.hpp:27, src/path_graph.cpp:58-247). Raising past
   ``size_limit`` throws PathGraphSizeException with per-node blowup counts.
 - ``ESACore``: the LCP-interval-tree machinery shared with the reference's
   ESA base: child array (Abouelhoda et al. 2004), children, suffix links
   via l-interval binary search, Hui color-set-size counts via Euler-tour
   LCA, minimal-rare-match enumeration, and match walking
   (esa.hpp:120-665, src/esa.cpp:14-330).
 - ``GESA``: joins the input graphs into components, doubles to prefix
   sortedness, maps automaton nodes back to original node ids, labels
   suffix-tree edges via skip edges, and exposes minimal_rare_matches /
   walk_matches (gesa.hpp:120-280, src/gesa.cpp:70-270).

Copy of centrolign_tpu/gesa.py.
"""

from __future__ import annotations

import numpy as np

from .utils.queries import RMQ, RUQ

_I64 = np.int64
NULL_ID = -1


class PathGraphSizeException(Exception):
    """(reference path_graph.hpp:126)"""

    def __init__(self, curr_count, prev_count, step):
        super().__init__("Exceeded PathGraph size limit")
        self.curr_count = curr_count
        self.prev_count = prev_count
        self.step = step


class GESASizeException(Exception):
    """(reference gesa.hpp:86-110)"""

    def __init__(self, path_ex: PathGraphSizeException, node_to_comp,
                 component_ranges):
        super().__init__("Size limit exceeded while constructing GESA")
        self.step = path_ex.step
        ncomp = len(component_ranges) - 1
        self.curr_counts = [[] for _ in range(ncomp)]
        self.prev_counts = [[] for _ in range(ncomp)]
        for node_id in range(len(path_ex.curr_count)):
            comp = node_to_comp[node_id]
            orig = node_id - component_ranges[comp]
            for lst in (self.curr_counts[comp], self.prev_counts[comp]):
                while len(lst) <= orig:
                    lst.append(0)
            self.curr_counts[comp][orig] = path_ex.curr_count[node_id]
            self.prev_counts[comp][orig] = path_ex.prev_count[node_id]


def _stable_sort_by(indexes, keys):
    keys = np.asarray([keys[i] for i in indexes], dtype=_I64)
    order = np.argsort(keys, kind="stable")
    return [indexes[i] for i in order]


class PathGraph:
    """(reference path_graph.hpp:27)"""

    def __init__(self, source, size_limit=None):
        self.doubling_step = 0
        self.lcp_array = []
        self.edges_next = None
        self.edges_prev = None
        if isinstance(source, PathGraph):
            self._double(source, size_limit)
        else:
            self._init_from_graph(source)

    # -- accessors
    def node_size(self):
        return len(self.from_)

    def is_prefix_sorted(self):
        return len(self.from_) == 0 or \
            len(self.lcp_array) + 1 == len(self.from_)

    def _init_from_graph(self, graph):
        from_, to, rank = [], [], []
        seen = set()
        for node_id in range(graph.node_size):
            nxt = graph.next(node_id)
            if len(nxt) == 0:
                from_.append(node_id)
                to.append(NULL_ID)
            else:
                for next_id in nxt:
                    from_.append(node_id)
                    to.append(int(next_id))
            seen.add(int(graph.label(node_id)))
        # rank by label, 0-based over the labels present
        labels = sorted(seen)
        label_rank = {c: i for i, c in enumerate(labels)}
        rank = [label_rank[int(graph.label(f))] for f in from_]

        # merge redundant equal-rank nodes that share a from
        idxs = _stable_sort_by(list(range(len(from_))), rank)
        remove = [False] * len(from_)
        i = 0
        while i < len(idxs):
            j = i + 1
            shared_from = True
            while j < len(idxs) and rank[idxs[j]] == rank[idxs[i]]:
                shared_from = shared_from and from_[idxs[j]] == from_[idxs[i]]
                j += 1
            if shared_from:
                for k in range(i + 1, j):
                    remove[idxs[k]] = True
            i = j
        self.from_ = [f for f, r in zip(from_, remove) if not r]
        self.to = [t for t, r in zip(to, remove) if not r]
        self.rank = [k for k, r in zip(rank, remove) if not r]
        self.join_rank = [0] * len(self.from_)
        self.lcp_array = [0] * (len(labels) - 1)

    def _double(self, g: "PathGraph", size_limit):
        self.doubling_step = g.doubling_step + 1
        limit = size_limit if size_limit is not None else float("inf")

        n = g.node_size()
        order_by_from = _stable_sort_by(list(range(n)), g.from_)
        order_by_to = _stable_sort_by(
            list(range(n)), [t + 1 for t in g.to])

        rank_count = {}
        for i in range(n):
            rank_count[g.rank[i]] = min(rank_count.get(g.rank[i], 0) + 1, 2)

        from_, to, rank, join_rank = [], [], [], []

        def raise_size():
            raise PathGraphSizeException(
                _from_counts(from_), _from_counts(g.from_),
                self.doubling_step)

        def _from_counts(fr):
            out = []
            for f in fr:
                while len(out) <= f:
                    out.append(0)
                out[f] += 1
            return out

        i = j = 0
        nt = len(order_by_to)
        while i < nt:
            i_end = i + 1
            ti = g.to[order_by_to[i]]
            while i_end < nt and g.to[order_by_to[i_end]] == ti:
                i_end += 1
            while j < n and g.from_[order_by_from[j]] + 1 < ti + 1:
                j += 1
            j_end = j
            while j_end < n and g.from_[order_by_from[j_end]] == ti:
                j_end += 1
            for ii in range(i, i_end):
                node_id = order_by_to[ii]
                if rank_count[g.rank[node_id]] == 1:
                    from_.append(g.from_[node_id])
                    to.append(g.to[node_id])
                    rank.append(g.rank[node_id])
                    join_rank.append(0)
                    if len(from_) > limit:
                        raise_size()
                else:
                    for jj in range(j, j_end):
                        from_.append(g.from_[node_id])
                        to.append(g.to[order_by_from[jj]])
                        rank.append(g.rank[node_id])
                        join_rank.append(g.rank[order_by_from[jj]])
                        if len(from_) > limit:
                            raise_size()
            i = i_end
            j = j_end

        # convert pair ranks to integer ranks, merge redundancies, and
        # extend the LCP array (src/path_graph.cpp:168-247)
        m = len(from_)
        idxs = _stable_sort_by(list(range(m)), join_rank)
        idxs = _stable_sort_by(idxs, [rank[i] for i in idxs])
        # hmm: _stable_sort_by(indexes, keys) expects keys indexed by the
        # VALUES of indexes; fix by passing full key arrays
        idxs = _stable_sort_by(list(range(m)), join_rank)
        idxs = _stable_sort_by(idxs, rank)

        lcp_rmq = RMQ(np.asarray(g.lcp_array, dtype=_I64)) \
            if g.lcp_array else None

        remove = [False] * m
        next_rank = 0
        prev_pre = (0, 0)
        lcp_array = []
        i = 0
        while i < m:
            j = i + 1
            while (j < m and rank[idxs[i]] == rank[idxs[j]]
                   and join_rank[idxs[i]] == join_rank[idxs[j]]):
                j += 1
            if next_rank != 0:
                r1, r2 = rank[idxs[i]], join_rank[idxs[i]]
                if r1 == prev_pre[0]:
                    if r2 == prev_pre[1]:
                        lcp = 1 << self.doubling_step
                    else:
                        lo, hi = min(r2, prev_pre[1]), max(r2, prev_pre[1])
                        lcp = ((1 << g.doubling_step)
                               + g.lcp_array[lcp_rmq.range_arg_min(lo, hi)])
                else:
                    lo, hi = min(r1, prev_pre[0]), max(r1, prev_pre[0])
                    lcp = g.lcp_array[lcp_rmq.range_arg_min(lo, hi)]
                lcp_array.append(lcp)
            prev_pre = (rank[idxs[i]], join_rank[idxs[i]])
            shared_from = True
            for k in range(i, j):
                rank[idxs[k]] = next_rank
                join_rank[idxs[k]] = 0
                shared_from = shared_from and from_[idxs[k]] == from_[idxs[i]]
            next_rank += 1
            if shared_from:
                for k in range(i + 1, j):
                    remove[idxs[k]] = True
            i = j

        self.from_ = [f for f, r in zip(from_, remove) if not r]
        self.to = [t for t, r in zip(to, remove) if not r]
        self.rank = [k for k, r in zip(rank, remove) if not r]
        self.join_rank = [0] * len(self.from_)
        self.lcp_array = lcp_array

    # -- finishing (reference path_graph.hpp finish())

    def order_by_rank(self):
        for i in range(len(self.from_)):
            while self.rank[i] != i:
                r = self.rank[i]
                for arr in (self.from_, self.to, self.rank, self.join_rank):
                    arr[r], arr[i] = arr[i], arr[r]

    def merge_overexpanded_nodes(self):
        """(src/path_graph.cpp:409-560): merge LCP subtrees whose leaves all
        share one from() value."""
        from_ = self.from_
        lcp = self.lcp_array
        to_merge = []

        # frames: [lcp, lb, rb, children, all_equal, from_value]
        NULLF = None
        stack = [[0, 0, 0, [], True, -1]]
        last_frame = NULLF

        def process(frame):
            if not frame[4]:
                return
            if frame[5] == -1:
                frame[5] = from_[frame[1]]
            children = frame[3]
            for i in range(len(children) + 1):
                begin = frame[1] if i == 0 else children[i - 1][1] + 1
                end = frame[2] + 1 if i == len(children) else children[i][0]
                for jj in range(begin, end):
                    frame[4] = frame[4] and from_[jj] == frame[5]
            if frame[4]:
                while (to_merge and frame[1] <= to_merge[-1][0]
                       and frame[2] >= to_merge[-1][1]):
                    to_merge.pop()
                to_merge.append((frame[1], frame[2]))

        def communicate(frame, parent):
            if parent[5] == -1:
                parent[5] = frame[5]
            parent[4] = parent[4] and frame[4] and frame[5] == parent[5]
            parent[3].append((frame[1], frame[2]))

        for i in range(len(lcp)):
            lb = i
            while stack[-1][0] > lcp[i]:
                stack[-1][2] = i
                last_frame = stack.pop()
                process(last_frame)
                lb = last_frame[1]
                if stack[-1][0] >= lcp[i]:
                    communicate(last_frame, stack[-1])
                    last_frame = NULLF
            if stack[-1][0] < lcp[i]:
                stack.append([lcp[i], lb, -1, [], True, -1])
                if last_frame is not NULLF:
                    communicate(last_frame, stack[-1])
                    last_frame = NULLF
        while stack:
            stack[-1][2] = len(lcp)
            last_frame = stack.pop()
            process(last_frame)
            if stack:
                communicate(last_frame, stack[-1])

        if not to_merge:
            return
        removed = 0
        for i in range(len(to_merge)):
            removed += to_merge[i][1] - to_merge[i][0]
            begin = to_merge[i][1]
            end = (len(self.from_) if i + 1 == len(to_merge)
                   else to_merge[i + 1][0])
            for j in range(begin, end):
                self.from_[j - removed] = self.from_[j]
                self.to[j - removed] = self.to[j]
                self.rank[j - removed] = self.rank[j]
                if j < len(self.lcp_array):
                    self.lcp_array[j - removed] = self.lcp_array[j]
        del self.from_[len(self.from_) - removed:]
        del self.to[len(self.to) - removed:]
        del self.rank[len(self.rank) - removed:]
        del self.lcp_array[len(self.lcp_array) - removed:]

    def construct_edges(self, graph):
        """(path_graph.hpp construct_edges)"""
        n = self.node_size()
        pre_edges = []
        for node_id in range(n):
            for parent_prev in graph.previous(self.from_[node_id]):
                pre_edges.append((int(parent_prev), node_id))
        idxs = _stable_sort_by(list(range(len(pre_edges))),
                               [self.rank[e[1]] for e in pre_edges])
        idxs = _stable_sort_by(idxs, {k: int(graph.label(pre_edges[k][0]))
                                      for k in range(len(pre_edges))})

        self.edges_next = [[] for _ in range(n)]
        self.edges_prev = [[] for _ in range(n)]
        unresolved = []
        node_id = 0
        i = 0
        while node_id < n:
            node_id_end = node_id + 1
            while (node_id_end < n
                   and self.from_[node_id_end] == self.from_[node_id]):
                node_id_end += 1
            j = i
            while (j < len(idxs)
                   and pre_edges[idxs[j]][0] == self.from_[node_id]):
                j += 1
            if node_id_end == node_id + 1 or i == j:
                for k in range(i, j):
                    next_id = pre_edges[idxs[k]][1]
                    self.edges_next[node_id].append(next_id)
                    self.edges_prev[next_id].append(node_id)
                i = j
            elif node_id_end - node_id == j - i:
                while node_id != node_id_end:
                    next_id = pre_edges[idxs[i]][1]
                    self.edges_next[node_id].append(next_id)
                    self.edges_prev[next_id].append(node_id)
                    node_id += 1
                    i += 1
                node_id -= 1  # outer loop advances to node_id_end anyway
            else:
                unresolved.append((node_id, node_id_end, i, j))
                i = j
            node_id = node_id_end

        if unresolved:
            self._resolve_intervals(graph, pre_edges, idxs, unresolved)

    def _resolve_intervals(self, graph, pre_edges, idxs, unresolved):
        from .graph_algs import topological_order
        skip_edges = [[] for _ in range(self.node_size())]

        def get_skip(node_id, power):
            se = skip_edges[node_id]
            if power < len(se):
                return se[power]
            if power == 0:
                se.append(self.edges_next[node_id][0])
                return se[0]
            while len(se) < power:
                get_skip(node_id, len(se))
            nxt = se[power - 1]
            se.append(get_skip(nxt, power - 1))
            return se[-1]

        def skip_walk(node_id, length):
            here = node_id
            p = 0
            steps = []
            while (1 << p) <= length:
                if length & (1 << p):
                    steps.append(p)
                p += 1
            for power in reversed(steps):
                here = get_skip(here, power)
            return here

        top_index = {}
        order = topological_order(graph)
        for pos, v in enumerate(order):
            top_index[int(v)] = pos
        queue = [[] for _ in range(graph.node_size)]
        for k, (nb, ne, ib, ie) in enumerate(unresolved):
            max_idx = 0
            for node_id in range(nb, ne):
                max_idx = max(max_idx, top_index[self.from_[node_id]])
            queue[max_idx].append(k)
        for bucket in reversed(queue):
            for k in bucket:
                nb, ne, ib, ie = unresolved[k]
                curr = nb
                for i in range(ib, ie):
                    tail = pre_edges[idxs[i]][1]
                    if ie - i < ne - curr:
                        curr += 1
                    elif i != ib and curr + 1 != ne:
                        walk_len = self.lcp_array[curr] - 1
                        prev_walked = skip_walk(pre_edges[idxs[i - 1]][1],
                                                walk_len)
                        curr_walked = skip_walk(tail, walk_len)
                        if (graph.label(self.from_[prev_walked])
                                != graph.label(self.from_[curr_walked])):
                            curr += 1
                    self.edges_next[curr].append(tail)
                    self.edges_prev[tail].append(curr)
                assert curr + 1 == ne


# ---------------------------------------------------------------------------
# ESA machinery over an LCP array (reference esa.hpp / src/esa.cpp)


class ESACore:
    """Shared LCP-interval-tree machinery: child array, children, depths,
    suffix links, color-set-size counts, minimal-rare-match enumeration."""

    # populated by subclasses: lcp_array (list, leading 0), leaf_to_comp,
    # component_ranked_ids, nearest_comp_rank

    def root(self):
        return (0, len(self.lcp_array) - 1)

    @staticmethod
    def is_leaf(node):
        return node[0] == node[1]

    def child_array_is_down(self, i):
        ca, lcp = self.child_array, self.lcp_array
        return i < len(ca) and ca[i] is not None and ca[i] > i \
            and lcp[ca[i]] != lcp[i]

    def child_array_is_l_index(self, i):
        ca, lcp = self.child_array, self.lcp_array
        return i < len(ca) and ca[i] is not None and ca[i] > i \
            and lcp[ca[i]] == lcp[i]

    def first_l_index(self, node):
        ca = self.child_array
        if node == self.root():
            return ca[0]
        if self.child_array_is_down(node[0]) and ca[node[0]] <= node[1]:
            return ca[node[0]]
        return ca[node[1]]

    def st_node_annotation_idx(self, node):
        if self.is_leaf(node):
            return (1, node[0])
        return (0, self.first_l_index(node))

    def depth(self, node):
        lcp = self.lcp_array
        if self.is_leaf(node):
            length = lcp[node[0]]
            if node[0] + 1 < len(lcp):
                length = max(length, lcp[node[0] + 1])
            return length + 1
        return lcp[self.first_l_index(node)]

    def children(self, parent):
        out = []
        if not self.is_leaf(parent):
            nli = self.first_l_index(parent)
            out.append((parent[0], nli - 1))
            while self.child_array_is_l_index(nli):
                curr = nli
                nli = self.child_array[nli]
                out.append((curr, nli - 1))
            out.append((nli, parent[1]))
        return out

    def link(self, node):
        _i, j = self.st_node_annotation_idx(node)
        return self.suffix_links[j]

    def construct_child_array(self):
        """(src/esa.cpp:33-148)"""
        lcp = self.lcp_array
        n = len(lcp)
        ca = [None] * (n - 1)
        stack = [0]
        for i in range(1, n):
            while lcp[stack[-1]] > lcp[i]:
                stack.pop()
            if lcp[i] == lcp[stack[-1]]:
                ca[stack[-1]] = i
                stack.pop()
            stack.append(i)
        stack = [0]
        for i in range(1, n):
            last_idx = None
            while lcp[stack[-1]] > lcp[i]:
                last_idx = stack[-1]
                stack.pop()
                if (ca[stack[-1]] is None and lcp[i] <= lcp[stack[-1]]
                        and lcp[last_idx] != lcp[stack[-1]]):
                    ca[stack[-1]] = last_idx
            if last_idx is not None:
                ca[i - 1] = last_idx
            stack.append(i)
        while lcp[stack[-1]] > 0:
            last_idx = stack[-1]
            stack.pop()
            if (ca[stack[-1]] is None
                    and lcp[last_idx] != lcp[stack[-1]]):
                ca[stack[-1]] = last_idx
        self.child_array = ca

    def construct_suffix_links(self, advancer):
        """(esa.hpp:497-611)"""
        lcp = self.lcp_array
        n = len(lcp)
        l_interval_lists = []

        def note(l, b, e):
            while len(l_interval_lists) <= l:
                l_interval_lists.append([])
            l_interval_lists[l].append((b, e))

        stack = [(0, 0)]
        for i in range(1, n):
            left = i - 1
            while stack[-1][0] > lcp[i]:
                top = stack[-1]
                note(top[0], top[1], i - 1)
                left = top[1]
                stack.pop()
            if lcp[i] > stack[-1][0]:
                stack.append((lcp[i], left))
        while stack:
            top = stack.pop()
            note(top[0], top[1], n - 1)

        self.suffix_links = [None] * n
        for l in range(1, len(l_interval_lists)):
            link_list = l_interval_lists[l - 1]
            for node in l_interval_lists[l]:
                _i, j = self.st_node_annotation_idx(node)
                next_rank = advancer(node[0])
                if next_rank is None or next_rank == NULL_ID:
                    self.suffix_links[j] = self.root()
                else:
                    lo, hi = 0, len(link_list) - 1
                    while lo != hi:
                        mid = (lo + hi) // 2
                        if next_rank < link_list[mid][0]:
                            hi = mid - 1
                        elif next_rank > link_list[mid][1]:
                            lo = mid + 1
                        else:
                            lo = hi = mid
                    self.suffix_links[j] = link_list[lo]

    def _lcp_tree_bottom_up(self, visit):
        """Bottom-up LCP-interval traversal; visit(node, children,
        child_flags) -> flag propagated to the parent's child_flags."""
        lcp = self.lcp_array
        n = len(lcp)
        stack = [[0, 0, [], []]]
        for i in range(1, n):
            last_node = None
            last_flag = False
            left = i - 1
            while stack[-1][0] > lcp[i]:
                top = stack[-1]
                last_node = (top[1], i - 1)
                last_flag = visit(last_node, top[2], top[3])
                left = top[1]
                stack.pop()
                if stack[-1][0] >= lcp[i]:
                    stack[-1][2].append(last_node)
                    stack[-1][3].append(last_flag)
                    last_node = None
                    last_flag = False
            if stack[-1][0] < lcp[i]:
                stack.append([lcp[i], left, [], []])
                if last_node is not None:
                    stack[-1][2].append(last_node)
                    stack[-1][3].append(last_flag)
        while stack:
            top = stack.pop()
            node = (top[1], n - 1)
            flag = visit(node, top[2], top[3])
            if stack:
                stack[-1][2].append(node)
                stack[-1][3].append(flag)

    def index_color_set_size(self):
        """Hui's color-set-size counts per internal node (src/esa.cpp:149)."""
        ncomp = len(self.component_ranked_ids)
        n = len(self.lcp_array)
        repeat = [[0] * n for _ in range(ncomp)]

        euler_nodes = []
        euler_depth = []
        position = [0] * n
        stack = [(self.root(), self.children(self.root()), [0], 0)]
        while stack:
            node, kids, idx, d = stack[-1]
            if self.is_leaf(node):
                position[node[0]] = len(euler_nodes)
            euler_depth.append(d)
            euler_nodes.append(node)
            if idx[0] == len(kids):
                stack.pop()
            else:
                nxt = kids[idx[0]]
                idx[0] += 1
                stack.append((nxt, self.children(nxt), [0], d + 1))
        lca_rmq = RMQ(np.asarray(euler_depth, dtype=_I64))

        prev_occ = [{} for _ in range(ncomp)]
        for l in range(n):
            c = self.leaf_to_comp[l]
            ranked = self.component_ranked_ids[c]
            nid = ranked[self.nearest_comp_rank[c][l]]
            if nid in prev_occ[c]:
                l_prev = prev_occ[c][nid]
                pos, pos_prev = position[l], position[l_prev]
                lo, hi = min(pos, pos_prev), max(pos, pos_prev)
                lca = euler_nodes[lca_rmq.range_arg_min(lo, hi + 1)]
                repeat[c][self.st_node_annotation_idx(lca)[1]] += 1
            prev_occ[c][nid] = l

        def add_child_dups(node, children, _flags):
            j = self.st_node_annotation_idx(node)[1]
            for child in children:
                if self.is_leaf(child):
                    continue
                jc = self.st_node_annotation_idx(child)[1]
                for c in range(ncomp):
                    repeat[c][j] += repeat[c][jc]
            return False

        self._lcp_tree_bottom_up(add_child_dups)

        def convert(node, _children, _flags):
            j = self.st_node_annotation_idx(node)[1]
            for c in range(ncomp):
                total = (self.nearest_comp_rank[c][node[1] + 1]
                         - self.nearest_comp_rank[c][node[0]])
                repeat[c][j] = total - repeat[c][j]
            return False

        self._lcp_tree_bottom_up(convert)
        return repeat

    def minimal_rare_matches_internal(self, max_count, label_getter,
                                      use_css=True):
        """(esa.hpp:196-491)"""
        ncomp = len(self.component_ranked_ids)
        if use_css:
            css = self.index_color_set_size()

            def query_count(node, comp):
                if self.is_leaf(node):
                    return 1 if comp == self.leaf_to_comp[node[0]] else 0
                return css[comp][self.st_node_annotation_idx(node)[1]]
        else:
            ruqs = [RUQ(np.asarray(ids, dtype=_I64))
                    for ids in self.component_ranked_ids]

            def query_count(node, comp):
                return ruqs[comp].range_unique(
                    self.nearest_comp_rank[comp][node[0]],
                    self.nearest_comp_rank[comp][node[1] + 1])

        matches = []

        def add_matches(parent, children, too_frequent):
            any_too_freq = False
            unique_length = self.depth(parent) + 1
            if unique_length == 1:
                for i, child in enumerate(children):
                    if too_frequent[i]:
                        any_too_freq = True
                        continue
                    counts = [0] * ncomp
                    for c in range(ncomp):
                        cnt = query_count(child, c)
                        if cnt == 0:
                            break
                        counts[c] = cnt
                    total = 1
                    for c in counts:
                        total *= c
                    if 0 < total <= max_count:
                        matches.append((child, unique_length, counts))
                    else:
                        any_too_freq = True
                return any_too_freq

            suf_link = self.link(parent)
            link_children = self.children(suf_link)
            i = j = 0
            while i < len(children) and j < len(link_children):
                if (label_getter(parent, children[i])
                        == label_getter(suf_link, link_children[j])):
                    link_children[i] = link_children[j]
                    i += 1
                j += 1
            link_children = link_children[:len(children)]

            parent_counts = [query_count(parent, c) for c in range(ncomp)]
            for k, child in enumerate(children):
                if too_frequent[k]:
                    any_too_freq = True
                    continue
                link_child = link_children[k]
                counts = [0] * ncomp
                link_more = False
                parent_more = False
                for c in range(ncomp):
                    cnt = query_count(child, c)
                    if cnt == 0:
                        break
                    counts[c] = cnt
                    link_cnt = query_count(link_child, c)
                    link_more = link_more or cnt < link_cnt
                    parent_more = parent_more or cnt < parent_counts[c]
                total = 1
                for c in counts:
                    total *= c
                if 0 < total <= max_count and link_more and parent_more:
                    matches.append((child, unique_length, counts))
                elif total > max_count:
                    any_too_freq = True
            return any_too_freq

        self._lcp_tree_bottom_up(add_matches)
        return matches

    def walk_matches_internal(self, node, length, advancer):
        """(esa.hpp:613-665)"""
        matches = []
        starts = set()
        for i in range(node[0], node[1] + 1):
            idx = i
            comp = self.leaf_to_comp[idx]
            ranked = self.component_ranked_ids[comp]
            nearest = self.nearest_comp_rank[comp]
            node_id = ranked[nearest[idx]]
            if (comp, node_id) in starts:
                continue
            starts.add((comp, node_id))
            walk = [node_id]
            for _ in range(1, length):
                idx = advancer(idx)
                walk.append(ranked[nearest[idx]])
            matches.append((comp, walk))
        return matches


# ---------------------------------------------------------------------------


class GESA(ESACore):
    """(reference gesa.hpp:24; see module docstring)"""

    def __init__(self, graphs, back_translations=None, size_limit=None):
        from .graph import BaseGraph
        if not isinstance(graphs, (list, tuple)):
            graphs = [graphs]
        if back_translations is None:
            back_translations = [None] * len(graphs)

        component_ranges = [0]
        joined = BaseGraph()
        for g in graphs:
            base = joined.node_size
            joined.add_nodes(g.labels)
            ef, et = g.edges()
            if len(ef):
                joined.add_edges(np.asarray(ef) + base,
                                 np.asarray(et) + base)
            component_ranges.append(joined.node_size)
        node_to_comp = np.zeros(joined.node_size, dtype=_I64)
        for ci in range(len(graphs)):
            node_to_comp[component_ranges[ci]:component_ranges[ci + 1]] = ci

        path_graph = PathGraph(joined)
        while not path_graph.is_prefix_sorted():
            try:
                path_graph = PathGraph(path_graph, size_limit)
            except PathGraphSizeException as ex:
                raise GESASizeException(ex, node_to_comp, component_ranges)
        path_graph.order_by_rank()
        path_graph.merge_overexpanded_nodes()
        path_graph.construct_edges(joined)

        ncomp = len(graphs)
        self.component_ranked_ids = [[] for _ in range(ncomp)]
        self.nearest_comp_rank = [[] for _ in range(ncomp)]
        self.leaf_to_comp = [0] * path_graph.node_size()
        for pid in range(path_graph.node_size()):
            for c in range(ncomp):
                self.nearest_comp_rank[c].append(
                    len(self.component_ranked_ids[c]))
            node_id = path_graph.from_[pid]
            comp = int(node_to_comp[node_id])
            self.leaf_to_comp[pid] = comp
            orig = node_id - component_ranges[comp]
            if back_translations[comp] is not None:
                orig = int(back_translations[comp][orig])
            self.component_ranked_ids[comp].append(orig)
        for c in range(ncomp):
            self.nearest_comp_rank[c].append(
                len(self.component_ranked_ids[c]))

        self.lcp_array = [0] + list(path_graph.lcp_array)
        self.edges = list(path_graph.edges_next)
        self.construct_child_array()
        self.construct_suffix_links(self._advance)
        self._label_edges(path_graph.doubling_step, joined, path_graph)

    def _advance(self, node):
        e = self.edges[node]
        return e[0] if e else None

    def _label_edges(self, doubling_steps, joined, path_graph):
        """(src/gesa.cpp:70-205)"""
        n = len(self.lcp_array)
        skip_edges = [[] for _ in range(n)]
        for i in range(n):
            if self.edges[i]:
                skip_edges[i].append(self.edges[i][0])
        for step in range(doubling_steps):
            for i in range(n):
                se = skip_edges[i]
                if len(se) > step:
                    prefix_len = self.lcp_array[i]
                    if i + 1 < n:
                        prefix_len = max(prefix_len, self.lcp_array[i + 1])
                    if (1 << step) > prefix_len:
                        continue
                    nxt = se[step]
                    if len(skip_edges[nxt]) > step:
                        se.append(skip_edges[nxt][step])

        self.edge_label = [[None] * n, [None] * n]

        def add_child_labels(parent):
            branch_depth = self.depth(parent)
            step_sizes = [p for p in range(branch_depth.bit_length())
                          if branch_depth & (1 << p)]
            for child in self.children(parent):
                here = child[0]
                for power in reversed(step_sizes):
                    se = skip_edges[here]
                    if power < len(se):
                        here = se[power]
                    else:
                        # defensive fallback (inputs that are not reverse
                        # deterministic can leave a skip list short):
                        # resolve the skip one edge at a time
                        for _ in range(1 << power):
                            here = self.edges[here][0]
                i, j = self.st_node_annotation_idx(child)
                self.edge_label[i][j] = int(
                    joined.label(path_graph.from_[here]))

        lcp = self.lcp_array
        stack = [(0, 0)]
        for i in range(1, n):
            left = i - 1
            while stack[-1][0] > lcp[i]:
                top = stack[-1]
                add_child_labels((top[1], i - 1))
                left = top[1]
                stack.pop()
            if lcp[i] > stack[-1][0]:
                stack.append((lcp[i], left))
        while stack:
            top = stack.pop()
            add_child_labels((top[1], n - 1))

    def label(self, node):
        i, j = self.st_node_annotation_idx(node)
        return self.edge_label[i][j]

    def minimal_rare_matches(self, max_count, use_css=True):
        return self.minimal_rare_matches_internal(
            max_count, lambda parent, child: self.label(child),
            use_css=use_css)

    def walk_matches(self, node, length):
        return self.walk_matches_internal(
            node, length, lambda i: self.edges[i][0])

"""Project self-matches from a full cyclized graph onto realignment
subproblems.

Behavioral equivalent of the reference's induced_match_finder.{hpp,cpp}:
the InducedMatchFinder localizes each walk of the global self-match sets to
path offsets inside the flagged inconsistency components, and the per-
component view synthesizes match sets for a realignment subproblem by
sweeping the localized intervals (the reference's heap-ordered interval sweep
is replicated exactly, including the libstdc++ heap layout that determines
the walk order inside each emitted match set).

Copy of centrolign_tpu/induced_match_finder.py."""

from __future__ import annotations

from bisect import bisect_left, bisect_right

import numpy as np

from .match_finder import MatchSet
from .utils.cpp_heap import pop_heap_range, push_heap

_I64 = np.int64


class _PathHitSet:
    """(reference induced_match_finder.hpp:38-53)"""

    __slots__ = ("hit_locations", "length", "deduplicated_count")

    def __init__(self):
        self.hit_locations = {}  # path id -> [(offset, origin walk index)]
        self.length = 0
        self.deduplicated_count = 0


class InducedMatchFinder:
    """(reference src/induced_match_finder.cpp:12-131)"""

    def __init__(self, full_graph, matches, components, step_index):
        self.parent = full_graph
        self.component_path_hits = [[] for _ in components]

        # label nodes by component with DFS between the boundary pairs
        node_to_component = np.full(full_graph.node_size, -1, dtype=_I64)
        for i, (a, b) in enumerate(components):
            stack = [a]
            node_to_component[a] = i
            node_to_component[b] = i
            while stack:
                node_id = stack.pop()
                for next_id in full_graph.next(node_id):
                    if node_to_component[next_id] == -1:
                        node_to_component[next_id] = i
                        stack.append(int(next_id))

        for match_set in matches:
            component_hits_initialized = set()
            for j in range(len(match_set.walks1)):
                walk = match_set.walks1[j]
                overlapping = set(
                    int(c) for c in node_to_component[walk] if c != -1)
                if not overlapping:
                    continue
                for comp in overlapping:
                    if comp not in component_hits_initialized:
                        component_hits_initialized.add(comp)
                        hit_set = _PathHitSet()
                        hit_set.length = len(walk)
                        hit_set.deduplicated_count = len(match_set.walks1)
                        self.component_path_hits[comp].append(hit_set)

                # find paths that contain this walk as a complete subpath
                extensions = set(step_index.path_steps(int(walk[0])))
                for k in range(1, len(walk)):
                    if not extensions:
                        break
                    nxt = set()
                    for step in step_index.path_steps(int(walk[k])):
                        if (step[0], step[1] - 1) in extensions:
                            nxt.add(step)
                    extensions = nxt

                for path_id, end_step in extensions:
                    for comp in overlapping:
                        self.component_path_hits[comp][-1].hit_locations \
                            .setdefault(path_id, []) \
                            .append((end_step + 1 - len(walk), j))

            for comp in component_hits_initialized:
                hit_set = self.component_path_hits[comp][-1]
                locs = hit_set.hit_locations
                if not locs or (len(locs) == 1
                                and len(next(iter(locs.values()))) == 1):
                    # can never match across two subpaths / paths
                    self.component_path_hits[comp].pop()
                else:
                    for v in locs.values():
                        v.sort()

    def component_view(self, comp):
        return InducedMatchFinderComponentView(
            self.parent, self.component_path_hits[comp])


def _parse_subpath_name(subpath_name):
    """'name:begin-end' -> (name, begin, end) (reference
    induced_match_finder.cpp:139-146; split on the LAST ':')."""
    sep = subpath_name.rfind(":")
    rng = subpath_name[sep + 1:]
    dash = rng.index("-")
    return subpath_name[:sep], int(rng[:dash]), int(rng[dash + 1:])


class InducedMatchFinderComponentView:
    """(reference induced_match_finder.hpp:62-344)"""

    def __init__(self, parent, path_hits):
        self.parent = parent
        self.path_hits = path_hits

    def find_matches(self, graph1, graph2, tableau1, tableau2):
        parent = self.parent
        parent_path_seen = set()
        parent_path_length = [0, 0]
        path_trans = [[], []]
        for gi, graph in enumerate((graph1, graph2)):
            for path_id in range(graph.path_size):
                name, begin, end = _parse_subpath_name(
                    graph.path_name(path_id))
                parent_path_id = parent.path_id(name)
                path_trans[gi].append((parent_path_id, begin, end))
                if parent_path_id not in parent_path_seen:
                    parent_path_seen.add(parent_path_id)
                    parent_path_length[gi] += len(parent.path(parent_path_id))

        approx_count_ratio = parent_path_length[0] / parent_path_length[1]

        def assign_count(observed1, observed2, target_count):
            import math

            def cround(x):  # C++ round(): half away from zero
                return math.floor(x + 0.5)

            count2 = cround(math.sqrt(target_count / approx_count_ratio))
            count1 = cround(math.sqrt(target_count * approx_count_ratio))
            if count1 >= observed1 and count2 < observed2:
                count2 = observed2
                count1 = cround(target_count / count2)
            elif count2 >= observed2 and count1 < observed1:
                count1 = observed1
                count2 = cround(target_count / count1)
            return max(count1, observed1), max(count2, observed2)

        matches = []

        for hit_set in self.path_hits:
            origin_walks_used = set()
            # (match begin, match end, on graph1, path id, path offset)
            intervals = []
            observed = [0, 0]
            for gi, graph in enumerate((graph1, graph2)):
                initial_nodes = set()
                for path_id in range(graph.path_size):
                    parent_path_id, path_begin, path_end = \
                        path_trans[gi][path_id]
                    locs = hit_set.hit_locations.get(parent_path_id)
                    if locs is None:
                        continue
                    lo = (path_begin - hit_set.length
                          if path_begin >= hit_set.length else 0)
                    loc_begin = bisect_left(locs, (lo, 0))
                    loc_end = bisect_right(locs, (path_end + 1, 0))
                    for li in range(loc_begin, loc_end):
                        match_begin, origin = locs[li]
                        match_end = match_begin + hit_set.length
                        origin_walks_used.add(origin)
                        begin = (path_begin - match_begin
                                 if match_begin < path_begin else 0)
                        end = (path_end - match_begin
                               if match_end > path_end else hit_set.length)
                        path_offset = (0 if match_begin < path_begin
                                       else match_begin - path_begin)
                        node_id = int(graph.path(path_id)[path_offset])
                        if (node_id, begin) not in initial_nodes:
                            initial_nodes.add((node_id, begin))
                            intervals.append((begin, end, gi == 0,
                                              path_id, path_offset))
                        observed[gi] += 1

            total_count = (observed[0] * observed[1]
                           + hit_set.deduplicated_count
                           - len(origin_walks_used))
            count1, count2 = assign_count(observed[0], observed[1],
                                          total_count)

            intervals.sort()

            # heap over active intervals ordered by interval end; walks are
            # emitted in raw heap layout order, so the libstdc++ heap is
            # replicated exactly (induced_match_finder.hpp:236-344)
            active = []

            def less(i, j):
                return intervals[i][1] > intervals[j][1]

            last = 0
            i = 0
            num_active1 = num_active2 = 0
            while i < len(intervals) or active:
                if not active or (i < len(intervals)
                                  and intervals[i][0]
                                  < intervals[active[0]][1]):
                    next_is_start = True
                    nxt = intervals[i][0]
                else:
                    next_is_start = False
                    nxt = intervals[active[0]][1]

                if num_active1 and num_active2 and nxt != last:
                    walks1, walks2 = [], []
                    for idx in active:
                        begin0, _end0, on1, path_id, path_offset = \
                            intervals[idx]
                        graph = graph1 if on1 else graph2
                        path = graph.path(path_id)
                        b = path_offset + (last - begin0)
                        walk = path[b:b + (nxt - last)]
                        (walks1 if on1 else walks2).append(walk)
                    matches.append(MatchSet(
                        walks1=np.array(walks1, dtype=_I64),
                        walks2=np.array(walks2, dtype=_I64),
                        count1=count1, count2=count2,
                        full_length=hit_set.length))

                last = nxt

                if next_is_start:
                    j = i + 1
                    while (j < len(intervals)
                           and intervals[j][0] == intervals[i][0]):
                        j += 1
                    for k in range(i, j):
                        active.append(k)
                        if intervals[k][2]:
                            num_active1 += 1
                        else:
                            num_active2 += 1
                        push_heap(active, less)
                    i = j
                else:
                    heap_end = len(active)
                    pop_heap_range(active, heap_end, less)
                    heap_end -= 1
                    while (heap_end > 0
                           and intervals[active[0]][1]
                           == intervals[active[-1]][1]):
                        pop_heap_range(active, heap_end, less)
                        heap_end -= 1
                    for idx in active[heap_end:]:
                        if intervals[idx][2]:
                            num_active1 -= 1
                        else:
                            num_active2 -= 1
                    del active[heap_end:]

        return matches

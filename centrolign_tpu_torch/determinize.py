"""Reverse determinization by subset construction (reference
determinize.hpp:22-185, src/determinize.cpp): build an equivalent graph in
which no node has two predecessors with the same label, so paths can be
re-walked backward deterministically (rewalk_paths) and prefix doubling
converges.

Copy of centrolign_tpu/determinize.py over the port's graph, modify_graph
and graph_algs.
"""

from __future__ import annotations

import numpy as np

from .graph import BaseGraph
from .modify_graph import SentinelTableau
from .graph_algs import topological_order


def determinize(graph) -> BaseGraph:
    """(determinize.hpp:38-140)"""
    order = topological_order(graph)
    top_index = np.empty(graph.node_size, dtype=np.int64)
    top_index[order] = np.arange(graph.node_size)

    # queue[i]: {node_set (sorted tuple) -> [successor new-graph ids]}
    queue = [dict() for _ in range(graph.node_size)]
    for node_id in range(graph.node_size):
        if graph.next_size(node_id) == 0:
            queue[int(top_index[node_id])][(node_id,)] = []

    out = BaseGraph()
    for i in range(len(queue) - 1, -1, -1):
        # std::map iterates keys in sorted order; match it
        for node_set in sorted(queue[i]):
            successors = queue[i][node_set]
            new_node = out.add_node(graph.label(node_set[0]))
            for succ in successors:
                out.add_edge(new_node, succ)
            predecessors = {}
            for node_id in node_set:
                for prev_id in graph.previous(node_id):
                    predecessors.setdefault(
                        int(graph.label(prev_id)), []).append(int(prev_id))
            for label in sorted(predecessors):
                group = tuple(sorted(set(predecessors[label])))
                max_index = max(int(top_index[n]) for n in group)
                queue[max_index].setdefault(group, []).append(new_node)
        queue[i] = None
    return out


def translate_tableau(determinized, original_tableau) -> SentinelTableau:
    """(src/determinize.cpp:8-30)"""
    src_id = snk_id = -1
    for node_id in range(determinized.node_size):
        if determinized.label(node_id) == original_tableau.src_sentinel:
            src_id = node_id
        if determinized.label(node_id) == original_tableau.snk_sentinel:
            snk_id = node_id
    return SentinelTableau(
        src_id=src_id, snk_id=snk_id,
        src_sentinel=original_tableau.src_sentinel,
        snk_sentinel=original_tableau.snk_sentinel)


def rewalk_paths(determinized, tableau, graph) -> None:
    """(determinize.hpp:142-185): walk each original path backward from the
    sink through the reverse-deterministic graph."""
    for path_id in range(graph.path_size):
        translated = []
        here = tableau.snk_id
        path = graph.path(path_id)
        for step_id in path[::-1]:
            base = graph.label(int(step_id))
            for prev_id in determinized.previous(here):
                if determinized.label(int(prev_id)) == base:
                    translated.append(int(prev_id))
                    here = int(prev_id)
                    break
        new_pid = determinized.add_path(graph.path_name(path_id))
        for node_id in translated[::-1]:
            determinized.extend_path(new_pid, node_id)

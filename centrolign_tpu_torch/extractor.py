"""Subgraph extraction between anchors (reference subgraph_extraction.hpp and
the Extractor base, anchorer.hpp:62-121, 400-660).

extract_connecting_graph reproduces the reference's DFS exactly — node ids in
the extraction are assigned in first-encounter order of a LIFO stack walk
following adjacency order, because downstream alignment traceback tie-breaks
depend on adjacency ordering.

Copy of centrolign_tpu/extractor.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .graph import BaseGraph
from .graph_algs import minmax_distance, reference_topological_order

_I64 = np.int64


@dataclass
class SubGraphInfo:
    subgraph: BaseGraph = field(default_factory=BaseGraph)
    back_translation: list = field(default_factory=list)
    sources: list = field(default_factory=list)
    sinks: list = field(default_factory=list)


def extract_connecting_graph(graph, from_id: int, to_id: int, xmerge) -> SubGraphInfo:
    """Subgraph strictly between from_id and to_id (exclusive), restricted to
    nodes that can reach to_id (reference subgraph_extraction.hpp:35-118).
    Dispatches to the native DFS; the Python body below is the oracle."""
    from .native import ExtractionContext
    ctx = getattr(xmerge, "_extract_ctx", None)
    if ctx is None or ctx.V != graph.node_size:
        ctx = ExtractionContext(graph, xmerge)
        xmerge._extract_ctx = ctx
    labels, back, ef, et, src, snk = ctx.extract(from_id, to_id)
    info = SubGraphInfo()
    info.subgraph.add_nodes(labels)
    if len(ef):
        info.subgraph.add_edges(ef, et)
    info.back_translation = back
    info.sources = src.tolist()
    info.sinks = snk.tolist()
    return info


def extract_connecting_graph_py(graph, from_id: int, to_id: int, xmerge) -> SubGraphInfo:
    """Pure-Python oracle for extract_connecting_graph."""
    info = SubGraphInfo()
    fwd: dict[int, int] = {}
    next_ptr, next_ind = graph.next_csr()
    table = xmerge.table
    path_head = xmerge.path_head
    index_on = xmerge.index_on

    def reachable(a, b):
        cf = path_head[a]
        if cf == -1:
            return False
        last = table[b, cf]
        return last != -1 and index_on[cf, a] <= last

    stack = [from_id]
    ef, et = [], []
    while stack:
        node_id = stack.pop()
        for next_id in next_ind[next_ptr[node_id]:next_ptr[node_id + 1]]:
            next_id = int(next_id)
            if next_id == to_id and node_id != from_id:
                info.sinks.append(fwd[node_id])
                continue
            if not reachable(next_id, to_id):
                continue
            sub_id = fwd.get(next_id)
            if sub_id is None:
                sub_id = info.subgraph.add_node(graph.label(next_id))
                fwd[next_id] = sub_id
                info.back_translation.append(next_id)
                stack.append(next_id)
            if node_id != from_id:
                ef.append(fwd[node_id])
                et.append(sub_id)
            else:
                info.sources.append(sub_id)
    if ef:
        info.subgraph.add_edges(np.array(ef, dtype=_I64), np.array(et, dtype=_I64))
    return info


def extract_extending_graph(graph, from_id: int, forward: bool) -> SubGraphInfo:
    """Everything reachable from from_id in one direction, excluding it
    (reference subgraph_extraction.hpp:42, 124-183)."""
    info = SubGraphInfo()
    fwd: dict[int, int] = {}
    if forward:
        indptr, ind = graph.next_csr()
    else:
        indptr, ind = graph.prev_csr()
    stack = [from_id]
    ef, et = [], []
    while stack:
        node_id = stack.pop()
        for next_id in ind[indptr[node_id]:indptr[node_id + 1]]:
            next_id = int(next_id)
            sub_id = fwd.get(next_id)
            if sub_id is None:
                sub_id = info.subgraph.add_node(graph.label(next_id))
                fwd[next_id] = sub_id
                info.back_translation.append(next_id)
                stack.append(next_id)
            if node_id != from_id:
                if forward:
                    ef.append(fwd[node_id])
                    et.append(sub_id)
                else:
                    ef.append(sub_id)
                    et.append(fwd[node_id])
            else:
                (info.sources if forward else info.sinks).append(sub_id)
    if ef:
        info.subgraph.add_edges(np.array(ef, dtype=_I64), np.array(et, dtype=_I64))
    return info


def do_extraction(from1, to1, from2, to2, graph1, graph2, xmerge1, xmerge2):
    return (extract_connecting_graph(graph1, from1, to1, xmerge1),
            extract_connecting_graph(graph2, from2, to2, xmerge2))


def extract_graphs_between(anchor_chain, graph1, graph2, tableau1, tableau2,
                           xmerge1, xmerge2):
    """Per-gap subgraph pairs along an anchor chain, including the leading
    and trailing gaps to the sentinels when tableaus are given
    (anchorer.hpp:432-495)."""
    pairs = []
    if not len(anchor_chain) and tableau1 is not None:
        pairs.append(do_extraction(
            tableau1.src_id, tableau1.snk_id, tableau2.src_id, tableau2.snk_id,
            graph1, graph2, xmerge1, xmerge2))
        return pairs
    if tableau1 is not None:
        pairs.append(do_extraction(
            tableau1.src_id, anchor_chain[0].walk1[0],
            tableau2.src_id, anchor_chain[0].walk2[0],
            graph1, graph2, xmerge1, xmerge2))
    for i in range(1, len(anchor_chain)):
        prev, cur = anchor_chain[i - 1], anchor_chain[i]
        pairs.append(do_extraction(
            prev.walk1[-1], cur.walk1[0], prev.walk2[-1], cur.walk2[0],
            graph1, graph2, xmerge1, xmerge2))
    if tableau1 is not None:
        pairs.append(do_extraction(
            anchor_chain[-1].walk1[-1], tableau1.snk_id,
            anchor_chain[-1].walk2[-1], tableau2.snk_id,
            graph1, graph2, xmerge1, xmerge2))
    return pairs


def extract_graphs_between_segments(anchor_segments, graph1, graph2,
                                    tableau1, tableau2, xmerge1, xmerge2):
    """(within_segment_graphs, between_segment_graphs) for a segmented chain
    (anchorer.hpp:497-580)."""
    within, between = [], []
    if not anchor_segments:
        between.append(do_extraction(
            tableau1.src_id, tableau1.snk_id, tableau2.src_id, tableau2.snk_id,
            graph1, graph2, xmerge1, xmerge2))
        return within, between
    between.append(do_extraction(
        tableau1.src_id, anchor_segments[0][0].walk1[0],
        tableau2.src_id, anchor_segments[0][0].walk2[0],
        graph1, graph2, xmerge1, xmerge2))
    for i, segment in enumerate(anchor_segments):
        if i != 0:
            prev = anchor_segments[i - 1][-1]
            between.append(do_extraction(
                prev.walk1[-1], segment[0].walk1[0],
                prev.walk2[-1], segment[0].walk2[0],
                graph1, graph2, xmerge1, xmerge2))
        seg_graphs = []
        for j in range(1, len(segment)):
            prev, cur = segment[j - 1], segment[j]
            seg_graphs.append(do_extraction(
                prev.walk1[-1], cur.walk1[0], prev.walk2[-1], cur.walk2[0],
                graph1, graph2, xmerge1, xmerge2))
        within.append(seg_graphs)
    between.append(do_extraction(
        anchor_segments[-1][-1].walk1[-1], tableau1.snk_id,
        anchor_segments[-1][-1].walk2[-1], tableau2.snk_id,
        graph1, graph2, xmerge1, xmerge2))
    return within, between


def project_paths(graph1, graph2, stitch_graphs):
    """Project the parent graphs' paths onto extractions (anchorer.hpp:588-616).
    Paths are added in first-encounter order over the subgraph's topological
    order."""
    si1, si2 = StepIndex(graph1), StepIndex(graph2)
    for gi, (graph, si) in enumerate(((graph1, si1), (graph2, si2))):
        for pair in stitch_graphs:
            _project_one(graph, si, pair[gi])


def _project_one(graph, step_index: "StepIndex", sub: SubGraphInfo):
    if sub.subgraph.node_size == 0:
        return
    back = np.asarray(sub.back_translation, dtype=_I64)
    from .native import reference_topological_order as _ref_topo
    order = _ref_topo(sub.subgraph)
    # gather all (pid, position) pairs of the ordered nodes, vectorized
    onodes = back[order]
    st = step_index._indptr[onodes]
    en = step_index._indptr[onodes + 1]
    counts = en - st
    total = int(counts.sum())
    if total == 0:
        return
    from .graph_algs import _multi_range
    flat = _multi_range(st, en)
    pids = step_index._pids[flat]
    pos = np.repeat(np.arange(len(order), dtype=_I64), counts)
    sub_nodes = order[pos]
    # first-encounter order of paths over the traversal (vectorized)
    vals, first_idx = np.unique(pids, return_index=True)
    enc = vals[np.argsort(first_idx, kind="stable")].tolist()
    rank_map = np.empty(graph.path_size, dtype=_I64)
    rank_map[enc] = np.arange(len(enc), dtype=_I64)
    rank = rank_map[pids]
    sort = np.argsort(rank, kind="stable")
    spids = {}
    for p in enc:
        spids[p] = sub.subgraph.add_path(graph.path_name(p))
    # extend each path with its nodes in traversal order
    sorted_rank = rank[sort]
    sorted_nodes = sub_nodes[sort]
    bounds = np.flatnonzero(np.diff(sorted_rank)) + 1
    chunks = np.split(sorted_nodes, bounds)
    for p, chunk in zip(enc, chunks):
        sub.subgraph.extend_path_array(spids[p], chunk)


class StepIndex:
    """node -> [(path, step)] memo (reference step_index.hpp:13)."""

    def __init__(self, graph):
        self.graph = graph
        V = graph.node_size
        pids, steps, nodes = [], [], []
        for pid in range(graph.path_size):
            p = graph.path(pid)
            pids.append(np.full(len(p), pid, dtype=_I64))
            steps.append(np.arange(len(p), dtype=_I64))
            nodes.append(p)
        if pids:
            pids = np.concatenate(pids)
            steps = np.concatenate(steps)
            nodes = np.concatenate(nodes)
            order = np.argsort(nodes, kind="stable")
            self._nodes = nodes[order]
            self._pids = pids[order]
            self._steps = steps[order]
            self._indptr = np.searchsorted(self._nodes, np.arange(V + 1))
        else:
            self._indptr = np.zeros(V + 1, dtype=_I64)
            self._pids = np.empty(0, dtype=_I64)
            self._steps = np.empty(0, dtype=_I64)

    def path_steps(self, node_id: int):
        s, e = self._indptr[node_id], self._indptr[node_id + 1]
        return list(zip(self._pids[s:e].tolist(), self._steps[s:e].tolist()))


def source_sink_minmax(extraction: SubGraphInfo):
    """(min, max) distance from the extraction's sources to its sinks
    (reference src/anchorer.cpp:14-23)."""
    from .native import minmax_distance as _native_minmax
    mind, maxd = _native_minmax(
        extraction.subgraph, np.asarray(extraction.sources, dtype=_I64))
    lo, hi = np.iinfo(np.int64).max, -1
    for s in extraction.sinks:
        lo = min(lo, int(mind[s]))
        hi = max(hi, int(maxd[s]))
    return lo, hi

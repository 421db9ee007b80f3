"""Graph construction and mutation utilities.

Equivalents of the reference's modify_graph module (reference
include/centrolign/modify_graph.hpp, src/modify_graph.cpp): chain-graph
construction from sequences, sentinel handling, uncovered-node purging, and
component appending — all vectorized.

Copy of centrolign_tpu/modify_graph.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .graph import BaseGraph
from .utils.encoding import encode_seq

_I64 = np.int64


@dataclass
class SentinelTableau:
    """Bookkeeping for the source/sink sentinel nodes added around a graph
    (reference modify_graph.hpp:27)."""

    src_id: int = -1
    snk_id: int = -1
    src_sentinel: int = 0
    snk_sentinel: int = 0


def make_base_graph(name: str, sequence: str) -> BaseGraph:
    """Sequence -> chain graph with one embedded path (reference
    src/modify_graph.cpp:30-45)."""
    if not sequence or not name:
        raise ValueError("name and sequence must be non-empty")
    g = BaseGraph()
    codes = encode_seq(sequence)
    ids = g.add_nodes(codes)
    pid = g.add_path(name)
    g.extend_path_array(pid, ids)
    if len(ids) > 1:
        g.add_edges(ids[:-1], ids[1:])
    return g


def add_sentinels(graph: BaseGraph, src_sentinel: int, snk_sentinel: int) -> SentinelTableau:
    """Add source/sink sentinel nodes wired to path endpoints and to
    source/sink nodes (reference src/modify_graph.cpp:47-78)."""
    V = graph.node_size
    path_begin = np.zeros(V, dtype=bool)
    path_end = np.zeros(V, dtype=bool)
    for pid in range(graph.path_size):
        p = graph.path(pid)
        path_begin[p[0]] = True
        path_end[p[-1]] = True

    t = SentinelTableau()
    outdeg = graph.out_degrees() if V else np.empty(0, dtype=_I64)
    indeg = graph.in_degrees() if V else np.empty(0, dtype=_I64)
    t.src_id = graph.add_node(src_sentinel)
    t.snk_id = graph.add_node(snk_sentinel)
    t.src_sentinel = src_sentinel
    t.snk_sentinel = snk_sentinel

    if graph.node_size == 2:
        graph.add_edge(t.src_id, t.snk_id)
        return t

    # edge insertion order matches the reference: one pass over node ids,
    # adding (node -> snk) then (src -> node) per node as conditions hold
    to_snk = (outdeg == 0) | path_end
    from_src = (indeg == 0) | path_begin
    # interleave in reference order
    ef, et = [], []
    snk_nodes = np.flatnonzero(to_snk)
    src_nodes = np.flatnonzero(from_src)
    merged = np.union1d(snk_nodes, src_nodes)
    for v in merged:
        if to_snk[v]:
            ef.append(v)
            et.append(t.snk_id)
        if from_src[v]:
            ef.append(t.src_id)
            et.append(v)
    graph.add_edges(np.array(ef, dtype=_I64), np.array(et, dtype=_I64))
    return t


def reassign_sentinels(graph: BaseGraph, tableau: SentinelTableau,
                       src_sentinel: int, snk_sentinel: int) -> None:
    tableau.src_sentinel = src_sentinel
    tableau.snk_sentinel = snk_sentinel
    graph.relabel(tableau.src_id, src_sentinel)
    graph.relabel(tableau.snk_id, snk_sentinel)


def purge_uncovered_nodes(graph: BaseGraph, tableau: SentinelTableau) -> BaseGraph:
    """Drop nodes not covered by any path (sentinels always kept), compacting
    ids (reference src/modify_graph.cpp:90-160). Returns the (possibly new)
    graph and updates the tableau in place."""
    V = graph.node_size
    covered = np.zeros(V, dtype=bool)
    covered[tableau.src_id] = True
    covered[tableau.snk_id] = True
    for pid in range(graph.path_size):
        covered[graph.path(pid)] = True
    if covered.all():
        return graph

    new_id = np.cumsum(covered, dtype=_I64) - 1
    purged = BaseGraph()
    purged.add_nodes(graph.labels[covered])
    ef, et = graph.edges()
    keep = covered[ef] & covered[et]
    purged.add_edges(new_id[ef[keep]], new_id[et[keep]])
    for pid in range(graph.path_size):
        np_pid = purged.add_path(graph.path_name(pid))
        purged.extend_path_array(np_pid, new_id[graph.path(pid)])
    tableau.src_id = int(new_id[tableau.src_id])
    tableau.snk_id = int(new_id[tableau.snk_id])
    return purged


def append_component(appending: BaseGraph, component: BaseGraph) -> None:
    """Graft a graph as a disjoint component (reference modify_graph.hpp:55)."""
    offset = appending.node_size
    appending.add_nodes(component.labels)
    ef, et = component.edges()
    appending.add_edges(ef + offset, et + offset)
    for pid in range(component.path_size):
        new_pid = appending.add_path(component.path_name(pid))
        appending.extend_path_array(new_pid, component.path(pid) + offset)


def _net_alleles_trivial(graph: BaseGraph, snarls, snarl_id: int) -> bool:
    """Net-graph test that every allele of a snarl is a single net node
    (reference structure_tree.hpp:321-400 NetGraph ctor +
    src/modify_graph.cpp:231-246)."""
    start, end = snarls.structure_boundaries(snarl_id)
    fwd = {start: 0}
    edges = [[]]
    stack = [start]
    while stack:
        node_id = stack.pop()
        if node_id == end:
            continue
        for nxt in graph.next(node_id):
            nxt = int(nxt)
            if nxt in fwd:
                edges[fwd[node_id]].append(fwd[nxt])
                continue
            ns = snarls.structure_beginning_at(nxt)
            if ns != -1 and nxt != end:
                # condense the whole chain into one net node
                chain_id = snarls.chain_containing(ns)
                net_id = len(edges)
                edges.append([])
                final_s = snarls.structures_inside(chain_id)[-1]
                final_node = snarls.structure_boundaries(final_s)[1]
                fwd[nxt] = net_id
                fwd[final_node] = net_id
                edges[fwd[node_id]].append(net_id)
                stack.append(final_node)
            else:
                net_id = len(edges)
                edges.append([])
                fwd[nxt] = net_id
                edges[fwd[node_id]].append(net_id)
                stack.append(nxt)
    net_snk = fwd[end]
    for nid in edges[0]:  # net node 0 is the source boundary
        if nid != net_snk and (len(edges[nid]) != 1
                               or edges[nid][0] != net_snk):
            return False
    return True


def simplify_bubbles(graph: BaseGraph, tableau: SentinelTableau) -> BaseGraph:
    """Merge identical alleles of simple (possibly multi-allelic) bubbles in a
    cyclized graph, then purge the uncovered duplicate nodes (reference
    src/modify_graph.cpp:165-381). Returns the (possibly new) graph; the
    tableau is updated in place."""
    from .extractor import StepIndex
    from .native import SnarlTree

    snarls = SnarlTree(graph, tableau)

    # a chain is trivial if all of its snarls are trivial
    chain_is_trivial = [True] * snarls.chain_count
    for chain_id in range(snarls.chain_count):
        for snarl_id in snarls.structures_inside(chain_id):
            if graph.next_size(snarls.structure_boundaries(snarl_id)[0]) != 1:
                chain_is_trivial[chain_id] = False
                break

    chains_inside = [[] for _ in range(snarls.structure_size)]
    for chain_id in range(snarls.chain_count):
        parent = int(snarls.chain_parent[chain_id])
        if parent >= 0:
            chains_inside[parent].append(chain_id)

    step_index = StepIndex(graph)
    did_simplify = False

    for snarl_id in range(snarls.structure_size):
        if not snarls.snarl_is_acyclic(snarl_id):
            continue
        if any(not chain_is_trivial[c] for c in chains_inside[snarl_id]):
            continue
        if not _net_alleles_trivial(graph, snarls, snarl_id):
            continue
        src_id, snk_id = snarls.structure_boundaries(snarl_id)
        # group the alleles by sequence
        sequence_paths: dict[bytes, list[list[int]]] = {}
        for nid in graph.next(src_id):
            allele = bytearray()
            allele_path = []
            node_id = int(nid)
            while node_id != snk_id:
                allele.append(int(graph.labels[node_id]))
                allele_path.append(node_id)
                node_id = int(graph.next(node_id)[0])
            sequence_paths.setdefault(bytes(allele), []).append(allele_path)
        # reassign any identical alleles to the first option
        for paths in sequence_paths.values():
            for i in range(1, len(paths)):
                if not paths[i]:
                    continue  # duplicate deletion alleles can't occur
                for pid, step in step_index.path_steps(paths[i][0]):
                    graph.reassign_subpath(pid, step, paths[0])
                    did_simplify = True

    if did_simplify:
        graph = purge_uncovered_nodes(graph, tableau)
    return graph


def make_simple(graph: BaseGraph) -> BaseGraph:
    """Remove duplicate (multi-)edges, keeping first occurrences in order."""
    ef, et = graph.edges()
    V = graph.node_size
    keys = ef * V + et
    _, first = np.unique(keys, return_index=True)
    first.sort()
    g = BaseGraph()
    g.add_nodes(graph.labels)
    g.add_edges(ef[first], et[first])
    for pid in range(graph.path_size):
        np_pid = g.add_path(graph.path_name(pid))
        g.extend_path_array(np_pid, graph.path(pid))
    return g

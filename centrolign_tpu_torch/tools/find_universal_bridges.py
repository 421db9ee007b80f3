"""Locate the leftmost/rightmost universal bridge of a graph (reference
src/scripts/find_universal_bridges.cpp).

Usage: python -m centrolign_tpu_torch.tools.find_universal_bridges [-r] graph.gfa
       > bridge.txt

A universal bridge is a node whose adjacency-graph edge (over the
unipath-compacted graph) is a bridge — removal disconnects the graph —
i.e., a point every walk must traverse. Prints the ORIGINAL GFA segment id
containing the chosen node plus its position on every path, exactly as
the reference tool formats them.

Copy of centrolign_tpu/tools/find_universal_bridges.py.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

_I64 = np.int64


def _compact(graph):
    """Unipath compaction (reference compacted_graph.hpp): returns
    (topology BaseGraph with one node per chain, front ids, back ids)."""
    from ..graph import BaseGraph

    V = graph.node_size
    indeg = graph.in_degrees()
    outdeg = graph.out_degrees()
    nptr, nind = graph.next_csr()
    pptr, pind = graph.prev_csr()

    is_start = indeg != 1
    m = ~is_start
    if m.any():
        # unique predecessor of each single-in-degree node
        preds = pind[pptr[:-1][m]]
        is_start[np.flatnonzero(m)[outdeg[preds] != 1]] = True
    starts = np.flatnonzero(is_start)
    comp_of = np.full(V, -1, dtype=_I64)
    fronts, backs = [], []
    for cid, s in enumerate(starts):
        v = int(s)
        fronts.append(v)
        comp_of[v] = cid
        while outdeg[v] == 1:
            nx = int(nind[nptr[v]])
            if indeg[nx] != 1:
                break
            v = nx
            comp_of[v] = cid
        backs.append(v)
    cg = BaseGraph()
    cg.add_nodes(np.zeros(len(starts), dtype=np.uint8))
    ef, et = [], []
    for cid, b in enumerate(backs):
        for nx in graph.next(b):
            ef.append(cid)
            et.append(int(comp_of[nx]))
    if ef:
        cg.add_edges(np.asarray(ef, dtype=_I64), np.asarray(et, dtype=_I64))
    return cg, np.asarray(fronts, dtype=_I64), np.asarray(backs, dtype=_I64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-r", "--rightmost", action="store_true")
    ap.add_argument("gfa")
    args = ap.parse_args(argv)
    leftmost = not args.rightmost

    from ..extractor import StepIndex
    from ..graph_algs import bridges
    from ..graph_overlays import AdjacencyGraph
    from ..io.gfa import read_gfa
    from ..modify_graph import add_sentinels

    try:
        with open(args.gfa) as f:
            gfa_text = f.read()
    except OSError:
        print(f"error: could not open GFA file {args.gfa}", file=sys.stderr)
        return 1
    graph = read_gfa(gfa_text)
    if graph.node_size == 0:
        print("error: Graph is empty.", file=sys.stderr)
        return 1
    if graph.path_size == 0:
        print("error: Graph has no paths.", file=sys.stderr)
        return 1

    print("Finding bridges...", file=sys.stderr)
    tableau = add_sentinels(graph, 5, 6)
    cg, fronts, backs = _compact(graph)
    adj = AdjacencyGraph(cg)
    adj_bridges = bridges(adj)

    print("Choosing between bridges...", file=sys.stderr)
    step_index = StepIndex(graph)

    bridge_node = -1
    bridge_pos = -1
    for a, b in np.asarray(adj_bridges):
        compacted_id = -1
        for target, label in adj.next_edges(int(a)):
            if target == int(b):
                compacted_id = label
                break
        assert compacted_id != -1
        node_id = int(fronts[compacted_id] if leftmost
                      else backs[compacted_id])
        if node_id == tableau.src_id and leftmost:
            if int(backs[compacted_id]) != tableau.src_id:
                node_id = int(graph.next(node_id)[0])
            else:
                continue
        if node_id == tableau.snk_id and not leftmost:
            if int(fronts[compacted_id]) != tableau.snk_id:
                node_id = int(graph.previous(node_id)[0])
            else:
                continue
        for path_id, pos in step_index.path_steps(node_id):
            if path_id == 0:
                if (bridge_pos == -1
                        or (leftmost and bridge_pos > pos)
                        or (not leftmost and bridge_pos < pos)):
                    bridge_node = node_id
                    bridge_pos = pos
                break

    out = sys.stdout
    if bridge_node == -1:
        out.write("Graph does not contain any bridges.\n")
        return 0

    # map the chosen path-0 position back to the ORIGINAL GFA segment by
    # replaying path 0's P line against the S-line lengths (the in-memory
    # graph is base-expanded, so segment ids only exist in the text)
    node_len = {}
    path0_steps = None
    path0_name = graph.path_name(0)
    for line in gfa_text.splitlines():
        if not line:
            continue
        if line[0] == "S":
            _s, seg, seq = line.split("\t")[:3]
            node_len[int(seg)] = len(seq)
        elif line[0] == "P":
            name = line[2:line.index("\t", 2)]
            if name == path0_name and path0_steps is None:
                path0_steps = line.split("\t")[2].split(",")
    assert path0_steps is not None
    walked = 0
    i = 0
    while walked < bridge_pos:
        step = path0_steps[i]
        i += 1
        walked += node_len[int(step[:-1])]
    i = max(i, 1)  # position 0: the first segment (reference underflows)
    out.write(f"node:\t{path0_steps[i - 1][:-1]}\n")
    for path_id, pos in step_index.path_steps(bridge_node):
        out.write(f"position:\t{graph.path_name(path_id)}\t{pos}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

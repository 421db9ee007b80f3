"""GFA v1.0 output/input, byte-compatible with the reference writer
(reference include/centrolign/gfa.hpp:48-157, src/gfa.cpp).

The writer emits a maximally node-compacted GFA: unary chains of base nodes
that are not interrupted by path endpoints become one segment, numbered in
order of the minimum node id they contain (which is the order the reference's
ascending-id seed scan discovers them). Byte-for-byte equality with the
reference's output on the same graph is a correctness oracle for the whole
pipeline. Chain resolution uses pointer doubling so writing stays
O(V log V) vectorized instead of a Python walk per segment.

Copy of centrolign_tpu/io/gfa.py.
"""

from __future__ import annotations

import io

import numpy as np

from ..graph import BaseGraph
from ..modify_graph import SentinelTableau
from ..utils.encoding import decode_seq, encode_seq

_I64 = np.int64


def _compact_segments(graph: BaseGraph, is_sentinel: np.ndarray):
    """Return (seg_of_node, pos_in_seg, seg_order_nodes, seg_bounds,
    compacted_id, compacted_end): maximal unary-chain compaction."""
    V = graph.node_size
    next_ptr, next_ind = graph.next_csr()
    prev_ptr, prev_ind = graph.prev_csr()
    outdeg = np.diff(next_ptr)
    indeg = np.diff(prev_ptr)

    path_begin = np.zeros(V, dtype=bool)
    path_end = np.zeros(V, dtype=bool)
    for pid in range(graph.path_size):
        p = graph.path(pid)
        if len(p):
            path_begin[p[0]] = True
            path_end[p[-1]] = True

    first_next = np.full(V, -1, dtype=_I64)
    has_out = outdeg > 0
    first_next[has_out] = next_ind[next_ptr[:-1][has_out]]

    merge_right = np.zeros(V, dtype=bool)
    cand = (outdeg == 1) & ~path_end & ~is_sentinel
    tgt = first_next[cand]
    ok = (indeg[tgt] == 1) & ~path_begin[tgt] & ~is_sentinel[tgt]
    merge_right[np.flatnonzero(cand)[ok]] = True

    # merge-left pointer: parent[v] = u iff u merges right into v
    parent = np.full(V, -1, dtype=_I64)
    src = np.flatnonzero(merge_right)
    parent[first_next[src]] = src

    def _resolve(par):
        """Pointer-double to (nearest-known-ancestor, distance) per node.
        A node is resolved when its ancestor is a chain head. Nodes on a
        unary cycle never resolve and are reported separately."""
        anc = par.copy()
        dist = (par != -1).astype(_I64)
        max_rounds = max(1, int(np.ceil(np.log2(max(V, 2)))) + 2)
        for _ in range(max_rounds):
            # unresolved: ancestor exists and itself has an ancestor
            live = np.flatnonzero((anc != -1) & (par[anc] != -1))
            if len(live) == 0:
                break
            a = anc[live]
            dist[live] += dist[a]
            anc[live] = anc[a]
        unresolved = np.flatnonzero((anc != -1) & (par[anc] != -1))
        return anc, dist, unresolved

    anc, dist, cyc = _resolve(parent)
    if len(cyc):
        # unary cycles (possible only in -c cyclized graphs): break each at
        # its minimum-id node, then re-resolve
        remaining = set(cyc.tolist())
        while remaining:
            v0 = min(remaining)
            v = v0
            while True:
                remaining.discard(v)
                v = int(parent[v])
                if v == v0:
                    break
            merge_right[parent[v0]] = False
            parent[v0] = -1
        anc, dist, _ = _resolve(parent)

    head = np.arange(V, dtype=_I64)
    chained = parent != -1
    head[chained] = anc[chained]
    pos = dist

    # order nodes by (head, pos) to get per-segment node lists
    nonsent = ~is_sentinel
    nodes = np.flatnonzero(nonsent)
    order = np.lexsort((pos[nodes], head[nodes]))
    seq_nodes = nodes[order]
    heads_sorted = head[seq_nodes]
    bounds = np.flatnonzero(np.diff(heads_sorted) != 0) + 1
    starts = np.concatenate(([0], bounds))
    ends = np.concatenate((bounds, [len(seq_nodes)]))

    # segment rank = order of min node id within segment (== head group min)
    seg_min = np.minimum.reduceat(seq_nodes, starts) if len(seq_nodes) else np.empty(0, dtype=_I64)
    seg_order = np.argsort(seg_min, kind="stable")

    compacted_id = np.full(V, -1, dtype=_I64)
    compacted_end = np.zeros(V, dtype=bool)
    for rank, si in enumerate(seg_order, start=1):
        seg = seq_nodes[starts[si]:ends[si]]
        compacted_id[seg] = rank
        compacted_end[seg[-1]] = True
    return seq_nodes, starts, ends, seg_order, compacted_id, compacted_end


def write_gfa(graph: BaseGraph, tableau: SentinelTableau | None, out, decode: bool = True) -> None:
    V = graph.node_size
    is_sentinel = np.zeros(V, dtype=bool)
    if tableau is not None and V:
        is_sentinel[tableau.src_id] = True
        is_sentinel[tableau.snk_id] = True

    lines = ["H\tVN:Z:1.0"]
    if V:
        seq_nodes, starts, ends, seg_order, compacted_id, compacted_end = \
            _compact_segments(graph, is_sentinel)
        labels = graph.labels

        for si in seg_order:
            seg = seq_nodes[starts[si]:ends[si]]
            seq = decode_seq(labels[seg]) if decode else labels[seg].tobytes().decode("latin1")
            lines.append(f"S\t{compacted_id[seg[0]]}\t{seq}")

        next_ptr, next_ind = graph.next_csr()
        l_from = np.flatnonzero(compacted_end & ~is_sentinel)
        for v in l_from:
            for w in next_ind[next_ptr[v]:next_ptr[v + 1]]:
                if not is_sentinel[w]:
                    lines.append(f"L\t{compacted_id[v]}\t+\t{compacted_id[w]}\t+\t*")

        for pid in range(graph.path_size):
            p = graph.path(pid)
            p = p[~is_sentinel[p]]
            if len(p):
                write_next = np.concatenate(([True], compacted_end[p[:-1]]))
                steps = compacted_id[p[write_next]]
                body = "+,".join(map(str, steps)) + "+"
            else:
                body = ""
            lines.append(f"P\t{graph.path_name(pid)}\t{body}\t*")
    else:
        for pid in range(graph.path_size):
            lines.append(f"P\t{graph.path_name(pid)}\t\t*")
    out.write("\n".join(lines) + "\n")


def write_gfa_str(graph: BaseGraph, tableau: SentinelTableau | None = None, decode: bool = True) -> str:
    buf = io.StringIO()
    write_gfa(graph, tableau, buf, decode)
    return buf.getvalue()


def read_gfa(stream, encode: bool = True) -> BaseGraph:
    """Read a GFA v1.0/1.1 with integer segment ids, lines ordered H,S,L,P
    (reference gfa.hpp:25, src/gfa.cpp), expanding segments to base nodes."""
    if isinstance(stream, str):
        stream = io.StringIO(stream)
    g = BaseGraph()
    seg_first: dict[int, int] = {}
    seg_last: dict[int, int] = {}
    seg_nodes: dict[int, np.ndarray] = {}
    for line in stream:
        line = line.rstrip("\n")
        if not line:
            continue
        fields = line.split("\t")
        tag = fields[0]
        if tag == "H":
            continue
        elif tag == "S":
            seg_id = int(fields[1])
            seq = fields[2]
            codes = encode_seq(seq) if encode else np.frombuffer(seq.encode("latin1"), dtype=np.uint8)
            ids = g.add_nodes(codes)
            if len(ids) > 1:
                g.add_edges(ids[:-1], ids[1:])
            seg_first[seg_id] = int(ids[0])
            seg_last[seg_id] = int(ids[-1])
            seg_nodes[seg_id] = ids
        elif tag == "L":
            a, ao, b, bo = fields[1], fields[2], fields[3], fields[4]
            if ao != "+" or bo != "+":
                raise ValueError("only forward-strand GFA links are supported")
            g.add_edge(seg_last[int(a)], seg_first[int(b)])
        elif tag == "P":
            name = fields[1]
            pid = g.add_path(name)
            if fields[2]:
                for step in fields[2].split(","):
                    if step[-1] not in "+-":
                        raise ValueError(f"malformed path step {step!r}")
                    if step[-1] == "-":
                        raise ValueError("only forward-strand path steps are supported")
                    g.extend_path_array(pid, seg_nodes[int(step[:-1])])
    return g

"""Graph overlay adapters (reference reverse_graph.hpp, source_sink_graph.hpp,
adjacency_graph.hpp, chain_cycle_graph.hpp, labeled_graph.hpp).

The reference wraps its node-object graphs in thin template overlays; here
the same views are exposed over the SoA BaseGraph interface the rest of the
package consumes (``node_size`` property + ``next_csr()``/``prev_csr()`` +
degree vectors), so every overlay composes with graph_algs (topological
order, reachability, ...) unchanged.

Copy of centrolign_tpu/graph_overlays.py.
"""

from __future__ import annotations

import numpy as np

_I64 = np.int64


def _csr_from_edges(V: int, efrom, eto):
    efrom = np.asarray(efrom, dtype=_I64)
    eto = np.asarray(eto, dtype=_I64)
    order = np.argsort(efrom, kind="stable")
    indptr = np.zeros(V + 1, dtype=_I64)
    np.cumsum(np.bincount(efrom, minlength=V), out=indptr[1:])
    return indptr, eto[order]


class _CsrView:
    """Shared plumbing: subclasses fill _next (indptr, indices) and _prev."""

    @property
    def node_size(self) -> int:
        return self._V

    def next_csr(self):
        return self._next

    def prev_csr(self):
        return self._prev

    def out_degrees(self) -> np.ndarray:
        p = self._next[0]
        return p[1:] - p[:-1]

    def in_degrees(self) -> np.ndarray:
        p = self._prev[0]
        return p[1:] - p[:-1]

    def next(self, node_id: int) -> np.ndarray:
        p, i = self._next
        return i[p[node_id]:p[node_id + 1]]

    def previous(self, node_id: int) -> np.ndarray:
        p, i = self._prev
        return i[p[node_id]:p[node_id + 1]]


class ReverseGraph(_CsrView):
    """Edge-reversed view (reference reverse_graph.hpp:13): next and
    previous swap; labels pass through."""

    def __init__(self, graph):
        self._graph = graph
        self._V = graph.node_size
        self._next = graph.prev_csr()
        self._prev = graph.next_csr()

    @property
    def labels(self) -> np.ndarray:
        return self._graph.labels


class SourceSinkGraph(_CsrView):
    """Adds one virtual source (id V) with edges to every in-degree-0 node
    and one virtual sink (id V+1) from every out-degree-0 node (reference
    source_sink_graph.hpp:14)."""

    def __init__(self, graph):
        V = graph.node_size
        self._V = V + 2
        self._source_id = V
        self._sink_id = V + 1
        ef, et = graph.edges()
        srcs = np.flatnonzero(graph.in_degrees() == 0)
        snks = np.flatnonzero(graph.out_degrees() == 0)
        efrom = np.concatenate([ef, np.full(len(srcs), V, dtype=_I64), snks])
        eto = np.concatenate([et, srcs, np.full(len(snks), V + 1, dtype=_I64)])
        self._next = _csr_from_edges(self._V, efrom, eto)
        self._prev = _csr_from_edges(self._V, eto, efrom)

    def source_id(self) -> int:
        return self._source_id

    def sink_id(self) -> int:
        return self._sink_id


class ChainCycleGraph(_CsrView):
    """Joins the sink back to the source, turning the top-level chain into a
    cycle (reference chain_cycle_graph.hpp:17). src/snk are expected to be a
    source and a sink of the underlying graph (the sentinel pair)."""

    def __init__(self, graph, src_id: int, snk_id: int):
        self._V = graph.node_size
        ef, et = graph.edges()
        efrom = np.concatenate([ef, [snk_id]]).astype(_I64)
        eto = np.concatenate([et, [src_id]]).astype(_I64)
        self._next = _csr_from_edges(self._V, efrom, eto)
        self._prev = _csr_from_edges(self._V, eto, efrom)


class AdjacencyGraph(_CsrView):
    """Nodes = adjacency components (groups of node sides connected by
    edges), edges = nodes of the underlying graph (reference
    adjacency_graph.hpp:16). Each underlying node becomes one edge from the
    component of its left side to the component of its right side;
    ``next_edges``/``previous_edges`` carry the underlying node as label.

    Component ids match the reference's discovery order (scan node sides
    right-side-first per node, flood across edges)."""

    def __init__(self, graph):
        V = graph.node_size
        nptr, nind = graph.next_csr()
        pptr, pind = graph.prev_csr()
        # side index: 2*v = right side of v, 2*v + 1 = left side of v
        comp = np.full(2 * V, -1, dtype=_I64)
        n_comp = 0
        for seed in range(2 * V):
            if comp[seed] != -1:
                continue
            comp[seed] = n_comp
            stack = [(seed // 2, bool(seed % 2))]
            while stack:
                node_id, left = stack.pop()
                nbrs = (pind[pptr[node_id]:pptr[node_id + 1]] if left
                        else nind[nptr[node_id]:nptr[node_id + 1]])
                for nx in nbrs:
                    j = 2 * int(nx) + (0 if left else 1)
                    if comp[j] == -1:
                        comp[j] = n_comp
                        stack.append((int(nx), not left))
            n_comp += 1
        self._V = n_comp
        self._comp = comp
        right = comp[0::2]   # component of each node's right side
        leftc = comp[1::2]   # component of each node's left side
        self._edge_label = np.arange(V, dtype=_I64)
        # edge: left component -> right component, labeled by the node
        self._efrom, self._eto = leftc, right
        self._next = _csr_from_edges(n_comp, leftc, right)
        self._prev = _csr_from_edges(n_comp, right, leftc)
        order = np.argsort(leftc, kind="stable")
        self._next_labels = (self._next[0], order)
        order_p = np.argsort(right, kind="stable")
        self._prev_labels = (self._prev[0], order_p)

    def side_component(self, node_id: int, left: bool) -> int:
        return int(self._comp[2 * node_id + (1 if left else 0)])

    def next_edges(self, comp_id: int):
        """[(target component, underlying node label), ...]"""
        p, lab = self._next_labels
        labs = lab[p[comp_id]:p[comp_id + 1]]
        return [(int(self._eto[k]), int(k)) for k in labs]

    def previous_edges(self, comp_id: int):
        p, lab = self._prev_labels
        labs = lab[p[comp_id]:p[comp_id + 1]]
        return [(int(self._efrom[k]), int(k)) for k in labs]


class LabeledGraph:
    """Mutable directed graph with arbitrary node labels (reference
    labeled_graph.hpp:16) — the generic sibling of BaseGraph's uint8-labeled
    SoA, for host-side algorithm scaffolding."""

    def __init__(self):
        self._labels = []
        self._next = []
        self._prev = []

    @property
    def node_size(self) -> int:
        return len(self._labels)

    def add_node(self, label) -> int:
        self._labels.append(label)
        self._next.append([])
        self._prev.append([])
        return len(self._labels) - 1

    def add_edge(self, node_from: int, node_to: int) -> None:
        self._next[node_from].append(node_to)
        self._prev[node_to].append(node_from)

    def label(self, node_id: int):
        return self._labels[node_id]

    def relabel(self, node_id: int, label) -> None:
        self._labels[node_id] = label

    def next(self, node_id: int):
        return np.asarray(self._next[node_id], dtype=_I64)

    def previous(self, node_id: int):
        return np.asarray(self._prev[node_id], dtype=_I64)

    def next_csr(self):
        ef = [u for u in range(self.node_size) for _ in self._next[u]]
        et = [v for u in range(self.node_size) for v in self._next[u]]
        return _csr_from_edges(self.node_size, ef, et)

    def prev_csr(self):
        ef = [u for u in range(self.node_size) for _ in self._next[u]]
        et = [v for u in range(self.node_size) for v in self._next[u]]
        return _csr_from_edges(self.node_size, et, ef)

    def in_degrees(self) -> np.ndarray:
        return np.array([len(p) for p in self._prev], dtype=_I64)

    def out_degrees(self) -> np.ndarray:
        return np.array([len(n) for n in self._next], dtype=_I64)

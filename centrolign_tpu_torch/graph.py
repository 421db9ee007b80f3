"""Sequence-DAG graph model, struct-of-arrays.

The reference models graphs as node objects with per-node ``next``/``prev``
adjacency vectors and embedded named paths (reference include/centrolign/
graph.hpp:94).  Here the graph is a struct-of-arrays designed for bulk numpy
mutation on the host and zero-copy handoff to device kernels:

- ``labels``: uint8[V] encoded bases (0..4 = ACGTN, 5..8 = sentinels)
- edges: growable (from, to) arrays; per-node adjacency is materialized
  lazily as CSR (out-edges) / CSC (in-edges) with **insertion order preserved
  per node** — this matters because alignment traceback tie-breaking follows
  adjacency-list order, so CSR construction uses stable sorts.
- paths: named node-id arrays.

Node ids are dense int64 starting at 0, append-only (removal happens by
rebuilding, as in the reference's purge/simplify operations).

Copy of centrolign_tpu/graph.py.
"""

from __future__ import annotations

import numpy as np

_I64 = np.int64


class _GrowBuf:
    """Amortized-growth 1-D int64 buffer."""

    __slots__ = ("data", "n")

    def __init__(self, cap: int = 16):
        self.data = np.empty(cap, dtype=_I64)
        self.n = 0

    def _grow(self, cap: int) -> None:
        new = np.empty(cap, dtype=_I64)
        new[: self.n] = self.data[: self.n]
        self.data = new

    def append(self, v: int) -> None:
        if self.n == len(self.data):
            self._grow(max(16, 2 * len(self.data)))
        self.data[self.n] = v
        self.n += 1

    def extend(self, vals) -> None:
        vals = np.asarray(vals, dtype=_I64)
        need = self.n + len(vals)
        if need > len(self.data):
            self._grow(max(need, 2 * len(self.data)))
        self.data[self.n : need] = vals
        self.n = need

    def view(self) -> np.ndarray:
        return self.data[: self.n]


class _GrowBufU8:
    __slots__ = ("data", "n")

    def __init__(self, cap: int = 16):
        self.data = np.empty(cap, dtype=np.uint8)
        self.n = 0

    def _grow(self, cap: int) -> None:
        new = np.empty(cap, dtype=np.uint8)
        new[: self.n] = self.data[: self.n]
        self.data = new

    def append(self, v: int) -> None:
        if self.n == len(self.data):
            self._grow(max(16, 2 * len(self.data)))
        self.data[self.n] = v
        self.n += 1

    def extend(self, vals) -> None:
        vals = np.asarray(vals, dtype=np.uint8)
        need = self.n + len(vals)
        if need > len(self.data):
            self._grow(max(need, 2 * len(self.data)))
        self.data[self.n : need] = vals
        self.n = need

    def view(self) -> np.ndarray:
        return self.data[: self.n]


class BaseGraph:
    """Node-per-base DAG with embedded named paths (SoA layout)."""

    def __init__(self):
        self._labels = _GrowBufU8()
        self._efrom = _GrowBuf()
        self._eto = _GrowBuf()
        self._csr = None  # (indptr, indices) out-edges
        self._csc = None  # (indptr, indices) in-edges
        self._path_names: list[str] = []
        self._paths: list[_GrowBuf] = []
        self._name_to_id: dict[str, int] = {}

    # ---------------- nodes ----------------

    @property
    def node_size(self) -> int:
        return self._labels.n

    @property
    def labels(self) -> np.ndarray:
        return self._labels.view()

    def label(self, node_id: int) -> int:
        return int(self._labels.view()[node_id])

    def add_node(self, label: int) -> int:
        self._labels.append(label)
        return self._labels.n - 1

    def add_nodes(self, labels) -> np.ndarray:
        start = self._labels.n
        self._labels.extend(labels)
        return np.arange(start, self._labels.n, dtype=_I64)

    def relabel(self, node_id: int, label: int) -> None:
        self._labels.view()[node_id] = label

    # ---------------- edges ----------------

    @property
    def edge_count(self) -> int:
        return self._efrom.n

    def add_edge(self, node_from: int, node_to: int) -> None:
        self._efrom.append(node_from)
        self._eto.append(node_to)
        self._csr = self._csc = None

    def add_edges(self, efrom, eto) -> None:
        self._efrom.extend(efrom)
        self._eto.extend(eto)
        self._csr = self._csc = None

    def remove_edge(self, node_from: int, node_to: int) -> None:
        ef, et = self._efrom.view(), self._eto.view()
        hits = np.flatnonzero((ef == node_from) & (et == node_to))
        if len(hits) == 0:
            raise KeyError(f"no edge {node_from}->{node_to}")
        i = hits[0]
        # remove, preserving the order of the remaining edges
        ef[i:-1] = ef[i + 1 :].copy()
        et[i:-1] = et[i + 1 :].copy()
        self._efrom.n -= 1
        self._eto.n -= 1
        self._csr = self._csc = None

    def edges(self) -> tuple[np.ndarray, np.ndarray]:
        return self._efrom.view(), self._eto.view()

    def _build_csr(self):
        if self._csr is None:
            ef, et = self._efrom.view(), self._eto.view()
            order = np.argsort(ef, kind="stable")
            indptr = np.zeros(self.node_size + 1, dtype=_I64)
            np.cumsum(np.bincount(ef, minlength=self.node_size), out=indptr[1:])
            self._csr = (indptr, et[order])
        return self._csr

    def _build_csc(self):
        if self._csc is None:
            ef, et = self._efrom.view(), self._eto.view()
            order = np.argsort(et, kind="stable")
            indptr = np.zeros(self.node_size + 1, dtype=_I64)
            np.cumsum(np.bincount(et, minlength=self.node_size), out=indptr[1:])
            self._csc = (indptr, ef[order])
        return self._csc

    def next(self, node_id: int) -> np.ndarray:
        indptr, ind = self._build_csr()
        return ind[indptr[node_id] : indptr[node_id + 1]]

    def previous(self, node_id: int) -> np.ndarray:
        indptr, ind = self._build_csc()
        return ind[indptr[node_id] : indptr[node_id + 1]]

    def next_size(self, node_id: int) -> int:
        indptr, _ = self._build_csr()
        return int(indptr[node_id + 1] - indptr[node_id])

    def previous_size(self, node_id: int) -> int:
        indptr, _ = self._build_csc()
        return int(indptr[node_id + 1] - indptr[node_id])

    def next_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """(indptr, indices) of out-edges in per-node insertion order."""
        return self._build_csr()

    def prev_csr(self) -> tuple[np.ndarray, np.ndarray]:
        """(indptr, indices) of in-edges in per-node insertion order."""
        return self._build_csc()

    def out_degrees(self) -> np.ndarray:
        indptr, _ = self._build_csr()
        return np.diff(indptr)

    def in_degrees(self) -> np.ndarray:
        indptr, _ = self._build_csc()
        return np.diff(indptr)

    # ---------------- paths ----------------

    @property
    def path_size(self) -> int:
        return len(self._paths)

    def add_path(self, name: str) -> int:
        if name in self._name_to_id:
            raise ValueError(f"duplicate path name {name!r}")
        pid = len(self._paths)
        self._path_names.append(name)
        self._paths.append(_GrowBuf())
        self._name_to_id[name] = pid
        return pid

    def extend_path(self, path_id: int, node_id: int) -> None:
        self._paths[path_id].append(node_id)

    def extend_path_array(self, path_id: int, node_ids) -> None:
        self._paths[path_id].extend(node_ids)

    def pre_extend_path(self, path_id: int, node_id: int) -> None:
        buf = self._paths[path_id]
        new = _GrowBuf(max(16, buf.n + 1))
        new.append(node_id)
        new.extend(buf.view())
        self._paths[path_id] = new

    def reassign_subpath(self, path_id: int, offset: int, assignment) -> None:
        """Overwrite path[offset : offset+len(assignment)] with new node ids
        that carry identical labels (reference graph.hpp:121, src/graph.cpp:318;
        used by polish-time rewiring)."""
        assignment = np.asarray(assignment, dtype=_I64)
        path = self._paths[path_id].view()
        if offset + len(assignment) > len(path):
            raise ValueError("subpath reassignment exceeds path length")
        labels = self.labels
        if not np.array_equal(labels[assignment], labels[path[offset : offset + len(assignment)]]):
            raise ValueError("reassigned subpath does not match original labels")
        path[offset : offset + len(assignment)] = assignment

    def path(self, path_id: int) -> np.ndarray:
        return self._paths[path_id].view()

    def path_name(self, path_id: int) -> str:
        return self._path_names[path_id]

    def path_id(self, name: str) -> int:
        return self._name_to_id[name]

    def has_path(self, name: str) -> bool:
        return name in self._name_to_id

    # ---------------- algorithms ----------------

    def topological_order(self) -> np.ndarray:
        """A topological order of the nodes (Kahn, frontier-vectorized)."""
        from .graph_algs import topological_order

        return topological_order(self)

    def copy(self) -> "BaseGraph":
        g = BaseGraph()
        g._labels.extend(self.labels)
        ef, et = self.edges()
        g._efrom.extend(ef)
        g._eto.extend(et)
        for pid in range(self.path_size):
            g.add_path(self.path_name(pid))
            g.extend_path_array(pid, self.path(pid))
        return g

    def __repr__(self):
        return (
            f"BaseGraph(V={self.node_size}, E={self.edge_count}, "
            f"paths={self.path_size})"
        )

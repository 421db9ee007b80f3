"""Reachability oracle via path cover ("XMerge").

Equivalent of the reference's PathMerge (reference path_merge.hpp:20-280):
per-node, per-chain "last index on the chain that strictly precedes this
node" table, computed as dense numpy matrices (which is also the layout the
chaining device kernels consume). A sentinel pseudo-chain (src at 0, snk at
1) is appended when a tableau is given.

Follows centrolign_tpu/path_merge.py, without its post-switch distances:
the port's affine chaining measures gaps in its native engines.
"""

from __future__ import annotations

import numpy as np

_I64 = np.int64
MISSING = np.int64(-1)  # the reference uses UIntSize::max; -1 compares the
                        # same way under our signed max-DP (missing < any)


class PathMerge:
    def __init__(self, graph, tableau=None, use_native=True):
        V = graph.node_size
        P = graph.path_size
        extra = 1 if tableau is not None else 0
        self.num_chains = P + extra
        self.graph = graph
        if use_native:
            from .native import path_merge_build
            self.index_on, self.path_head, self.table = \
                path_merge_build(graph, tableau)
            self.tableau = tableau
            return

        # index_on[p][v]: index of v on path p, or -1
        self.index_on = np.full((self.num_chains, V), MISSING, dtype=_I64)
        # path_head[v]: highest-indexed chain containing v (reference
        # path_head semantics after its per-path overwrite loop), or -1
        self.path_head = np.full(V, MISSING, dtype=_I64)
        # table[v][p]: index of last node on chain p that strictly precedes v
        self.table = np.full((V, self.num_chains), MISSING, dtype=_I64)

        next_ptr, next_ind = graph.next_csr()
        for p in range(P):
            path = graph.path(p)
            self.index_on[p][path] = np.arange(len(path))
            self.path_head[path] = p
            # seed: successors of path[i] get table[., p] = i
            starts, ends = next_ptr[path], next_ptr[path + 1]
            counts = ends - starts
            if counts.sum():
                from .graph_algs import _multi_range
                targets = next_ind[_multi_range(starts, ends)]
                idxs = np.repeat(np.arange(len(path)), counts)
                # the largest path index wins (reference writes in order)
                np.maximum.at(self.table[:, p], targets, idxs)

        if not self._is_simple_chain(graph, tableau):
            # DP along topological order: table[v] = max(table[v], table[prev])
            order = graph.topological_order()
            prev_ptr, prev_ind = graph.prev_csr()
            for v in order:
                ps = prev_ind[prev_ptr[v]:prev_ptr[v + 1]]
                if len(ps):
                    self.table[v] = np.maximum(self.table[v],
                                               self.table[ps].max(axis=0))
        # (for a pure chain+sentinel graph the seeding already yields the
        # final table: each real node's only path predecessor feeds it
        # directly, and sentinels carry no path indices)

        if tableau is not None:
            pseudo = P
            self.index_on[pseudo][tableau.src_id] = 0
            self.index_on[pseudo][tableau.snk_id] = 1
            self.path_head[tableau.src_id] = pseudo
            self.path_head[tableau.snk_id] = pseudo
            self.table[:, pseudo] = 0
            self.table[tableau.src_id, pseudo] = MISSING
        self.tableau = tableau

    @staticmethod
    def _is_simple_chain(graph, tableau) -> bool:
        """True for a single-path chain wrapped in sentinels: node ids
        path[0..n), edges exactly path-consecutive plus the two sentinel
        edges. For these the topological DP is a no-op we can skip."""
        if tableau is None or graph.path_size != 1:
            return False
        p = graph.path(0)
        n = len(p)
        if n + 2 != graph.node_size or graph.edge_count != n + 1:
            return False
        ef, et = graph.edges()
        expect_f = np.concatenate((p[:-1], [tableau.src_id, p[-1]]))
        expect_t = np.concatenate((p[1:], [p[0], tableau.snk_id]))
        order1 = np.lexsort((et, ef))
        order2 = np.lexsort((expect_t, expect_f))
        return (np.array_equal(ef[order1], expect_f[order2])
                and np.array_equal(et[order1], expect_t[order2]))

    @property
    def chain_size(self) -> int:
        return self.num_chains

    def chains_on(self, v: int) -> np.ndarray:
        """All chains containing v, in the reference's order: path_head first
        (the highest chain), then descending (reference builds the linked
        list by per-path prepending, so it yields descending path ids)."""
        on = np.flatnonzero(self.index_on[:, v] != MISSING)
        return on[::-1]

    def predecessor_index(self, v: int, p: int) -> int:
        return int(self.table[v, p])

    def reachable(self, from_id: int, to_id: int) -> bool:
        cf = self.path_head[from_id]
        if cf == MISSING:
            return False
        idx_from = self.index_on[cf, from_id]
        last = self.table[to_id, cf]
        return last != MISSING and idx_from <= last

    def reachable_matrix(self, from_ids: np.ndarray, to_ids: np.ndarray) -> np.ndarray:
        """Vectorized: out[i, j] = reachable(from_ids[i], to_ids[j])."""
        cf = self.path_head[from_ids]
        ok = cf != MISSING
        cf_safe = np.where(ok, cf, 0)
        idx_from = self.index_on[cf_safe, from_ids]
        last = self.table[np.asarray(to_ids)[None, :], cf_safe[:, None]]
        return ok[:, None] & (last != MISSING) & (idx_from[:, None] <= last)


class ChainMerge:
    """Reachability oracle via chain decomposition (reference
    chain_merge.hpp:19,96-178): each node belongs to exactly one chain
    (first path to cover it); the reference uses this during calibration."""

    def __init__(self, graph, tableau=None):
        V = graph.node_size
        P = graph.path_size
        extra = 1 if tableau is not None else 0
        self.num_chains = P + extra
        self.graph = graph
        from .native import chain_merge_build
        self.chain_id, self.chain_index, self.table = \
            chain_merge_build(graph, tableau)
        # chains in the unified layout: first covering path wins per node
        self.chains = []
        for p in range(P):
            path = graph.path(p)
            keep = self.chain_id[path] == p
            self.chains.append(np.asarray(path[keep], dtype=_I64))
        if tableau is not None:
            self.chains.append(np.array([tableau.src_id, tableau.snk_id],
                                        dtype=_I64))

        # index_on in the unified layout
        self.index_on = np.full((self.num_chains, V), MISSING, dtype=_I64)
        ok = self.chain_id != MISSING
        self.index_on[self.chain_id[ok], np.flatnonzero(ok)] = \
            self.chain_index[ok]

    # unified-view accessors (same API subset as PathMerge)
    @property
    def path_head(self):
        return self.chain_id

    def chain_size(self):
        return self.num_chains

    def reachable(self, from_id: int, to_id: int) -> bool:
        cf = self.chain_id[from_id]
        if cf == MISSING:
            return False
        last = self.table[to_id, cf]
        return last != MISSING and self.chain_index[from_id] <= last


def xmerge_view_arrays(xm):
    """Flattened arrays of a PathMerge/ChainMerge for the native parity
    engine: (table (V,C), index_on (C,V), chain_id (V,), chain_offsets,
    chain_nodes)."""
    table = np.ascontiguousarray(xm.table)
    index_on = np.ascontiguousarray(xm.index_on)
    if hasattr(xm, "chains"):  # ChainMerge
        chain_id = np.ascontiguousarray(xm.chain_id, dtype=_I64)
        chains = xm.chains
    else:  # PathMerge: chains are the paths (+ pseudo sentinel chain)
        chain_id = np.ascontiguousarray(xm.path_head, dtype=_I64)
        g = xm.graph
        chains = [g.path(p) for p in range(g.path_size)]
        if xm.num_chains > g.path_size:
            chains.append(np.array([xm.tableau.src_id, xm.tableau.snk_id],
                                   dtype=_I64))
    offsets = np.zeros(len(chains) + 1, dtype=_I64)
    np.cumsum([len(c) for c in chains], out=offsets[1:])
    nodes = (np.concatenate(chains).astype(_I64) if chains
             else np.empty(0, dtype=_I64))
    return table, index_on, chain_id, offsets, nodes


class PackedPathMerge(PathMerge):
    """PathMerge over bit-packed storage, selected when the table footprint
    exceeds ``memory_restraint_size`` (reference packed_path_merge.hpp:23,
    chosen at core.hpp:310-327). The (V, C) reachability tables are held as
    page-anchored packed difference vectors (utils/packed.py) — the
    architecture-appropriate analog of the reference's PackedVector/
    PagedVector tiers. Python-side queries read the packed words directly;
    the native engines consume flat int32 views that are materialized on
    demand and dropped with release() after each pipeline stage, so the
    packed form bounds the resident footprint between native calls."""

    def __init__(self, graph, tableau=None):
        # deliberately does not chain to PathMerge.__init__: table/index_on
        # are properties here (query methods are inherited)
        from .native import path_merge_build
        from .utils.packed import PagedVector
        index_on, path_head, table = path_merge_build(graph, tableau)
        self.num_chains = table.shape[1]
        self.graph = graph
        self.tableau = tableau
        self.path_head = path_head
        self._shape_table = table.shape
        self._shape_io = index_on.shape
        self._table_packed = PagedVector(np.asarray(table).ravel())
        self._io_packed = PagedVector(np.asarray(index_on).ravel())
        self._table_cache = None
        self._io_cache = None

    @property
    def table(self):
        if self._table_cache is None:
            self._table_cache = self._table_packed.to_array().astype(
                np.int32).reshape(self._shape_table)
        return self._table_cache

    @property
    def index_on(self):
        if self._io_cache is None:
            self._io_cache = self._io_packed.to_array().astype(
                np.int32).reshape(self._shape_io)
        return self._io_cache

    def release(self) -> None:
        """Drop the materialized dense views (packed storage remains)."""
        self._table_cache = None
        self._io_cache = None

    def memory_bytes(self) -> int:
        return (self._table_packed.memory_bytes()
                + self._io_packed.memory_bytes())

    def reachable(self, from_id: int, to_id: int) -> bool:
        cf = self.path_head[from_id]
        if cf == MISSING:
            return False
        C = self._shape_table[1]
        last = int(self._table_packed[to_id * C + cf])
        if last == MISSING:
            return False
        V = self._shape_io[1]
        return int(self._io_packed[cf * V + from_id]) <= last

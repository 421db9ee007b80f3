"""Constant/log-time range query structures (reference
range_min_query.hpp:18, range_unique_query.hpp:27,
tree_distance_oracle.hpp:16).

RMQ is the Fischer-Heun scheme: block decomposition, a sparse table over
block minima for O(1) inter-block queries, and per-block Cartesian-tree
signatures sharing precomputed in-block tables. RUQ answers
number-of-distinct-values-in-range through a mergesort tree over
next-occurrence indices. TreeDistanceOracle answers tree path distances in
O(1) via an Euler-tour LCA reduction onto the RMQ plus root-distance sums.

Copy of centrolign_tpu/utils/queries.py.
"""

from __future__ import annotations

import numpy as np

_I64 = np.int64


class RMQ:
    """O(n) build / O(1) range-arg-min (reference range_min_query.hpp:18,
    Fischer-Heun)."""

    def __init__(self, arr):
        arr = np.asarray(arr)
        self.arr = arr
        n = len(arr)
        self.n = n
        if n == 0:
            return
        b = max(1, (max(n.bit_length(), 4)) // 4)  # block size ~ log(n)/4
        self.block = b
        nb = (n + b - 1) // b
        pad = nb * b - n
        # pad with +inf so padded cells never win
        if np.issubdtype(arr.dtype, np.integer):
            big = np.iinfo(arr.dtype).max
        else:
            big = np.inf
        padded = np.concatenate([arr, np.full(pad, big, dtype=arr.dtype)])
        blocks = padded.reshape(nb, b)
        in_block_argmin = blocks.argmin(axis=1)
        self.block_min_pos = in_block_argmin + np.arange(nb) * b
        block_min = padded[self.block_min_pos]
        # sparse table over block minima
        K = max(1, nb.bit_length())
        table = np.empty((K, nb), dtype=_I64)
        table[0] = self.block_min_pos
        span = 1
        for k in range(1, K):
            prev = table[k - 1]
            m = nb - 2 * span
            if m > 0:
                left = prev[:m]
                right = prev[span:span + m]
                take_right = self.arr_at(right) < self.arr_at(left)
                table[k, :m] = np.where(take_right, right, left)
            table[k, max(m, 0):] = prev[max(m, 0):]
            span *= 2
        self.sparse = table
        # per-block Cartesian signatures -> shared in-block argmin tables
        self._sig_tables = {}
        self._block_sigs = np.empty(nb, dtype=np.int64)
        for i in range(nb):
            sig = self._cartesian_signature(blocks[i])
            self._block_sigs[i] = sig
            if sig not in self._sig_tables:
                self._sig_tables[sig] = self._build_in_block(blocks[i])

    def arr_at(self, idx):
        return self.arr[np.minimum(idx, self.n - 1)]

    @staticmethod
    def _cartesian_signature(block) -> int:
        sig = 0
        stack = []
        for v in block:
            while stack and stack[-1] > v:
                stack.pop()
                sig = sig << 1
            stack.append(v)
            sig = (sig << 1) | 1
        return sig

    @staticmethod
    def _build_in_block(block):
        b = len(block)
        out = np.empty((b, b), dtype=np.int64)
        for i in range(b):
            best = i
            out[i, i] = i
            for j in range(i + 1, b):
                if block[j] < block[best]:
                    best = j
                out[i, j] = best
        return out

    def range_arg_min(self, begin: int, end: int) -> int:
        """argmin over [begin, end); first minimum wins (reference ties)."""
        assert 0 <= begin < end <= self.n
        b = self.block
        bi, bj = begin // b, (end - 1) // b
        if bi == bj:
            tab = self._sig_tables[self._block_sigs[bi]]
            return bi * b + int(tab[begin - bi * b, (end - 1) - bi * b])
        tab_i = self._sig_tables[self._block_sigs[bi]]
        left = bi * b + int(tab_i[begin - bi * b, b - 1])
        tab_j = self._sig_tables[self._block_sigs[bj]]
        right = bj * b + int(tab_j[0, (end - 1) - bj * b])
        # first-minimum-wins: scan the segments left to right, replacing
        # only on strict improvement
        best = left
        if bj - bi > 1:
            lo, hi = bi + 1, bj  # blocks [lo, hi)
            k = (hi - lo).bit_length() - 1
            a = int(self.sparse[k, lo])
            c = int(self.sparse[k, hi - (1 << k)])
            mid = a if self.arr[a] <= self.arr[c] else c
            if self.arr[mid] < self.arr[best]:
                best = mid
        if self.arr[right] < self.arr[best]:
            best = right
        return int(best)


class RUQ:
    """Number of distinct values in a half-open range: O(n log n) build,
    O(log^2 n) query (reference range_unique_query.hpp:27; the reference
    adds fractional cascading for O(log n) — contract and results are
    identical). A value is counted at its last occurrence inside the range:
    distinct = #{i in [b,e) : next_occ[i] >= e}."""

    def __init__(self, arr):
        arr = np.asarray(arr)
        n = len(arr)
        self.n = n
        next_occ = np.full(n, n, dtype=_I64)
        last = {}
        for i in range(n - 1, -1, -1):
            v = int(arr[i]) if arr.ndim == 1 else tuple(arr[i])
            nxt = last.get(v)
            if nxt is not None:
                next_occ[i] = nxt
            last[v] = i
        # mergesort tree: levels[k] holds each aligned 2^k segment sorted
        self.levels = [next_occ.copy()]
        k = 0
        while (1 << k) < n:
            k += 1
            seg = 1 << k
            level = self.levels[-1].copy()
            for s in range(0, n, seg):
                e = min(s + seg, n)
                level[s:e] = np.sort(level[s:e])
            self.levels.append(level)

    def range_unique(self, begin: int, end: int) -> int:
        if begin >= end:
            return 0
        count = 0
        i = begin
        while i < end:
            k = 0
            while (i % (1 << (k + 1)) == 0 and i + (1 << (k + 1)) <= end
                   and (k + 1) < len(self.levels)):
                k += 1
            seg = 1 << k
            level = self.levels[k]
            s, e = i, min(i + seg, self.n)
            count += (e - s) - int(np.searchsorted(level[s:e], end,
                                                   side="left"))
            i += seg
        return count


class TreeDistanceOracle:
    """O(1) tree path distances (reference tree_distance_oracle.hpp:16):
    Euler tour + depth RMQ for LCA, plus root-distance prefix sums."""

    def __init__(self, tree):
        n = tree.node_size
        self.root_dist = np.zeros(n, dtype=np.float64)
        euler = []
        depth = []
        self.first = np.full(n, -1, dtype=_I64)
        root = tree.get_root()
        stack = [(root, 0, iter(tree.get_children(root)))]
        self.root_dist[root] = 0.0
        order = []
        while stack:
            node, d, it = stack[-1]
            if self.first[node] == -1:
                self.first[node] = len(euler)
            euler.append(node)
            depth.append(d)
            child = next(it, None)
            if child is None:
                stack.pop()
                continue
            self.root_dist[child] = self.root_dist[node] + tree.distance(child)
            stack.append((child, d + 1, iter(tree.get_children(child))))
        self.euler = np.asarray(euler, dtype=_I64)
        self.rmq = RMQ(np.asarray(depth, dtype=_I64))

    def lca(self, a: int, b: int) -> int:
        i, j = int(self.first[a]), int(self.first[b])
        if i > j:
            i, j = j, i
        return int(self.euler[self.rmq.range_arg_min(i, j + 1)])

    def distance(self, a: int, b: int) -> float:
        c = self.lca(a, b)
        return (self.root_dist[a] + self.root_dist[b]
                - 2.0 * self.root_dist[c])

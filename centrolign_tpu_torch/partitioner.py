"""Partition an anchor chain into well-anchored ("alignable") segments.

Behavioral equivalent of the reference Partitioner (reference
partitioner.hpp:16-690):

- anchor scores are count-discounted by the number of anchors the chain used
  from the same match set (partitioner.hpp:92-101)
- between-anchor gap lengths are the Holder generalized mean (p = -0.5) of
  the two graphs' min source->sink distances (partitioner.hpp:124-146)
- three partition DPs: maximum_weight_partition (score - min_score per
  segment), average_constrained_partition (each segment's average score per
  unit length >= min_average), window_average_constrained_partition (the
  windowed average over every window inside a segment >= min_average)
- all DPs share the traceback over (excluded, included) state pairs
  (partition_client.hpp:14-53)

Copy of centrolign_tpu/partitioner.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .score_function import ScoreFunction
from .extractor import extract_graphs_between, source_sink_minmax

_MININF = -np.inf


class MaxTree:
    """Static-key ordered max map: point update, range max over [lo, hi).
    Keys are (float, int) pairs; equivalent to the reference MaxSearchTree
    (max_search_tree.hpp:16)."""

    def __init__(self, keys):
        self.keys = sorted(keys)
        self.pos = {k: i for i, k in enumerate(self.keys)}
        n = max(1, len(self.keys))
        self.n = n
        self.vals = [(_MININF, None)] * (2 * n)

    def update(self, key, value):
        i = self.pos[key] + self.n
        self.vals[i] = (value, key)
        i >>= 1
        while i:
            self.vals[i] = max(self.vals[2 * i], self.vals[2 * i + 1],
                               key=lambda kv: kv[0])
            i >>= 1

    def range_max(self, lo, hi):
        """Max (value, key) over keys in [lo, hi); returns (value, key) or
        (-inf, None)."""
        import bisect
        l = bisect.bisect_left(self.keys, lo) + self.n
        r = bisect.bisect_left(self.keys, hi) + self.n
        best = (_MININF, None)
        while l < r:
            if l & 1:
                if self.vals[l][0] > best[0]:
                    best = self.vals[l]
                l += 1
            if r & 1:
                r -= 1
                if self.vals[r][0] > best[0]:
                    best = self.vals[r]
            l >>= 1
            r >>= 1
        return best


def generalized_mean(values, p: float) -> float:
    """Holder mean (reference utility.hpp:264-285)."""
    vals = np.asarray(values, dtype=np.float64)
    if p == 0.0:
        return float(np.exp(np.mean(np.log(vals))))
    return float(np.mean(vals ** p) ** (1.0 / p))


def _shared_traceback(dp, backpointer, tb_idx):
    """(reference partition_client.hpp:29-53)"""
    partition = []
    in_interval = True
    while tb_idx > 0:
        if in_interval:
            prev = backpointer[tb_idx]
            partition.append((prev, tb_idx))
            tb_idx = prev
            in_interval = False
        else:
            in_interval = dp[tb_idx][0] == dp[tb_idx - 1][1]
            tb_idx -= 1
    partition.reverse()
    return partition


@dataclass
class Partitioner:
    score_function: ScoreFunction = field(default_factory=ScoreFunction)
    constraint_method: str = "MinWindowAverage"  # Null | Unconstrained | MinAverage | MinWindowAverage
    minimum_segment_score: float = 15000.0
    minimum_segment_average: float = 0.1
    window_length: float = 10000.0
    generalized_length_mean: float = -0.5
    boundary_score_factor: float = 0.95

    def partition_anchors(self, anchor_chain, graph1, graph2, tableau1,
                          tableau2, xmerge1, xmerge2, score_boundaries,
                          use_annotated_score=False):
        """(reference partitioner.hpp:72-215)"""
        num_from_set = {}
        if not use_annotated_score:
            for a in anchor_chain:
                num_from_set[a.match_set] = num_from_set.get(a.match_set, 0) + 1

        def anchor_score(a):
            if use_annotated_score:
                return a.score
            n = num_from_set[a.match_set]
            return self.score_function.anchor_weight(
                a.count1 - n + 1, a.count2 - n + 1, len(a.walk1), a.full_length)

        if self.constraint_method == "Null":
            partition = [(0, len(anchor_chain))]
        elif self.constraint_method == "Unconstrained":
            data = [anchor_score(a) for a in anchor_chain]
            partition = self.maximum_weight_partition(data, score_boundaries)
        else:
            graphs_between = extract_graphs_between(
                anchor_chain, graph1, graph2, tableau1, tableau2,
                xmerge1, xmerge2)
            data = []
            for i in range(len(anchor_chain) + len(graphs_between)):
                if i % 2 == 0:
                    pair = graphs_between[i // 2]
                    sizes = []
                    for sub in pair:
                        if sub.subgraph.node_size == 0:
                            sizes.append(0.00001)
                        else:
                            sizes.append(source_sink_minmax(sub)[0] + 1)
                    data.append((0.0, generalized_mean(
                        sizes, self.generalized_length_mean)))
                else:
                    a = anchor_chain[i // 2]
                    data.append((anchor_score(a), float(len(a.walk1))))
            if self.constraint_method == "MinAverage":
                partition = self.average_constrained_partition(data, score_boundaries)
            elif self.constraint_method == "MinWindowAverage":
                partition = self.window_average_constrained_partition(data, score_boundaries)
            else:
                raise ValueError(self.constraint_method)
            partition = [(b // 2, min((e + 1) // 2, len(anchor_chain)))
                         for (b, e) in partition]
            if len(partition) == 1 and partition[0][0] == partition[0][1]:
                partition = []

        return [[anchor_chain[i] for i in range(b, e)] for (b, e) in partition]

    # ------------------------------------------------------------------

    def maximum_weight_partition(self, data, score_boundaries=False):
        """(reference partitioner.hpp:216-270)"""
        min_score = self.minimum_segment_score * self.score_function.score_scale

        def adj(i):
            s = data[i]
            if score_boundaries:
                if i == 0:
                    s += self.boundary_score_factor * min_score
                if i + 1 == len(data):
                    s += self.boundary_score_factor * min_score
            return s

        n = len(data)
        prefix = [0.0] * (n + 1)
        for i in range(n):
            prefix[i + 1] = prefix[i] + adj(i)
        dp = [(_MININF, _MININF)] * (n + 1)
        bp = [-1] * (n + 1)
        dp[0] = (0.0, 0.0)
        prefix_argmax = 0
        tb_idx = 0
        for i in range(1, n + 1):
            excl = max(dp[i - 1][0], dp[i - 1][1])
            incl = dp[prefix_argmax][0] + prefix[i] - prefix[prefix_argmax] - min_score
            dp[i] = (excl, incl)
            bp[i] = prefix_argmax
            if excl - prefix[i] > dp[prefix_argmax][0] - prefix[prefix_argmax]:
                prefix_argmax = i
            if incl > dp[tb_idx][1]:
                tb_idx = i
        return _shared_traceback(dp, bp, tb_idx)

    def average_constrained_partition(self, data, score_boundaries=False):
        """(reference partitioner.hpp:273-356)"""
        sf = self.score_function
        min_score = self.minimum_segment_score * sf.score_scale
        min_average = self.minimum_segment_average * sf.score_scale
        n = len(data)

        def adj(i):
            s = data[i][0]
            if score_boundaries:
                if i == 0:
                    s += self.boundary_score_factor * min_score
                if i + 1 == n:
                    s += self.boundary_score_factor * min_score
            return s

        prefix = [0.0] * n
        frac = [0.0] * n
        if n:
            prefix[0] = data[0][0]
            frac[0] = data[0][0] - data[0][1] * min_average
        for i in range(1, n):
            prefix[i] = prefix[i - 1] + adj(i)
            frac[i] = frac[i - 1] + adj(i) - data[i][1] * min_average

        dp = [(_MININF, _MININF)] * (n + 1)
        bp = [-1] * (n + 1)
        dp[0] = (0.0, 0.0)
        keys = [(frac[i], i + 1) for i in range(n)] + [(0.0, 0)]
        tree = MaxTree(keys)
        tree.update((0.0, 0), 0.0)
        opt_idx = 0
        for i in range(1, n + 1):
            excl = max(dp[i - 1][0], dp[i - 1][1])
            incl = dp[i][1]
            bpi = bp[i]
            v, key = tree.range_max((_MININF, 0), (frac[i - 1], 2**63 - 1))
            if key is not None and v != _MININF:
                incl = prefix[i - 1] + v - min_score
                bpi = key[1]
            dp[i] = (excl, incl)
            bp[i] = bpi
            if incl > dp[opt_idx][1]:
                opt_idx = i
            tree.update((frac[i - 1], i), excl - prefix[i - 1])
        return _shared_traceback(dp, bp, opt_idx)

    def window_average_constrained_partition(self, data, score_boundaries=False):
        """(reference partitioner.hpp:358-683)"""
        sf = self.score_function
        min_score = self.minimum_segment_score * sf.score_scale
        min_average = self.minimum_segment_average * sf.score_scale
        n = len(data)
        window_length = self.window_length

        def adj(i):
            s = data[i][0]
            if score_boundaries:
                if i == 0:
                    s += self.boundary_score_factor * min_score
                if i + 1 == n:
                    s += self.boundary_score_factor * min_score
            return s

        meets_left = [False] * n
        meets_right = [False] * n
        rightward_partner = [0] * n
        leftward_partner = [0] * n
        for forward in (True, False):
            window_score = 0.0
            window_weight = 0.0
            end = 0 if forward else n - 1
            incr = 1 if forward else -1
            meets = meets_left if forward else meets_right
            partner = rightward_partner if forward else leftward_partner
            i = end
            while 0 <= i < n:
                while 0 <= end < n and window_weight < window_length:
                    window_score += adj(end)
                    window_weight += data[end][1]
                    end += incr
                partner[i] = end
                if (end < 0 or end >= n) and window_weight < window_length:
                    if 0 <= i - incr < n:
                        meets[i] = meets[i - incr]
                    else:
                        meets[i] = window_score >= min_average * window_weight
                else:
                    # note: the reference reads the *unadjusted* data here
                    fs, fw = data[end - incr]
                    meets[i] = (fw * window_score
                                + (window_length - window_weight) * fs
                                >= fw * min_average * window_length)
                window_score -= adj(i)
                window_weight -= data[i][1]
                i += incr

        prefix = [0.0] * (n + 1)
        frac = [0.0] * (n + 1)
        left_cps = [0] * (n + 1)
        right_cps = [0] * (n + 1)
        for i in range(n):
            prefix[i + 1] = prefix[i] + adj(i)
            frac[i + 1] = frac[i] + adj(i) - data[i][1] * min_average
            left_cps[i + 1] = left_cps[i] + (0 if meets_left[i] else 1)
            right_cps[i + 1] = right_cps[i] + (0 if meets_right[i] else 1)

        keys = [(frac[i], i) for i in range(n + 1)]
        tree = MaxTree(keys)
        tree.update((frac[0], 0), 0.0)

        dp = [(_MININF, _MININF)] * (n + 1)
        bp = [-1] * (n + 1)
        dp[0] = (0.0, 0.0)
        tb_idx = 0
        window_begin = 0
        window_weight = 0.0
        outside_argmax = -1
        argmax_partner = -1
        k = 0
        l = 0
        final_l = n
        tail_weight = 0.0
        while final_l != 0 and tail_weight + data[final_l - 1][1] < window_length:
            tail_weight += data[final_l - 1][1]
            final_l -= 1

        for i in range(1, n + 1):
            while l < final_l and rightward_partner[l] <= i:
                l += 1
            if outside_argmax != -1 and (
                    left_cps[outside_argmax] != left_cps[l]
                    or right_cps[argmax_partner] != right_cps[i]):
                outside_argmax = -1
            window_weight += data[i - 1][1]
            while window_begin < n and window_weight > window_length:
                window_weight -= data[window_begin][1]
                j = window_begin
                tree.update((frac[j], j), _MININF)
                while k < n and leftward_partner[k] + 1 < j:
                    k += 1
                if (left_cps[j] == left_cps[l] and right_cps[k] == right_cps[i]) and (
                        outside_argmax == -1
                        or dp[j][0] - prefix[j] > dp[outside_argmax][0] - prefix[outside_argmax]):
                    outside_argmax = j
                    argmax_partner = k
                window_begin += 1

            excl = max(dp[i - 1][0], dp[i - 1][1])
            dp[i] = (excl, dp[i][1])
            incl = _MININF
            bpi = -1
            v, key = tree.range_max((_MININF, 0), (frac[i], 2**63 - 1))
            if key is not None and v != _MININF:
                incl = prefix[i] + v - min_score
                bpi = key[1]
            if outside_argmax != -1:
                outside_score = (dp[outside_argmax][0] + prefix[i]
                                 - prefix[outside_argmax] - min_score)
                if outside_score > incl:
                    incl = outside_score
                    bpi = outside_argmax
            dp[i] = (excl, incl)
            bp[i] = bpi
            if incl > dp[tb_idx][1]:
                tb_idx = i
            tree.update((frac[i], i), excl - prefix[i])

        return _shared_traceback(dp, bp, tb_idx)

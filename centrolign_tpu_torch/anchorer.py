"""Anchor chaining: select a mutually-reachable, maximum-weight chain of
match walks across the two graphs.

Semantics follow the reference Anchorer (reference anchorer.hpp:127-2548):

- anchors are (match set, walk1 idx, walk2 idx) triples; anchor weight is the
  score function applied to (count1, count2, length, full_length)
- chains must be strictly reachable in BOTH graphs between consecutive
  anchors (reachability via the PathMerge oracle)
- with global anchoring, the chain must connect a source pair (successors of
  the source sentinels) to a sink pair (predecessors of the sink sentinels)
  (anchorer.hpp:1050-1089)
- with affine gap scoring, edges cost the best piecewise-affine component of
  the measured gap |dist1 - dist2|, where dist is measured via chain indices
  plus post-switch distances (anchorer.hpp:2551-2581); the scale multiplies
  the gap penalty and is auto-calibrated by chaining once without gap costs
  (estimate_score_scale, anchorer.hpp:998-1047)
- the match-pair budget keeps whole match sets in decreasing full-length
  weight order until max_num_match_pairs is reached (anchorer.hpp:1108-1173)

This module implements the chain DP dense-vectorized over anchors x anchors
(the semantics twin of the reference's exhaustive_chain_dp, anchorer.hpp:1342;
the reference's sparse algorithms compute the same optimum). The dense
formulation is also the shape that maps onto the TPU: reachability and gap
matrices are plain gathers + elementwise max-plus sweeps.

Copy of centrolign_tpu/anchorer.py, without the opt-in device branches
of _cdq_values and of sparse chaining (CENTROLIGN_TPU_DEVICE_CDQ and
CENTROLIGN_TPU_DEVICE_CHAIN), which are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .score_function import ScoreFunction
from .path_merge import PathMerge, PostSwitchDistances

_I64 = np.int64
_LOWEST = -np.inf


@dataclass
class Anchor:
    """One chained anchor (reference anchor_t, anchorer.hpp:36-57)."""

    walk1: np.ndarray
    walk2: np.ndarray
    count1: int
    count2: int
    full_length: int
    score: float = 0.0
    gap_before: int = 0
    gap_after: int = 0
    gap_score_before: float = 0.0
    gap_score_after: float = 0.0
    match_set: int = -1
    idx1: int = -1
    idx2: int = -1


class ChainAlgorithm:
    Exhaustive = 0
    Sparse = 1
    SparseAffine = 2


class _PSDView:
    """PostSwitchDistances-compatible view over a native (C, V) D array."""

    HUGE = np.int64(2**62)

    def __init__(self, distances):
        self.distances = distances

    def distance(self, v, p):
        d = self.distances[p, v]
        return int(d) if d != 0 else int(self.HUGE)


def _native_psd(graph, xmerge):
    try:
        from .native import psd_build
    except Exception:
        return PostSwitchDistances(graph, xmerge)
    p_ptr, p_ind = graph.prev_csr()
    D = psd_build(graph.topological_order(), p_ptr, p_ind,
                  xmerge.index_on, xmerge.table)
    return _PSDView(D)


@dataclass
class Anchorer:
    score_function: ScoreFunction = field(default_factory=ScoreFunction)
    chaining_algorithm: int = ChainAlgorithm.SparseAffine
    max_num_match_pairs: int = 1250000
    gap_open: tuple = (1.25, 50.0, 5000.0)
    gap_extend: tuple = (2.5, 0.1, 0.0015)
    global_anchoring: bool = True
    do_fill_in_anchoring: bool = True
    split_matches_at_branchpoints: bool = True
    autocalibrate_gap_penalties: bool = True
    anchor_split_limit: int = 5
    min_split_length: int = 128
    min_path_length_spread: int = 50
    max_split_match_set_size: int = 16

    # ------------------------------------------------------------------

    def anchor_weight(self, anchor: Anchor) -> float:
        return self.score_function.anchor_weight(
            anchor.count1, anchor.count2, len(anchor.walk1), anchor.full_length)

    def anchor_chain(self, matches, graph1, graph2, tableau1, tableau2,
                     xmerge1: PathMerge, xmerge2: PathMerge,
                     masked_matches=None, override_scale=None):
        """Top-level chaining (reference anchorer.hpp:958-996). ``matches``
        may be reordered in place (budgeting)."""
        if self.split_matches_at_branchpoints:
            self.split_branching_matches(
                matches, graph1, graph2, tableau1, tableau2, masked_matches)
        scale = 1.0
        from .utils.memory import log_memory_usage
        from . import logging as logmod
        if override_scale is not None:
            scale = override_scale
        elif (self.chaining_algorithm == ChainAlgorithm.SparseAffine
              and self.autocalibrate_gap_penalties):
            scale = self.estimate_score_scale(
                matches, graph1, graph2, tableau1, tableau2, xmerge1, xmerge2,
                masked_matches=masked_matches)
            log_memory_usage(logmod.Debug)
        log_memory_usage(logmod.Debug)
        return self._anchor_chain_global(
            matches, graph1, graph2, tableau1, tableau2, xmerge1, xmerge2,
            self.chaining_algorithm, scale, masked_matches)

    def split_branching_matches(self, matches, graph1, graph2, tableau1,
                                tableau2, masked_matches=None):
        """Split long anchors at superbubble boundaries with high path-length
        spread (reference anchorer.hpp:803-956)."""
        if self.anchor_split_limit == 0:
            return
        from .native import SuperbubbleTree
        from .match_finder import MatchSet

        set_masked = {}
        if masked_matches:
            for (s_, i_, j_) in masked_matches:
                set_masked.setdefault(s_, []).append((i_, j_))

        bubbles1 = SuperbubbleTree(graph1, tableau1)
        bubbles2 = SuperbubbleTree(graph2, tableau2)

        def spread_branch_end(tree, node):
            bid = tree.structure_ending_at(node)
            if bid == -1:
                return False
            mn, mx = tree.structure_min_max_dist(bid)
            return mx - mn >= self.min_path_length_spread

        def spread_branch_begin(tree, node):
            bid = tree.structure_beginning_at(node)
            if bid == -1:
                return False
            mn, mx = tree.structure_min_max_dist(bid)
            return mx - mn >= self.min_path_length_spread

        num_original = len(matches)
        for si in range(num_original):
            ms = matches[si]
            L = ms.walks1.shape[1]
            if (len(ms.walks1) * len(ms.walks2) > self.max_split_match_set_size
                    or L < self.min_split_length):
                continue
            division_idxs = []
            j = 0
            while j < L:
                if (j == self.anchor_split_limit
                        and j + self.anchor_split_limit < L):
                    j = L - self.anchor_split_limit
                if j != 0 and (not division_idxs or division_idxs[-1] != j):
                    found = any(
                        spread_branch_end(bubbles1, int(w[j]))
                        for w in ms.walks1) or any(
                        spread_branch_end(bubbles2, int(w[j]))
                        for w in ms.walks2)
                    if found:
                        division_idxs.append(j)
                if j + 1 != L:
                    found = any(
                        spread_branch_begin(bubbles1, int(w[j]))
                        for w in ms.walks1) or any(
                        spread_branch_begin(bubbles2, int(w[j]))
                        for w in ms.walks2)
                    if found:
                        division_idxs.append(j + 1)
                j += 1
            if not division_idxs:
                continue
            end = L
            for div in reversed(division_idxs):
                if masked_matches and si in set_masked:
                    for (mi, mj) in set_masked[si]:
                        masked_matches.add((len(matches), mi, mj))
                matches.append(MatchSet(
                    walks1=ms.walks1[:, div:end].copy(),
                    walks2=ms.walks2[:, div:end].copy(),
                    count1=ms.count1, count2=ms.count2,
                    full_length=ms.full_length))
                end = div
            ms.walks1 = ms.walks1[:, :division_idxs[0]].copy()
            ms.walks2 = ms.walks2[:, :division_idxs[0]].copy()

    def estimate_score_scale(self, matches, graph1, graph2, tableau1, tableau2,
                             xmerge1, xmerge2, masked_matches=None,
                             chain_out=None) -> float:
        """Chain once without gap penalties, then weight / anchored length
        (reference anchorer.hpp:998-1047)."""
        anchors = self._anchor_chain_global(
            matches, graph1, graph2, tableau1, tableau2, xmerge1, xmerge2,
            ChainAlgorithm.Sparse, 1.0, masked_matches)
        total_weight = sum(self.anchor_weight(a) for a in anchors)
        total_length = sum(len(a.walk1) for a in anchors)
        total_length += self._fill_in_length(
            anchors, graph1, graph2, tableau1, tableau2, xmerge1, xmerge2)
        if chain_out is not None:
            chain_out.extend(anchors)
        return total_weight / total_length if total_length else 1.0

    def _fill_in_length(self, anchors, graph1, graph2, tableau1, tableau2,
                        xmerge1, xmerge2):
        """Sum of min source->sink distances of the between-anchor
        extractions (the length denominator of estimate_score_scale)."""
        import os
        if (tableau1 is not None
                and os.environ.get("CENTROLIGN_TPU_PY_FILLIN") != "1"):
            try:
                from .native import chain_fill_length
            except Exception:
                chain_fill_length = None
            if chain_fill_length is not None:
                A = len(anchors)
                eps = np.empty((A + 1, 4), dtype=_I64)
                if A == 0:
                    eps[0] = (tableau1.src_id, tableau1.snk_id,
                              tableau2.src_id, tableau2.snk_id)
                else:
                    eps[0] = (tableau1.src_id, anchors[0].walk1[0],
                              tableau2.src_id, anchors[0].walk2[0])
                    for i in range(1, A):
                        eps[i] = (anchors[i - 1].walk1[-1],
                                  anchors[i].walk1[0],
                                  anchors[i - 1].walk2[-1],
                                  anchors[i].walk2[0])
                    eps[A] = (anchors[-1].walk1[-1], tableau1.snk_id,
                              anchors[-1].walk2[-1], tableau2.snk_id)
                return chain_fill_length(graph1, graph2, xmerge1, xmerge2,
                                         eps)
        from .extractor import extract_graphs_between, source_sink_minmax
        fill_in = extract_graphs_between(
            anchors, graph1, graph2, tableau1, tableau2, xmerge1, xmerge2)
        total = 0
        for sub1, sub2 in fill_in:
            fill_len = None
            for sub in (sub1, sub2):
                if sub.subgraph.node_size == 0:
                    fill_len = 0
                    break
                d = source_sink_minmax(sub)[0]
                fill_len = d if fill_len is None else min(fill_len, d)
            total += fill_len
        return total

    # ------------------------------------------------------------------

    def _anchor_chain_global(self, matches, graph1, graph2, tableau1, tableau2,
                             xmerge1, xmerge2, algorithm, scale,
                             masked_matches):
        if self.global_anchoring:
            sources1 = graph1.next(tableau1.src_id)
            sources2 = graph2.next(tableau2.src_id)
            sinks1 = graph1.previous(tableau1.snk_id)
            sinks2 = graph2.previous(tableau2.snk_id)
        else:
            sources1 = sources2 = sinks1 = sinks2 = None
        # scale-adjusted budget (anchorer.hpp:1066-1068)
        budget = min(
            int(round((scale / self.score_function.score_scale)
                      * self.max_num_match_pairs)),
            self.max_num_match_pairs)
        anchors = self._chain_core(
            matches, graph1, graph2, xmerge1, xmerge2,
            sources1, sources2, sinks1, sinks2, budget, algorithm, scale,
            masked_matches)
        if self.do_fill_in_anchoring:
            self._fill_in_anchor_chain(
                anchors, matches, graph1, graph2, tableau1, tableau2,
                xmerge1, xmerge2, algorithm, scale, masked_matches)
        return anchors

    # ------------------------------------------------------------------
    # fill-in anchoring (reference anchorer.hpp:619-800, src/anchorer.cpp)

    def _fill_in_anchor_chain(self, anchors, matches, graph1, graph2,
                              tableau1, tableau2, xmerge1, xmerge2,
                              algorithm, scale, masked_matches):
        if not anchors:
            return
        import os
        if (tableau1 is not None
                and os.environ.get("CENTROLIGN_TPU_PY_FILLIN") != "1"
                and algorithm in (ChainAlgorithm.Sparse,
                                  ChainAlgorithm.SparseAffine)):
            try:
                from .native import anchor_fill_in
            except Exception:
                anchor_fill_in = None
            if anchor_fill_in is not None:
                n_threads = int(os.environ.get("CENTROLIGN_TPU_THREADS",
                                               str(os.cpu_count() or 1)))
                rows, fvals = anchor_fill_in(
                    graph1, graph2, tableau1, tableau2, xmerge1, xmerge2,
                    matches, anchors, algorithm, scale,
                    self.gap_open, self.gap_extend, self.score_function,
                    self.max_num_match_pairs, masked_matches, n_threads)
                merged = []
                for k in range(len(rows)):
                    si, i1, i2, gb, ga = (int(x) for x in rows[k])
                    m = matches[si]
                    merged.append(Anchor(
                        walk1=np.asarray(m.walks1[i1]),
                        walk2=np.asarray(m.walks2[i2]),
                        count1=m.count1, count2=m.count2,
                        full_length=m.full_length, score=float(fvals[k, 0]),
                        gap_before=gb, gap_after=ga,
                        gap_score_before=float(fvals[k, 1]),
                        gap_score_after=float(fvals[k, 2]),
                        match_set=si, idx1=i1, idx2=i2))
                anchors[:] = merged
                return
        from .extractor import extract_graphs_between, project_paths
        from .match_finder import MatchSet

        fill_in_graphs = extract_graphs_between(
            anchors, graph1, graph2, tableau1, tableau2, xmerge1, xmerge2)
        project_paths(graph1, graph2, fill_in_graphs)
        fill_in_matches, match_origin = self._divvy_matches(
            matches, graph1, graph2, fill_in_graphs)
        budgets = self._assign_reanchor_budget(fill_in_graphs)

        def chain_one(i):
            sub1, sub2 = fill_in_graphs[i]
            xm1 = PathMerge(sub1.subgraph)
            xm2 = PathMerge(sub2.subgraph)
            fi_masked = None
            if masked_matches:
                fi_masked = set()
                for fset, (orig_set, (w1s, w2s)) in enumerate(match_origin[i]):
                    for idx1, oi1 in enumerate(w1s):
                        for idx2, oi2 in enumerate(w2s):
                            if (orig_set, oi1, oi2) in masked_matches:
                                fi_masked.add((fset, idx1, idx2))
            return self._chain_core(
                fill_in_matches[i], sub1.subgraph, sub2.subgraph, xm1, xm2,
                list(sub1.sources), list(sub2.sources),
                list(sub1.sinks), list(sub2.sinks),
                budgets[i], algorithm, scale, fi_masked)

        # per-gap chains are independent; the native engines release the GIL
        # (the reference runs these serially, src/execution.cpp — this is
        # the host-parallelism it leaves on the table)
        import os
        from concurrent.futures import ThreadPoolExecutor
        workers = min(
            int(os.environ.get("CENTROLIGN_TPU_THREADS",
                               str(os.cpu_count() or 1))),
            max(1, len(fill_in_graphs)))
        if workers > 1 and len(fill_in_graphs) > 4:
            with ThreadPoolExecutor(workers) as pool:
                fill_in_anchors = list(pool.map(chain_one,
                                                range(len(fill_in_graphs))))
        else:
            fill_in_anchors = [chain_one(i)
                               for i in range(len(fill_in_graphs))]

        self._merge_fill_in_chains(anchors, fill_in_anchors, fill_in_graphs,
                                   match_origin)

    def _divvy_matches(self, matches, graph1, graph2, fill_in_graphs):
        """(reference anchorer.hpp:700-800)"""
        from .match_finder import MatchSet
        fwd1 = np.full((graph1.node_size, 2), -1, dtype=_I64)
        fwd2 = np.full((graph2.node_size, 2), -1, dtype=_I64)
        for i, (sub1, sub2) in enumerate(fill_in_graphs):
            bt1 = np.asarray(sub1.back_translation, dtype=_I64)
            if len(bt1):
                fwd1[bt1, 0] = i
                fwd1[bt1, 1] = np.arange(len(bt1))
            bt2 = np.asarray(sub2.back_translation, dtype=_I64)
            if len(bt2):
                fwd2[bt2, 0] = i
                fwd2[bt2, 1] = np.arange(len(bt2))

        divvied = [[] for _ in fill_in_graphs]
        origins = [[] for _ in fill_in_graphs]
        for si, ms in enumerate(matches):
            initialized = {}
            for j in range(len(ms.walks1)):
                w = ms.walks1[j]
                sidx = fwd1[w[0], 0]
                if sidx != -1 and sidx == fwd1[w[-1], 0]:
                    sidx = int(sidx)
                    if sidx not in initialized:
                        divvied[sidx].append(
                            dict(walks1=[], walks2=[], count1=ms.count1,
                                 count2=ms.count2,
                                 full_length=ms.full_length))
                        origins[sidx].append((si, ([], [])))
                        initialized[sidx] = True
                    origins[sidx][-1][1][0].append(j)
                    divvied[sidx][-1]["walks1"].append(fwd1[w, 1])
            for k in range(len(ms.walks2)):
                w = ms.walks2[k]
                sidx = fwd2[w[0], 0]
                if (sidx != -1 and int(sidx) in initialized
                        and sidx == fwd2[w[-1], 0]):
                    sidx = int(sidx)
                    origins[sidx][-1][1][1].append(k)
                    divvied[sidx][-1]["walks2"].append(fwd2[w, 1])
            for sidx in initialized:
                if not divvied[sidx][-1]["walks2"]:
                    divvied[sidx].pop()
                    origins[sidx].pop()

        out = []
        for lst in divvied:
            sets = []
            for d in lst:
                sets.append(MatchSet(
                    walks1=np.array(d["walks1"], dtype=_I64),
                    walks2=np.array(d["walks2"], dtype=_I64),
                    count1=d["count1"], count2=d["count2"],
                    full_length=d["full_length"]))
            out.append(sets)
        return out, origins

    def _assign_reanchor_budget(self, fill_in_graphs):
        """(reference src/anchorer.cpp:136-154)"""
        import math
        sizes = [(p[0].subgraph.node_size + 1) * (p[1].subgraph.node_size + 1)
                 for p in fill_in_graphs]
        total = sum(sizes)
        return [int(math.ceil(float(self.max_num_match_pairs) * float(sz)
                              / float(total))) for sz in sizes]

    def _merge_fill_in_chains(self, anchors, fill_in_chains, fill_in_graphs,
                              match_origin):
        """(reference src/anchorer.cpp:156-230)"""
        merged = []
        assert len(anchors) + 1 == len(fill_in_chains)
        for i in range(len(fill_in_chains)):
            if i != 0:
                a = anchors[i - 1]
                if merged:
                    a.gap_before = merged[-1].gap_after
                    a.gap_score_before = merged[-1].gap_score_after
                merged.append(a)
            bt1 = np.asarray(fill_in_graphs[i][0].back_translation, dtype=_I64)
            bt2 = np.asarray(fill_in_graphs[i][1].back_translation, dtype=_I64)
            for j, a in enumerate(fill_in_chains[i]):
                if j == 0 and merged:
                    merged[-1].gap_score_after = a.gap_score_before
                    merged[-1].gap_after = a.gap_before
                origin_set = match_origin[i][a.match_set]
                merged.append(Anchor(
                    walk1=bt1[a.walk1], walk2=bt2[a.walk2],
                    count1=a.count1, count2=a.count2,
                    full_length=a.full_length, score=a.score,
                    gap_before=a.gap_before, gap_after=a.gap_after,
                    gap_score_before=a.gap_score_before,
                    gap_score_after=a.gap_score_after,
                    match_set=origin_set[0],
                    idx1=origin_set[1][0][a.idx1],
                    idx2=origin_set[1][1][a.idx2]))
        anchors[:] = merged

    def _budget_matches(self, matches, budget, masked_matches):
        """Greedy score-ordered budget to `budget` match pairs; reorders
        `matches` in place like the reference (anchorer.hpp:1108-1173).
        Returns (num usable match sets, num_anchors, max_match_size)."""
        total = sum(len(m.walks1) * len(m.walks2) for m in matches)
        if total <= budget:
            return len(matches), total, 0
        sf = self.score_function
        order = sorted(
            range(len(matches)), key=lambda i: -sf.anchor_weight(
                matches[i].count1, matches[i].count2, matches[i].full_length))
        removed = 0
        pairs_left = budget
        max_match_size = 0
        for pos in range(len(order)):
            i = order[pos]
            m = matches[i]
            if sf.anchor_weight(m.count1, m.count2, m.walks1.shape[1]) < 0.0:
                removed += len(order) - pos
                break
            pc = len(m.walks1) * len(m.walks2)
            if pairs_left >= pc:
                max_match_size = max(max_match_size,
                                     max(len(m.walks1), len(m.walks2)))
                pairs_left -= pc
                order[pos - removed], order[pos] = order[pos], order[pos - removed]
            else:
                removed += 1
        # reorder matches to match `order`
        reordered = [matches[i] for i in order]
        matches[:] = reordered
        if masked_matches is not None:
            index = {old: new for new, old in enumerate(order)}
            remapped = {(index[s], i1, i2) for (s, i1, i2) in masked_matches}
            masked_matches.clear()
            masked_matches.update(remapped)
        return len(matches) - removed, budget - pairs_left, max_match_size

    def _chain_core(self, matches, graph1, graph2, xmerge1, xmerge2,
                    sources1, sources2, sinks1, sinks2, budget, algorithm,
                    scale, masked_matches):
        num_sets, num_anchors, max_match_size = self._budget_matches(
            matches, budget, masked_matches)
        if algorithm in (ChainAlgorithm.Sparse, ChainAlgorithm.SparseAffine):
            return self._chain_parity(
                matches, graph1, graph2, xmerge1, xmerge2,
                sources1, sources2, sinks1, sinks2, algorithm, scale,
                masked_matches, num_sets, num_anchors, max_match_size)
        score_edges = algorithm == ChainAlgorithm.SparseAffine

        # flatten anchors
        set_idx, i1s, i2s = [], [], []
        starts1, ends1, starts2, ends2, weights = [], [], [], [], []
        sf = self.score_function
        for si in range(num_sets):
            m = matches[si]
            w = sf.anchor_weight(m.count1, m.count2, m.walks1.shape[1],
                                 m.full_length)
            for a in range(len(m.walks1)):
                for b in range(len(m.walks2)):
                    if masked_matches and (si, a, b) in masked_matches:
                        continue
                    set_idx.append(si)
                    i1s.append(a)
                    i2s.append(b)
                    starts1.append(m.walks1[a][0])
                    ends1.append(m.walks1[a][-1])
                    starts2.append(m.walks2[b][0])
                    ends2.append(m.walks2[b][-1])
                    weights.append(w)
        n = len(set_idx)
        if n == 0:
            return []
        starts1 = np.array(starts1, dtype=_I64)
        ends1 = np.array(ends1, dtype=_I64)
        starts2 = np.array(starts2, dtype=_I64)
        ends2 = np.array(ends2, dtype=_I64)
        weights = np.array(weights)

        # fast path: both graphs are single chains (plus sentinel pseudo
        # chain) -> the native O(n log^2 n) sweep DP
        chain_ids = self._chain_native(
            starts1, ends1, starts2, ends2, weights, xmerge1, xmerge2,
            sources1, sources2, sinks1, sinks2, score_edges, scale)
        general_native = False
        if chain_ids is None and n >= 256:
            # general path-covered DAGs: native sweep with canonical-chain
            # trees (the reference's sparse DP structure)
            chain_ids = self._chain_native_general(
                graph1, graph2, starts1, ends1, starts2, ends2, weights,
                xmerge1, xmerge2, sources1, sources2, sinks1, sinks2,
                score_edges, scale)
            general_native = chain_ids is not None
        if chain_ids is not None:
            return self._assemble_chain(
                chain_ids, matches, set_idx, i1s, i2s, starts1, starts2,
                ends1, ends2, xmerge1, xmerge2, score_edges, scale,
                general=general_native, graph1=graph1, graph2=graph2)

        psd1 = psd2 = None
        if score_edges:
            psd1 = _native_psd(graph1, xmerge1)
            psd2 = _native_psd(graph2, xmerge2)

        # pre-gather per-anchor-start quantities (the "to" side of edges)
        # table rows for every start node: (n, C)
        pred_s1 = xmerge1.table[starts1]          # (n, C1)
        pred_s2 = xmerge2.table[starts2]
        # from-side chain info for every end node
        head_e1 = xmerge1.path_head[ends1]
        head_e2 = xmerge2.path_head[ends2]
        idx_e1 = xmerge1.index_on[np.where(head_e1 == -1, 0, head_e1), ends1]
        idx_e2 = xmerge2.index_on[np.where(head_e2 == -1, 0, head_e2), ends2]
        if score_edges:
            psv1 = np.where(psd1.distances == 0, np.int64(2**61),
                            psd1.distances)[:, starts1].astype(np.float64)  # (C1, n)
            psv2 = np.where(psd2.distances == 0, np.int64(2**61),
                            psd2.distances)[:, starts2].astype(np.float64)
            go = np.array(self.gap_open)[:, None]
            ge = np.array(self.gap_extend)[:, None]

        # initial / final weights
        init_w = np.zeros(n)
        fin_w = np.zeros(n)
        if sources1 is not None:
            init_w, fin_w = self._boundary_weights(
                starts1, ends1, starts2, ends2, sources1, sources2,
                sinks1, sinks2, xmerge1, xmerge2, psd1, psd2, scale,
                score_edges)

        # DP over anchors in a valid topological order of the anchor DAG
        # (order by topological position of walk1 start; edges always go
        # strictly forward in that order). Rows of the reachability/edge
        # matrices are computed on the fly: O(n) memory instead of O(n^2).
        topo1 = np.empty(graph1.node_size, dtype=_I64)
        topo1[graph1.topological_order()] = np.arange(graph1.node_size)
        order = np.argsort(topo1[starts1], kind="stable")

        dp = init_w.copy()
        backptr = np.full(n, -1, dtype=_I64)
        min_score = 0.0
        if sources1 is not None and sinks1 is not None and score_edges:
            # the score of the empty chain (anchorer.hpp:1466-1481)
            min_score = self._empty_chain_score(
                sources1, sources2, sinks1, sinks2, xmerge1, xmerge2,
                psd1, psd2, scale)
        best_id, best_score = -1, min_score
        for a in order:
            a = int(a)
            if dp[a] == _LOWEST:
                continue
            dp[a] += weights[a]
            if fin_w[a] != _LOWEST and dp[a] + fin_w[a] > best_score:
                best_id, best_score = a, dp[a] + fin_w[a]
            # reachability row: ends[a] -> all starts, both graphs
            if head_e1[a] == -1 or head_e2[a] == -1:
                continue
            r1 = pred_s1[:, head_e1[a]]
            r2 = pred_s2[:, head_e2[a]]
            reach_row = (r1 != -1) & (idx_e1[a] <= r1) & (r2 != -1) & (idx_e2[a] <= r2)
            succ = np.flatnonzero(reach_row)
            if len(succ) == 0:
                continue
            if score_edges:
                ew = np.full(len(succ), _LOWEST)
                for c1 in xmerge1.chains_on(ends1[a]):
                    d1 = (pred_s1[succ, c1].astype(np.float64)
                          + psv1[c1, succ] - float(xmerge1.index_on[c1, ends1[a]]))
                    for c2 in xmerge2.chains_on(ends2[a]):
                        d2 = (pred_s2[succ, c2].astype(np.float64)
                              + psv2[c2, succ] - float(xmerge2.index_on[c2, ends2[a]]))
                        gap = np.abs(d1 - d2)
                        w = np.where(gap == 0, 0.0,
                                     (-scale * (go + ge * gap)).max(axis=0))
                        np.maximum(ew, w, out=ew)
                cand = dp[a] + ew
            else:
                cand = dp[a] + np.zeros(len(succ))
            upd = cand > dp[succ]
            dp[succ[upd]] = cand[upd]
            backptr[succ[upd]] = a
        chain_ids = []
        v = best_id
        while v != -1:
            chain_ids.append(v)
            v = int(backptr[v])
        chain_ids.reverse()

        chain = []
        for v in chain_ids:
            m = matches[set_idx[v]]
            chain.append(Anchor(
                walk1=np.asarray(m.walks1[i1s[v]]),
                walk2=np.asarray(m.walks2[i2s[v]]),
                count1=m.count1, count2=m.count2,
                full_length=m.full_length, match_set=set_idx[v],
                idx1=i1s[v], idx2=i2s[v]))
        for a in chain:
            a.score = self.anchor_weight(a)
        if score_edges:
            self._annotate_gaps(chain, sources1, sources2, sinks1, sinks2,
                                xmerge1, xmerge2, psd1, psd2, scale)
        return chain

    def _chain_parity(self, matches, graph1, graph2, xmerge1, xmerge2,
                      sources1, sources2, sinks1, sinks2, algorithm, scale,
                      masked_matches, num_sets, num_anchors, max_match_size):
        """Reference-exact chaining through the native parity engines
        (reference anchorer.hpp:1175-1329 incl. the memory-saving graph
        switch)."""
        from .native import chain_sparse_parity, chain_affine_parity

        switch = (graph1.node_size * xmerge1.num_chains
                  > graph2.node_size * xmerge2.num_chains)
        local_masked = masked_matches
        if switch:
            for m in matches:
                m.walks1, m.walks2 = m.walks2, m.walks1
                m.count1, m.count2 = m.count2, m.count1
            if masked_matches:
                local_masked = {(s_, j_, i_) for (s_, i_, j_) in masked_matches}
            graph1, graph2 = graph2, graph1
            xmerge1, xmerge2 = xmerge2, xmerge1
            sources1, sources2 = sources2, sources1
            sinks1, sinks2 = sinks2, sinks1

        sf = self.score_function
        weights = np.array([
            sf.anchor_weight(m.count1, m.count2,
                             (m.walks1.shape[1] if len(m.walks1) else 0),
                             m.full_length)
            for m in matches[:num_sets]] + [0.0] * (len(matches) - num_sets))

        if algorithm == ChainAlgorithm.Sparse:
            rows, scores = chain_sparse_parity(
                graph1, matches, num_sets, weights, xmerge1, xmerge2,
                sources1, sources2, sinks1, sinks2, local_masked)
            fvals = np.zeros((len(rows), 3))
            fvals[:, 0] = scores
            grows = np.zeros((len(rows), 2), dtype=_I64)
        else:
            import os
            res = None
            # Default-on since round 4: the offline CDQ value engine
            # computes bit-identical dp values (validated against the tree
            # engine: 0/145331 mismatches on the benchmark pair input) and
            # traceback ties are resolved exactly by the host tree-walk
            # replica (chain_ties.py) — byte-identical CIGARs/chains at
            # ~1/10 the sweep cost. Tree engine remains for masked
            # (cyclization) chains and non-chain graphs.
            if (not local_masked
                    and os.environ.get("CENTROLIGN_TPU_CHAIN_CDQ", "1") == "1"):
                res = self._chain_affine_cdq(
                    matches, graph1, graph2, xmerge1, xmerge2,
                    sources1, sources2, sinks1, sinks2, scale,
                    num_sets, num_anchors, max_match_size, weights)
            if res is not None and os.environ.get(
                    "CENTROLIGN_TPU_CHAIN_CDQ_VALIDATE"):
                res = self._validate_cdq(
                    res, matches, graph1, graph2, xmerge1, xmerge2,
                    sources1, sources2, sinks1, sinks2, scale,
                    num_sets, num_anchors, max_match_size, weights,
                    local_masked)
            if res is not None:
                arows, fvals = res
            else:
                arows, fvals = chain_affine_parity(
                    graph1, graph2, matches, num_sets, weights, xmerge1,
                    xmerge2, self.gap_open, self.gap_extend, scale,
                    sources1, sources2, sinks1, sinks2,
                    num_anchors, max_match_size, local_masked)
            rows = arows[:, :3]
            grows = arows[:, 3:5]

        chain = []
        for k in range(len(rows)):
            si, i1, i2 = (int(rows[k, 0]), int(rows[k, 1]), int(rows[k, 2]))
            m = matches[si]
            chain.append(Anchor(
                walk1=np.asarray(m.walks1[i1]), walk2=np.asarray(m.walks2[i2]),
                count1=m.count1, count2=m.count2, full_length=m.full_length,
                score=float(fvals[k, 0]),
                gap_before=int(grows[k, 0]), gap_after=int(grows[k, 1]),
                gap_score_before=float(fvals[k, 1]),
                gap_score_after=float(fvals[k, 2]),
                match_set=si, idx1=i1, idx2=i2))

        if switch:
            for m in matches:
                m.walks1, m.walks2 = m.walks2, m.walks1
                m.count1, m.count2 = m.count2, m.count1
            for a in chain:
                a.walk1, a.walk2 = a.walk2, a.walk1
                a.count1, a.count2 = a.count2, a.count1
                a.idx1, a.idx2 = a.idx2, a.idx1
                a.gap_before = -a.gap_before
                a.gap_after = -a.gap_after
        return chain

    # ------------------------------------------------------------------
    # CDQ validation harness (CENTROLIGN_TPU_CHAIN_CDQ_VALIDATE=1): run the
    # tree engine alongside, diff per-anchor dp/bp, report, return the tree
    # result so the pipeline output stays canonical while debugging.

    def _validate_cdq(self, res, matches, graph1, graph2, xmerge1, xmerge2,
                      sources1, sources2, sinks1, sinks2, scale,
                      num_sets, num_anchors, max_match_size, weights,
                      local_masked):
        import os
        import sys
        import tempfile
        from .native import chain_affine_parity

        if getattr(self, "_cdq_debug", None) is None:
            # the CDQ engine early-returned (empty/inapplicable input)
            # before recording a debug payload; nothing to validate
            return res

        fd, dump = tempfile.mkstemp(suffix=".dpdump")
        os.close(fd)
        prev_dump = os.environ.get("CHAIN_DP_DUMP")
        os.environ["CHAIN_DP_DUMP"] = dump
        try:
            arows_t, fvals_t = chain_affine_parity(
                graph1, graph2, matches, num_sets, weights, xmerge1,
                xmerge2, self.gap_open, self.gap_extend, scale,
                sources1, sources2, sinks1, sinks2,
                num_anchors, max_match_size, local_masked)
        finally:
            if prev_dump is None:
                del os.environ["CHAIN_DP_DUMP"]
            else:
                os.environ["CHAIN_DP_DUMP"] = prev_dump
        (sid, i1s, i2s, ps1, pe1, ps2, pe2, dp, bp, tie, init) = \
            self._cdq_debug
        self._cdq_debug = None  # consume: never validate a stale payload
        with open(dump, "rb") as f:
            n = int(np.fromfile(f, dtype=np.int64, count=1)[0])
            dp_t = np.fromfile(f, dtype=np.float32, count=n)
            # ID_MAX (u64 max) wraps to -1, matching the CDQ none sentinel
            bp_t = np.fromfile(f, dtype=np.uint64, count=n).astype(np.int64)
        os.unlink(dump)
        assert n == len(dp), f"anchor count mismatch {n} vs {len(dp)}"
        dmis = np.flatnonzero(dp_t != dp)
        print(f"[cdq-validate] n={n} dp mismatches={len(dmis)}",
              file=sys.stderr)
        for a in dmis[:10]:
            print(f"  id={a} s1={ps1[a]} e1={pe1[a]} s2={ps2[a]} "
                  f"e2={pe2[a]} tree={dp_t[a]!r} cdq={dp[a]!r} "
                  f"bp_tree={bp_t[a]} bp_cdq={bp[a]} tie={tie[a]} "
                  f"init={init[a]!r}", file=sys.stderr)
        bmis = np.flatnonzero((bp_t != bp) & (tie == 0) & (dp_t == dp))
        print(f"[cdq-validate] untied bp mismatches={len(bmis)}, "
              f"ties flagged={int((tie != 0).sum())}", file=sys.stderr)
        for a in bmis[:10]:
            print(f"  id={a} bp_tree={bp_t[a]} bp_cdq={bp[a]} "
                  f"dp={dp[a]!r}", file=sys.stderr)
        arows_c, fvals_c = res
        same = (arows_t.shape == arows_c.shape
                and bool((arows_t == arows_c).all()))
        print(f"[cdq-validate] chains identical: {same} "
              f"(tree {len(arows_t)} rows, cdq {len(arows_c)} rows)",
              file=sys.stderr)
        # tie structure distribution: overall and along the tree's path
        struct = getattr(self, "_cdq_struct", None)
        if struct is not None:
            # map tree chain rows (set, i1, i2) -> flat ids
            n2s = {}
            base = {}
            acc = 0
            for s in range(num_sets):
                m0 = matches[s]
                n1, n2 = len(m0.walks1), len(m0.walks2)
                base[s] = acc
                n2s[s] = n2
                acc += n1 * n2
            path_ids = [base[int(r[0])] + int(r[1]) * n2s[int(r[0])]
                        + int(r[2]) for r in arows_t]
            import collections
            dist_all = collections.Counter(struct[tie != 0].tolist())
            on_path = [a for a in path_ids if tie[a]]
            dist_path = collections.Counter(
                struct[np.array(on_path, dtype=np.int64)].tolist()
                if on_path else [])
            print(f"[cdq-validate] tied struct dist (all): "
                  f"{dict(dist_all)}", file=sys.stderr)
            print(f"[cdq-validate] path ties: {len(on_path)}/"
                  f"{len(path_ids)} struct dist: {dict(dist_path)}",
                  file=sys.stderr)
            bppath = [int(bp[a]) for a in on_path]
            bptree = [int(bp_t[a]) for a in on_path]
            agree = sum(1 for x, y in zip(bppath, bptree) if x == y)
            print(f"[cdq-validate] tied path steps where cdq first-found "
                  f"bp == tree bp: {agree}/{len(on_path)}", file=sys.stderr)
        return arows_t, fvals_t

    # ------------------------------------------------------------------
    # SparseAffine chain x chain via offline CDQ (native/chain_affine_cdq.cpp)

    def _chain_affine_cdq(self, matches, graph1, graph2, xmerge1, xmerge2,
                          sources1, sources2, sinks1, sinks2, scale,
                          num_sets, num_anchors, max_match_size, weights):
        """Reference-exact SparseAffine chaining on chain x chain inputs
        through the O(n log^2 n) CDQ value engine plus host-side traceback.
        DP values are bit-identical to the tree sweep (same f32/f64 rounding
        sequence, reference anchorer.hpp:2290-2420); backpointer ties on the
        traceback path are resolved in-process by chain_ties.AffineTieResolver
        (a rank-arithmetic replica of the tree visit order), and only an
        unresolved walk (resolve() -> None) falls back to the tree engine.
        Returns (arows, fvals) in chain_affine_parity's output format, or
        None when not applicable."""
        import os

        # any _cdq_debug left over from a prior call (e.g. one that fell
        # back to the tree engine after the native sweep) is stale now
        self._cdq_debug = None

        def is_chain(g):
            return (g.node_size > 0 and bool((g.out_degrees() <= 1).all())
                    and bool((g.in_degrees() <= 1).all())
                    and int((g.in_degrees() == 0).sum()) == 1)

        if xmerge1.num_chains > 2 or xmerge2.num_chains > 2:
            return None
        if not (is_chain(graph1) and is_chain(graph2)):
            return None
        idx1 = np.asarray(xmerge1.index_on[0], dtype=_I64)
        idx2 = np.asarray(xmerge2.index_on[0], dtype=_I64)

        # flatten anchors in MatchBank id order: (set, walk1, walk2)
        parts = []
        for s in range(num_sets):
            m = matches[s]
            a1 = np.asarray(m.walks1, dtype=_I64)
            a2 = np.asarray(m.walks2, dtype=_I64)
            n1, n2 = len(a1), len(a2)
            if n1 == 0 or n2 == 0:
                continue
            parts.append((
                np.full(n1 * n2, s, dtype=_I64),
                np.repeat(np.arange(n1, dtype=_I64), n2),
                np.tile(np.arange(n2, dtype=_I64), n1),
                np.repeat(a1[:, 0], n2), np.repeat(a1[:, -1], n2),
                np.tile(a2[:, 0], n1), np.tile(a2[:, -1], n1)))
        if not parts:
            return (np.empty((0, 5), dtype=_I64), np.empty((0, 3)))
        sid, i1s, i2s, as1, ae1, as2, ae2 = (
            np.concatenate([p[k] for p in parts]) for k in range(7))
        n = len(sid)

        ps1, pe1, ps2, pe2 = idx1[as1], idx1[ae1], idx2[as2], idx2[ae2]
        if (ps1 < 0).any() or (pe1 < 0).any() or (ps2 < 0).any() \
                or (pe2 < 0).any():
            return None
        for nodes, idx in ((sources1, idx1), (sources2, idx2),
                           (sinks1, idx1), (sinks2, idx2)):
            if nodes is not None and len(nodes) and \
                    (idx[np.asarray(nodes, dtype=_I64)] < 0).any():
                return None

        # reference integer-width dispatch (anchorer.hpp:1271-1280) decides
        # the unreachable-gap sentinel value
        use_small = (num_sets < 2**32 - 1 and max_match_size < 2**16 - 1
                     and graph1.node_size + graph2.node_size < 2**31 - 1
                     and num_anchors < 2**32 - 1)
        gapmax = np.int64(2**31 - 1) if use_small else np.int64(2**63 - 1)
        go = np.asarray(self.gap_open, dtype=np.float64)
        ge = np.asarray(self.gap_extend, dtype=np.float64)
        mininf = np.float32(np.finfo(np.float32).min)

        def score_gap(gap):
            """reference AffineEngine::score_gap: f32 running max of
            per-component f32(-scale*(go + ge*|gap|)); 0 at gap==0,
            MININF at the unreachable sentinel."""
            gap = np.atleast_1d(np.asarray(gap, dtype=_I64))
            a = np.abs(gap).astype(np.float64)
            sc = np.full(gap.shape, mininf, dtype=np.float32)
            for k in range(len(go)):
                cand = (-scale * (go[k] + ge[k] * a)).astype(np.float32)
                sc = np.maximum(sc, cand)
            sc = np.where(gap == 0, np.float32(0.0), sc)
            return np.where(gap == gapmax, mininf, sc)

        def gap_between(pn1, pn2, c1_nodes, c2_nodes):
            """measure_gap for on-chain node pairs, vectorized over the
            current side (scalar prev): source_shift(prev) -
            query_shift(cur), gated by chain reachability."""
            qp1, qp2 = idx1[c1_nodes], idx2[c2_nodes]
            r = (((pn1 == c1_nodes) | (idx1[pn1] < qp1))
                 & ((pn2 == c2_nodes) | (idx2[pn2] < qp2)))
            g = (idx1[pn1] - idx2[pn2]) - (qp1 - qp2)
            return np.where(r, g, gapmax)

        def min_abs_gap(prev_pairs, c1_nodes, c2_nodes):
            """reference measure_gap_sn/ns quirk: |gap| compared against
            the SIGNED running value (anchorer.hpp:1946-1995)."""
            rv = np.full(np.shape(c1_nodes), gapmax, dtype=_I64)
            for pn1, pn2 in prev_pairs:
                here = gap_between(pn1, pn2, c1_nodes, c2_nodes)
                upd = np.abs(here) < rv
                rv = np.where(upd, here, rv)
            return rv

        def min_abs_gap_to(cur_pairs, p1_nodes, p2_nodes):
            """measure_gap_ns: gap from vectorized prev nodes (anchor ends)
            to each scalar (sink1, sink2) pair, same |gap|-vs-signed running
            quirk, sinks1-outer/sinks2-inner iteration order."""
            rv = np.full(np.shape(p1_nodes), gapmax, dtype=_I64)
            for cn1, cn2 in cur_pairs:
                qp1, qp2 = idx1[cn1], idx2[cn2]
                r = (((p1_nodes == cn1) | (idx1[p1_nodes] < qp1))
                     & ((p2_nodes == cn2) | (idx2[p2_nodes] < qp2)))
                here = np.where(
                    r, (idx1[p1_nodes] - idx2[p2_nodes]) - (qp1 - qp2),
                    gapmax)
                upd = np.abs(here) < rv
                rv = np.where(upd, here, rv)
            return rv

        w32 = weights[:num_sets].astype(np.float32)
        aw = w32[sid]
        if sources1 is not None:
            prev_pairs = [(int(a), int(b)) for a in sources1
                          for b in sources2]
            lead = score_gap(min_abs_gap(prev_pairs, as1, as2))
            init = np.where(lead == mininf, mininf, aw + lead)
        else:
            init = aw.copy()

        dp, bp, tie, _struct, _stored, _qs = self._cdq_values(
            ps1, pe1, ps2, pe2, aw, init, go, ge, scale)
        if os.environ.get("CENTROLIGN_TPU_CHAIN_CDQ_VALIDATE"):
            self._cdq_debug = (sid, i1s, i2s, ps1, pe1, ps2, pe2,
                               dp, bp, tie, init)
            self._cdq_struct = _struct

        # final indel term + opt selection (affine_impl traceback prologue)
        min_score = np.float32(0.0)
        if sinks1 is not None:
            fin = score_gap(min_abs_gap_to(
                [(int(a), int(b)) for a in sinks1 for b in sinks2],
                ae1, ae2))
            if sources1 is not None:
                # measure_gap_ss: curr (sinks) outer, prev (sources) inner
                rv = np.int64(gapmax)
                for c in sinks1:
                    for d in sinks2:
                        for a in sources1:
                            for b in sources2:
                                here = gap_between(
                                    int(a), int(b),
                                    np.asarray([c], dtype=_I64),
                                    np.asarray([d], dtype=_I64))[0]
                                if abs(int(here)) < rv:
                                    rv = np.int64(here)
                min_score = score_gap(rv)[0]
            dpf = np.where(fin == mininf, mininf, dp + fin)
        else:
            dpf = dp

        ok = dpf > min_score
        if not ok.any():
            return (np.empty((0, 5), dtype=_I64), np.empty((0, 3)))
        best = dpf[ok].max()
        opt = int(np.flatnonzero((dpf == best) & ok)[0])

        rev = []
        here = opt
        resolver = None
        while here != -1:
            if tie[here]:
                # a tied range-max on the traceback path: the exact winner
                # depends on the tree visit order — resolve via the host
                # replica of the OrthoTree/MaxTree walk (chain_ties.py)
                if resolver is None:
                    from .chain_ties import AffineTieResolver
                    resolver = AffineTieResolver(
                        ps1, pe1, ps2, pe2, dp, ge, scale)
                here2 = resolver.resolve(
                    int(here), int(_struct[here]), _stored[here])
                if here2 is None:
                    if os.environ.get("CHAIN_PARITY_DEBUG"):
                        import sys
                        print("[cdq] unresolved tie -> tree engine fallback",
                              file=sys.stderr)
                    return None
                rev.append(here)
                here = int(here2)
                continue
            rev.append(here)
            here = int(bp[here])
        rev.reverse()

        # gap annotations (affine_impl / anchorer.hpp:2423-2462)
        m = len(rev)
        arows = np.zeros((m, 5), dtype=_I64)
        fvals = np.zeros((m, 3))
        for t, a in enumerate(rev):
            arows[t, 0] = sid[a]
            arows[t, 1] = i1s[a]
            arows[t, 2] = i2s[a]
            fvals[t, 0] = weights[sid[a]]
        for t, a in enumerate(rev):
            if t == 0 and sources1 is not None:
                g = min_abs_gap(
                    [(int(x), int(y)) for x in sources1 for y in sources2],
                    as1[a:a + 1], as2[a:a + 1])[0]
                arows[t, 3] = g
                fvals[t, 1] = score_gap(g)[0]
            if t > 0:
                p = rev[t - 1]
                g = gap_between(int(ae1[p]), int(ae2[p]),
                                as1[a:a + 1], as2[a:a + 1])[0]
                gs = score_gap(g)[0]
                arows[t - 1, 4] = g
                fvals[t - 1, 2] = gs
                arows[t, 3] = g
                fvals[t, 1] = gs
            if t == m - 1 and sinks1 is not None:
                g = min_abs_gap_to(
                    [(int(x), int(y)) for x in sinks1 for y in sinks2],
                    ae1[a:a + 1], ae2[a:a + 1])[0]
                arows[t, 4] = g
                fvals[t, 2] = score_gap(g)[0]
        return arows, fvals

    def _cdq_values(self, ps1, pe1, ps2, pe2, aw, init, go, ge, scale):
        """CDQ value pass: dp/bp/tie/struct/stored/qshift per anchor, on the
        native engine (native/chain_affine_cdq.cpp). The JAX package's
        opt-in device realization (ops/chain_cdq.py) is not ported yet."""
        from .native import chain_affine_cdq
        return chain_affine_cdq(ps1, pe1, ps2, pe2, aw, init, go, ge,
                                scale)

    # ------------------------------------------------------------------
    # native chain-graph fast path

    @staticmethod
    def _chain_positions(xmerge, nodes):
        """Indices of the nodes on the single real chain, or None if any node
        is off-chain or the graph is not single-chain."""
        if xmerge.num_chains != 2:
            return None
        idx = xmerge.index_on[0, nodes]
        if (idx == -1).any():
            return None
        return idx

    def _chain_native(self, starts1, ends1, starts2, ends2, weights,
                      xmerge1, xmerge2, sources1, sources2, sinks1, sinks2,
                      score_edges, scale):
        """Dispatch to the native CDQ sweep when both graphs are single
        chains; returns chain ids or None if not applicable."""
        n = len(starts1)
        if n < 256:
            return None  # numpy DP is fine (and avoids native ties headaches)
        for src in (sources1, sinks1, sources2, sinks2):
            if src is not None and len(src) != 1:
                return None
        p1s = self._chain_positions(xmerge1, starts1)
        p1e = self._chain_positions(xmerge1, ends1)
        p2s = self._chain_positions(xmerge2, starts2)
        p2e = self._chain_positions(xmerge2, ends2)
        if any(p is None for p in (p1s, p1e, p2s, p2e)):
            return None
        try:
            from .native import chain_dp_seq
        except Exception:
            return None

        go = np.array(self.gap_open, dtype=np.float64)
        ge = np.array(self.gap_extend, dtype=np.float64)

        def gap_cost(gaps):
            gaps = np.abs(gaps).astype(np.float64)
            cost = (-scale * (go[:, None] + ge[:, None] * gaps[None, :])).max(axis=0)
            return np.where(gaps == 0, 0.0, cost)

        if sources1 is not None:
            src_idx1 = int(xmerge1.index_on[0, sources1[0]])
            src_idx2 = int(xmerge2.index_on[0, sources2[0]])
            snk_idx1 = int(xmerge1.index_on[0, sinks1[0]])
            snk_idx2 = int(xmerge2.index_on[0, sinks2[0]])
            if score_edges:
                init_w = gap_cost((p1s - src_idx1) - (p2s - src_idx2))
                fin_w = gap_cost((snk_idx1 - p1e) - (snk_idx2 - p2e))
                min_score = float(gap_cost(np.array(
                    [(snk_idx1 - src_idx1) - (snk_idx2 - src_idx2)]))[0])
            else:
                init_w = np.zeros(n)
                fin_w = np.zeros(n)
                min_score = 0.0
        else:
            init_w = np.zeros(n)
            fin_w = np.zeros(n)
            min_score = 0.0

        best, backptr, _dp = chain_dp_seq(
            p1s, p1e, p2s, p2e, weights, init_w, fin_w, score_edges,
            go, ge, scale, min_score)
        chain_ids = []
        v = best
        while v != -1:
            chain_ids.append(v)
            v = int(backptr[v])
        chain_ids.reverse()
        return chain_ids

    def _chain_native_general(self, graph1, graph2, starts1, ends1,
                              starts2, ends2, weights, xmerge1, xmerge2,
                              sources1, sources2, sinks1, sinks2,
                              score_edges, scale):
        try:
            from .native import chain_dp_general, psd_build
        except Exception:
            return None
        n = len(starts1)
        # canonical chain/index per node
        chain1 = xmerge1.path_head
        chain2 = xmerge2.path_head
        idx1 = xmerge1.index_on[np.where(chain1 == -1, 0, chain1),
                                np.arange(graph1.node_size)]
        idx2 = xmerge2.index_on[np.where(chain2 == -1, 0, chain2),
                                np.arange(graph2.node_size)]
        topo1 = graph1.topological_order()

        # chain node lists (incl. the sentinel pseudo chain, if present)
        offs, nodes = [0], []
        for p in range(graph1.path_size):
            nodes.append(graph1.path(p))
            offs.append(offs[-1] + len(nodes[-1]))
        if xmerge1.num_chains > graph1.path_size:
            tab = xmerge1.tableau
            nodes.append(np.array([tab.src_id, tab.snk_id], dtype=_I64))
            offs.append(offs[-1] + 2)
        chain1_nodes = np.concatenate(nodes) if nodes else np.empty(0, dtype=_I64)
        chain1_offsets = np.array(offs[:-1], dtype=_I64)

        D1 = D2 = None
        psdv1 = psdv2 = None
        if score_edges:
            p_ptr1, p_ind1 = graph1.prev_csr()
            p_ptr2, p_ind2 = graph2.prev_csr()
            D1 = psd_build(topo1, p_ptr1, p_ind1, xmerge1.index_on, xmerge1.table)
            D2 = psd_build(graph2.topological_order(), p_ptr2, p_ind2,
                           xmerge2.index_on, xmerge2.table)
            psdv1 = np.where(D1 == 0, np.int64(2**61), D1)
            psdv2 = np.where(D2 == 0, np.int64(2**61), D2)

        go = np.array(self.gap_open, dtype=np.float64)
        ge = np.array(self.gap_extend, dtype=np.float64)

        init_w, fin_w, min_score = self._boundary_weights_vec(
            starts1, ends1, starts2, ends2, sources1, sources2, sinks1,
            sinks2, xmerge1, xmerge2, psdv1, psdv2, score_edges, scale)

        best, backptr, _dp = chain_dp_general(
            starts1, ends1, starts2, ends2, weights, init_w, fin_w,
            topo1, chain1, idx1, xmerge1.table, D1, chain1_nodes,
            chain1_offsets, chain2, idx2, xmerge2.table, D2,
            score_edges, go, ge, scale, min_score)
        chain_ids = []
        v = best
        while v != -1:
            chain_ids.append(v)
            v = int(backptr[v])
        chain_ids.reverse()
        return chain_ids

    def _boundary_weights_vec(self, starts1, ends1, starts2, ends2,
                              sources1, sources2, sinks1, sinks2,
                              xmerge1, xmerge2, psdv1, psdv2,
                              score_edges, scale):
        """Vectorized source/sink boundary weights + empty-chain min score
        (reference anchorer.hpp: initial/final weights + empty chain)."""
        n = len(starts1)
        if sources1 is None:
            return np.zeros(n), np.zeros(n), 0.0
        go = np.array(self.gap_open)[:, None]
        ge = np.array(self.gap_extend)[:, None]

        def gap_w(gaps):
            gaps = np.abs(gaps).astype(np.float64)
            w = (-scale * (go + ge * gaps[None, :])).max(axis=0)
            return np.where(gaps == 0, 0.0, w)

        init_w = np.full(n, _LOWEST)
        fin_w = np.full(n, _LOWEST)
        for s1 in sources1:
            r1 = xmerge1.reachable_matrix(np.array([s1]), starts1)[0] | (starts1 == s1)
            for s2 in sources2:
                r2 = xmerge2.reachable_matrix(np.array([s2]), starts2)[0] | (starts2 == s2)
                ok = r1 & r2
                if not ok.any():
                    continue
                if not score_edges:
                    init_w[ok] = np.maximum(init_w[ok], 0.0)
                    continue
                best = np.full(int(ok.sum()), _LOWEST)
                sel = np.flatnonzero(ok)
                for c1 in xmerge1.chains_on(s1):
                    d1 = (xmerge1.table[starts1[sel], c1]
                          + psdv1[c1, starts1[sel]]
                          - int(xmerge1.index_on[c1, s1])).astype(np.float64)
                    for c2 in xmerge2.chains_on(s2):
                        d2 = (xmerge2.table[starts2[sel], c2]
                              + psdv2[c2, starts2[sel]]
                              - int(xmerge2.index_on[c2, s2])).astype(np.float64)
                        np.maximum(best, gap_w(d1 - d2), out=best)
                init_w[sel] = np.maximum(init_w[sel], best)
        for k1 in sinks1:
            r1 = xmerge1.reachable_matrix(ends1, np.array([k1]))[:, 0] | (ends1 == k1)
            for k2 in sinks2:
                r2 = xmerge2.reachable_matrix(ends2, np.array([k2]))[:, 0] | (ends2 == k2)
                ok = r1 & r2
                if not ok.any():
                    continue
                if not score_edges:
                    fin_w[ok] = np.maximum(fin_w[ok], 0.0)
                    continue
                sel = np.flatnonzero(ok)
                best = np.full(len(sel), _LOWEST)
                # chains vary per end node: loop all chains with masks
                on1 = xmerge1.index_on[:, ends1[sel]] != -1  # (C1, m)
                on2 = xmerge2.index_on[:, ends2[sel]] != -1
                for c1 in range(xmerge1.num_chains):
                    if not on1[c1].any():
                        continue
                    d1 = (int(xmerge1.table[k1, c1]) + int(psdv1[c1, k1])
                          - xmerge1.index_on[c1, ends1[sel]]).astype(np.float64)
                    for c2 in range(xmerge2.num_chains):
                        both = on1[c1] & on2[c2]
                        if not both.any():
                            continue
                        d2 = (int(xmerge2.table[k2, c2]) + int(psdv2[c2, k2])
                              - xmerge2.index_on[c2, ends2[sel]]).astype(np.float64)
                        w = gap_w(d1 - d2)
                        np.maximum(best, np.where(both, w, _LOWEST), out=best)
                fin_w[sel] = np.maximum(fin_w[sel], best)
        min_score = 0.0
        if score_edges:
            best = _LOWEST
            for s1 in sources1:
                for s2 in sources2:
                    for k1 in sinks1:
                        for k2 in sinks2:
                            for c1 in xmerge1.chains_on(s1):
                                d1 = (int(xmerge1.table[k1, c1])
                                      + int(psdv1[c1, k1])
                                      - int(xmerge1.index_on[c1, s1]))
                                for c2 in xmerge2.chains_on(s2):
                                    d2 = (int(xmerge2.table[k2, c2])
                                          + int(psdv2[c2, k2])
                                          - int(xmerge2.index_on[c2, s2]))
                                    g = abs(d1 - d2)
                                    v = 0.0 if g == 0 else float(
                                        (-scale * (go + ge * g)).max())
                                    best = max(best, v)
            min_score = best
        return init_w, fin_w, min_score

    def _assemble_chain(self, chain_ids, matches, set_idx, i1s, i2s,
                        starts1, starts2, ends1, ends2, xmerge1, xmerge2,
                        score_edges, scale, general=False,
                        graph1=None, graph2=None):
        chain = []
        for v in chain_ids:
            m = matches[set_idx[v]]
            chain.append(Anchor(
                walk1=np.asarray(m.walks1[i1s[v]]),
                walk2=np.asarray(m.walks2[i2s[v]]),
                count1=m.count1, count2=m.count2,
                full_length=m.full_length, match_set=set_idx[v],
                idx1=i1s[v], idx2=i2s[v]))
        for a in chain:
            a.score = self.anchor_weight(a)
        if score_edges and chain:
            go = np.array(self.gap_open)
            ge = np.array(self.gap_extend)
            psd1 = psd2 = None
            if general:
                psd1 = _native_psd(graph1, xmerge1)
                psd2 = _native_psd(graph2, xmerge2)
            for i in range(len(chain) - 1):
                a, b = chain[i], chain[i + 1]
                if general:
                    gap = self._gap_measure(
                        a.walk1[-1], b.walk1[0], a.walk2[-1], b.walk2[0],
                        xmerge1, xmerge2, psd1, psd2)
                    gap = int(gap) if gap is not None else 0
                else:
                    d1 = (int(xmerge1.index_on[0, b.walk1[0]])
                          - int(xmerge1.index_on[0, a.walk1[-1]]))
                    d2 = (int(xmerge2.index_on[0, b.walk2[0]])
                          - int(xmerge2.index_on[0, a.walk2[-1]]))
                    gap = d1 - d2
                w = 0.0 if gap == 0 else float(
                    (-scale * (go + ge * abs(gap))).max())
                a.gap_after = gap
                a.gap_score_after = w
                b.gap_before = gap
                b.gap_score_before = w
        return chain

    # ------------------------------------------------------------------

    def _gap_measure(self, from1, to1, from2, to2, xmerge1, xmerge2,
                     psd1, psd2):
        """min |dist1 - dist2| (signed value of the best) over chain pairs,
        mirroring edge_weight's measurement (anchorer.hpp:2551-2581).
        Scalars."""
        best_gap = None
        for c1 in xmerge1.chains_on(from1):
            d1 = int(xmerge1.table[to1, c1]) - int(xmerge1.index_on[c1, from1])
            if psd1 is not None:
                d1 += psd1.distance(to1, c1)
            for c2 in xmerge2.chains_on(from2):
                d2 = int(xmerge2.table[to2, c2]) - int(xmerge2.index_on[c2, from2])
                if psd2 is not None:
                    d2 += psd2.distance(to2, c2)
                gap = d1 - d2
                if best_gap is None or abs(gap) < abs(best_gap):
                    best_gap = gap
        return best_gap

    def _edge_weight_scalar(self, from1, to1, from2, to2, xmerge1, xmerge2,
                            psd1, psd2, scale):
        best = _LOWEST
        for c1 in xmerge1.chains_on(from1):
            d1 = (int(xmerge1.table[to1, c1]) - int(xmerge1.index_on[c1, from1])
                  + psd1.distance(to1, c1))
            for c2 in xmerge2.chains_on(from2):
                d2 = (int(xmerge2.table[to2, c2]) - int(xmerge2.index_on[c2, from2])
                      + psd2.distance(to2, c2))
                gap = abs(d1 - d2)
                if gap == 0:
                    best = max(best, 0.0)
                else:
                    for go, ge in zip(self.gap_open, self.gap_extend):
                        best = max(best, -scale * (go + ge * gap))
        return best

    def _boundary_weights(self, starts1, ends1, starts2, ends2,
                          sources1, sources2, sinks1, sinks2,
                          xmerge1, xmerge2, psd1, psd2, scale, score_edges):
        n = len(starts1)
        init_w = np.full(n, _LOWEST)
        fin_w = np.full(n, _LOWEST)
        for s1 in sources1:
            r1 = xmerge1.reachable_matrix(np.array([s1]), starts1)[0] | (starts1 == s1)
            for s2 in sources2:
                r2 = xmerge2.reachable_matrix(np.array([s2]), starts2)[0] | (starts2 == s2)
                ok = r1 & r2
                if not ok.any():
                    continue
                if score_edges:
                    for v in np.flatnonzero(ok):
                        w = self._edge_weight_scalar(
                            s1, starts1[v], s2, starts2[v],
                            xmerge1, xmerge2, psd1, psd2, scale)
                        init_w[v] = max(init_w[v], w)
                else:
                    init_w[ok] = np.maximum(init_w[ok], 0.0)
        for k1 in sinks1:
            r1 = xmerge1.reachable_matrix(ends1, np.array([k1]))[:, 0] | (ends1 == k1)
            for k2 in sinks2:
                r2 = xmerge2.reachable_matrix(ends2, np.array([k2]))[:, 0] | (ends2 == k2)
                ok = r1 & r2
                if not ok.any():
                    continue
                if score_edges:
                    for v in np.flatnonzero(ok):
                        w = self._edge_weight_scalar(
                            ends1[v], k1, ends2[v], k2,
                            xmerge1, xmerge2, psd1, psd2, scale)
                        fin_w[v] = max(fin_w[v], w)
                else:
                    fin_w[ok] = np.maximum(fin_w[ok], 0.0)
        return init_w, fin_w

    def _empty_chain_score(self, sources1, sources2, sinks1, sinks2,
                           xmerge1, xmerge2, psd1, psd2, scale):
        best = _LOWEST
        for s1 in sources1:
            for s2 in sources2:
                for k1 in sinks1:
                    for k2 in sinks2:
                        best = max(best, self._edge_weight_scalar(
                            s1, k1, s2, k2, xmerge1, xmerge2, psd1, psd2,
                            scale))
        return best

    def _annotate_gaps(self, chain, sources1, sources2, sinks1, sinks2,
                       xmerge1, xmerge2, psd1, psd2, scale):
        """Record measured gaps and gap scores between consecutive anchors
        (reference anchorer.hpp:2430-2470)."""
        for i in range(len(chain) - 1):
            a, b = chain[i], chain[i + 1]
            gap = self._gap_measure(
                a.walk1[-1], b.walk1[0], a.walk2[-1], b.walk2[0],
                xmerge1, xmerge2, psd1, psd2)
            w = self._edge_weight_scalar(
                a.walk1[-1], b.walk1[0], a.walk2[-1], b.walk2[0],
                xmerge1, xmerge2, psd1, psd2, scale)
            a.gap_after = int(gap) if gap is not None else 0
            a.gap_score_after = w
            b.gap_before = int(gap) if gap is not None else 0
            b.gap_score_before = w

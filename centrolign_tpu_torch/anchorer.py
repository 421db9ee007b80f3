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

One engine per algorithm and input. Exhaustive (-g 0) scores no gaps: a
dense DP over anchors x anchors here (the semantics twin of the
reference's exhaustive_chain_dp, anchorer.hpp:1342) below 256 anchors,
the native free-gap sweeps above (chain_dp_seq on chain x chain,
chain_dp_general on other path-covered graphs). Sparse: the native
chain_sparse_parity. SparseAffine: the offline CDQ engines, and the tree
engine for what they refuse or leave unresolved (_chain_affine).

Follows the semantics of centrolign_tpu/anchorer.py, without the parts of
it that no input reaches in the port: the affine half of the Exhaustive
path, its post-switch distance tables and the switch that turns the CDQ
engines off (here the engine is chosen from the input alone). Its two
opt-in device branches, the
SparseAffine CDQ value pass (CENTROLIGN_TPU_DEVICE_CDQ=1, ops/chain_cdq.py)
and free-gap sparse chaining on chain graphs (CENTROLIGN_TPU_DEVICE_CHAIN=1,
ops/chain_scan.py), run on the anchorer's `device` in place of the JAX
package's device_ready() gate: the CUDA kernels on a card, their plain
versions on the CPU, and the native engines when the device is None. A
device failure raises; nothing falls back to the native engine. Unmasked
SparseAffine chaining of inputs that are not chain x chain (the MSA's
graph x graph merges) takes the graph x graph CDQ engine, and masked (-c)
chain x chain chaining the one-family CDQ engine over the anchors the mask
leaves, which the JAX package does not have; their chains are the tree
engine's (_chain_affine).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import metrics
from .score_function import ScoreFunction
from .path_merge import PathMerge

_I64 = np.int64
_LOWEST = -np.inf
# what a CDQ engine returns in place of a chain: the input is not chain x
# chain (the one-family engine), or a tied traceback step went unresolved
_NOT_CHAINS = "not chain x chain"
_UNRESOLVED = "unresolved tie"


def _unmasked(sets, i1s, i2s, masked):
    """Indices of the anchors (sets[k], i1s[k], i2s[k]) that are not in
    the mask, a set of (set, walk1 index, walk2 index). Both sides are
    packed as the tree engine packs them (chain_parity.cpp MatchBankP::
    mask_key: set << 40 | walk1 << 20 | walk2, uint64), so that an anchor
    is masked here exactly where it is masked there."""
    import itertools

    def keys(s, i, j):
        u = np.uint64
        return (s.astype(u) << u(40)) | (i.astype(u) << u(20)) | j.astype(u)

    rows = np.fromiter(itertools.chain.from_iterable(masked), dtype=_I64,
                       count=3 * len(masked)).reshape(-1, 3)
    return np.flatnonzero(~np.isin(keys(sets, i1s, i2s), keys(*rows.T)))


def _traceback(best, backptr):
    """The anchor ids of the chain that ends at `best` (-1: the empty
    chain), first to last, along the backpointers."""
    ids = []
    while best != -1:
        ids.append(best)
        best = int(backptr[best])
    return ids[::-1]


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
    # where the opt-in device chaining runs (a torch.device; None: native)
    device: object = None

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
        if tableau1 is not None:
            from .native import chain_fill_length
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
            return chain_fill_length(graph1, graph2, xmerge1, xmerge2, eps)
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
            if masked_matches is not None:
                # the tree engine's freed working set, beneath the
                # fill-in's threads' own heaps
                from .utils.memory import release_free_heap
                release_free_heap()
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
                and algorithm in (ChainAlgorithm.Sparse,
                                  ChainAlgorithm.SparseAffine)):
            from .native import anchor_fill_in
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
        # below: Exhaustive (-g 0), which costs no gaps: a chain scores the
        # weights of its anchors, and every reachable edge is free

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
            sources1, sources2, sinks1, sinks2)
        if chain_ids is None and n >= 256:
            # general path-covered DAGs: native sweep with canonical-chain
            # trees (the reference's sparse DP structure)
            chain_ids = self._chain_native_general(
                graph1, graph2, starts1, ends1, starts2, ends2, weights,
                xmerge1, xmerge2, sources1, sources2, sinks1, sinks2)
        if chain_ids is not None:
            return self._assemble_chain(chain_ids, matches, set_idx, i1s, i2s)

        # pre-gather per-anchor-start quantities (the "to" side of edges)
        # table rows for every start node: (n, C)
        pred_s1 = xmerge1.table[starts1]          # (n, C1)
        pred_s2 = xmerge2.table[starts2]
        # from-side chain info for every end node
        head_e1 = xmerge1.path_head[ends1]
        head_e2 = xmerge2.path_head[ends2]
        idx_e1 = xmerge1.index_on[np.where(head_e1 == -1, 0, head_e1), ends1]
        idx_e2 = xmerge2.index_on[np.where(head_e2 == -1, 0, head_e2), ends2]

        # initial / final weights
        init_w, fin_w = self._boundary_weights(
            starts1, ends1, starts2, ends2, sources1, sources2,
            sinks1, sinks2, xmerge1, xmerge2)

        # DP over anchors in a valid topological order of the anchor DAG
        # (order by topological position of walk1 start; edges always go
        # strictly forward in that order). Rows of the reachability
        # matrices are computed on the fly: O(n) memory instead of O(n^2).
        topo1 = np.empty(graph1.node_size, dtype=_I64)
        topo1[graph1.topological_order()] = np.arange(graph1.node_size)
        order = np.argsort(topo1[starts1], kind="stable")

        dp = init_w.copy()
        backptr = np.full(n, -1, dtype=_I64)
        best_id, best_score = -1, 0.0
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
            upd = dp[a] > dp[succ]
            dp[succ[upd]] = dp[a]
            backptr[succ[upd]] = a
        return self._assemble_chain(_traceback(best_id, backptr), matches,
                                    set_idx, i1s, i2s)

    def _chain_sparse_scan_device(self, graph1, graph2, matches, num_sets,
                                  weights, sources1, sources2, sinks1,
                                  sinks2, masked):
        """Device realization of free-gap sparse chaining for chain x chain
        inputs (ops/chain_scan.py): the reference's per-path search-tree
        sweep linearizes into one event scan when both graphs are single
        chains (every calibration workload). Returns (rows, scores) in the
        chain_sparse_parity format, or None when the inputs are outside the
        chain envelope (the caller then takes the native engine). Enabled
        by CENTROLIGN_TPU_DEVICE_CHAIN=1 and a device; the scan runs on
        self.device."""
        from .ops.chain_scan import sparse_chain_scan

        def is_chain(g):
            return (g.node_size > 0 and bool((g.out_degrees() <= 1).all())
                    and bool((g.in_degrees() <= 1).all())
                    and int((g.in_degrees() == 0).sum()) == 1)

        if not (is_chain(graph1) and is_chain(graph2)):
            return None
        from .native import reference_topological_order
        order1 = reference_topological_order(graph1)
        order2 = reference_topological_order(graph2)
        pos1 = np.empty(graph1.node_size, dtype=_I64)
        pos1[order1] = np.arange(graph1.node_size)
        pos2 = np.empty(graph2.node_size, dtype=_I64)
        pos2[order2] = np.arange(graph2.node_size)

        s_idx, i1s, i2s = [], [], []
        st1, en1, st2, en2, ws = [], [], [], [], []
        for s in range(num_sets):
            m = matches[s]
            for i in range(len(m.walks1)):
                for j in range(len(m.walks2)):
                    if masked and (s, i, j) in masked:
                        continue
                    s_idx.append(s)
                    i1s.append(i)
                    i2s.append(j)
                    st1.append(m.walks1[i][0])
                    en1.append(m.walks1[i][-1])
                    st2.append(m.walks2[j][0])
                    en2.append(m.walks2[j][-1])
                    ws.append(weights[s])
        n = len(s_idx)
        if n == 0:
            return np.empty((0, 3), dtype=_I64), np.empty(0)
        st1 = np.array(st1, dtype=_I64)
        en1 = np.array(en1, dtype=_I64)
        st2 = np.array(st2, dtype=_I64)
        en2 = np.array(en2, dtype=_I64)

        def reach_gate(nodes1, nodes2, given1, given2, flip):
            # chain reachability == strict topological precedence
            if given1 is None:
                return np.ones(n, dtype=bool)
            ok1 = np.zeros(n, dtype=bool)
            ok2 = np.zeros(n, dtype=bool)
            for g in np.asarray(given1, dtype=_I64):
                if flip:
                    ok1 |= (g == nodes1) | (pos1[nodes1] < pos1[g])
                else:
                    ok1 |= (g == nodes1) | (pos1[g] < pos1[nodes1])
            for g in np.asarray(given2, dtype=_I64):
                if flip:
                    ok2 |= (g == nodes2) | (pos2[nodes2] < pos2[g])
                else:
                    ok2 |= (g == nodes2) | (pos2[g] < pos2[nodes2])
            return ok1 & ok2

        reach_src = reach_gate(st1, st2, sources1, sources2, False)
        reach_snk = reach_gate(en1, en2, sinks1, sinks2, True)

        chain, _score = sparse_chain_scan(
            pos1[st1], pos1[en1], pos2[st2], pos2[en2],
            np.asarray(ws), reach_src, reach_snk, self.device)
        rows = np.empty((len(chain), 3), dtype=_I64)
        scores = np.empty(len(chain))
        for k, a in enumerate(chain):
            rows[k] = (s_idx[a], i1s[a], i2s[a])
            scores[k] = weights[s_idx[a]]
        return rows, scores

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
            import os
            device_rows = None
            if (os.environ.get("CENTROLIGN_TPU_DEVICE_CHAIN") == "1"
                    and self.device is not None):
                device_rows = self._chain_sparse_scan_device(
                    graph1, graph2, matches, num_sets, weights,
                    sources1, sources2, sinks1, sinks2, local_masked)
            if device_rows is not None:
                rows, scores = device_rows
            else:
                rows, scores = chain_sparse_parity(
                    graph1, matches, num_sets, weights, xmerge1, xmerge2,
                    sources1, sources2, sinks1, sinks2, local_masked)
            fvals = np.zeros((len(rows), 3))
            fvals[:, 0] = scores
            grows = np.zeros((len(rows), 2), dtype=_I64)
        else:
            arows, fvals = self._chain_affine(
                matches, graph1, graph2, xmerge1, xmerge2, sources1,
                sources2, sinks1, sinks2, scale, local_masked, num_sets,
                num_anchors, max_match_size, weights)
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

    def _chain_affine(self, matches, graph1, graph2, xmerge1, xmerge2,
                      sources1, sources2, sinks1, sinks2, scale, masked,
                      num_sets, num_anchors, max_match_size, weights):
        """SparseAffine chaining in chain_affine_parity's output format.

        Offline CDQ value engines, bit-identical to the tree sweep
        (validated against it: 0/145331 dp mismatches on the benchmark pair
        input), with traceback ties resolved exactly by the host replica of
        the trees' walk (chain_ties.py): chain x chain inputs, masked (-c)
        or not, the one-family engine, every other unmasked input the
        graph x graph engine over all (path1, path2) families. The tree
        engine (chain_affine_parity) takes masked inputs that are not
        chain x chain and a chaining whose tied step the replica cannot
        resolve. Records an unmasked chaining's anchors and seconds under
        metrics tags chain.cdq, chain.tree and chain.tree_fallback, and a
        masked chaining's under chain.masked and, by the engine that
        answered, chain.masked_cdq or chain.masked_tree."""
        from .native import chain_affine_parity

        t0 = metrics.timer()
        tag = "chain.tree"
        res = self._chain_affine_cdq(
            matches, graph1, graph2, xmerge1, xmerge2,
            sources1, sources2, sinks1, sinks2, scale,
            num_sets, num_anchors, max_match_size, weights, masked)
        if res is _NOT_CHAINS:
            # the graph engine takes no mask: a masked input out of the
            # one-family engine's reach keeps the tree engine
            res = None if masked else self._chain_affine_graph_cdq(
                matches, graph1, graph2, xmerge1, xmerge2,
                sources1, sources2, sinks1, sinks2, scale,
                num_sets, num_anchors, max_match_size, weights)
        if res is _UNRESOLVED:
            res, tag = None, "chain.tree_fallback"
        elif res is not None:
            tag = "chain.cdq"
        if res is None:
            res = chain_affine_parity(
                graph1, graph2, matches, num_sets, weights, xmerge1,
                xmerge2, self.gap_open, self.gap_extend, scale,
                sources1, sources2, sinks1, sinks2,
                num_anchors, max_match_size, masked)
        cells = sum(len(m.walks1) * len(m.walks2)
                    for m in matches[:num_sets])
        seconds = metrics.timer() - t0
        if masked:
            metrics.record("chain.masked", cells, seconds)
            metrics.record("chain.masked_cdq" if tag == "chain.cdq"
                           else "chain.masked_tree", cells, seconds)
        else:
            metrics.record(tag, cells, seconds)
        return res

    # ------------------------------------------------------------------
    # SparseAffine chain x chain via offline CDQ (native/chain_affine_cdq.cpp)

    def _chain_affine_cdq(self, matches, graph1, graph2, xmerge1, xmerge2,
                          sources1, sources2, sinks1, sinks2, scale,
                          num_sets, num_anchors, max_match_size, weights,
                          masked=None):
        """Reference-exact SparseAffine chaining on chain x chain inputs
        through the O(n log^2 n) CDQ value engine plus host-side traceback.
        DP values are bit-identical to the tree sweep (same f32/f64 rounding
        sequence, reference anchorer.hpp:2290-2420); backpointer ties on the
        traceback path are resolved in-process by chain_ties.AffineTieResolver
        (a rank-arithmetic replica of the tree visit order), and only an
        unresolved walk (resolve() -> None) falls back to the tree engine.

        A masked (set, walk1, walk2) is left out of the input. The tree
        sweep skips it in each of its enumerations (MatchBankP::for_each,
        for_starts_on, for_ends_on): it never enters a tree's static
        layout, never gets a dp value, and is never a predecessor nor a
        candidate for opt. Its trees are thus the unmasked sweep's over the
        anchors that remain, keyed by the same MatchBank ids, whose order
        the remaining anchors keep here. So everything below runs on the
        filtered arrays as it does unmasked: the sources' lead term, the
        value pass, the sinks' final term and opt's first-in-order pick,
        the traceback, the tie resolver (its trees are the masked sweep's)
        and the rows' set and walk indices.

        Returns (arows, fvals) in chain_affine_parity's output format,
        _NOT_CHAINS when the input is not chain x chain, or _UNRESOLVED."""

        def is_chain(g):
            return (g.node_size > 0 and bool((g.out_degrees() <= 1).all())
                    and bool((g.in_degrees() <= 1).all())
                    and int((g.in_degrees() == 0).sum()) == 1)

        if xmerge1.num_chains > 2 or xmerge2.num_chains > 2:
            return _NOT_CHAINS
        if not (is_chain(graph1) and is_chain(graph2)):
            return _NOT_CHAINS
        idx1 = np.asarray(xmerge1.index_on[0], dtype=_I64)
        idx2 = np.asarray(xmerge2.index_on[0], dtype=_I64)

        flat = self._flat_anchors(matches, num_sets)
        if masked:
            keep = _unmasked(*flat[:3], masked)
            flat = tuple(a[keep] for a in flat)
        sid, i1s, i2s, as1, ae1, as2, ae2 = flat
        del flat
        if len(sid) == 0:
            return (np.empty((0, 5), dtype=_I64), np.empty((0, 3)))
        ps1, pe1, ps2, pe2 = idx1[as1], idx1[ae1], idx2[as2], idx2[ae2]
        if (ps1 < 0).any() or (pe1 < 0).any() or (ps2 < 0).any() \
                or (pe2 < 0).any():
            return _NOT_CHAINS
        for nodes, idx in ((sources1, idx1), (sources2, idx2),
                           (sinks1, idx1), (sinks2, idx2)):
            if nodes is not None and len(nodes) and \
                    (idx[np.asarray(nodes, dtype=_I64)] < 0).any():
                return _NOT_CHAINS

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

        dp, bp, tie, struct, stored, _qs = self._cdq_values(
            ps1, pe1, ps2, pe2, aw, init, go, ge, scale)

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
                    int(here), int(struct[here]), stored[here])
                if here2 is None:
                    return _UNRESOLVED
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

    def _chain_affine_graph_cdq(self, matches, graph1, graph2, xmerge1,
                                xmerge2, sources1, sources2, sinks1, sinks2,
                                scale, num_sets, num_anchors, max_match_size,
                                weights):
        """Reference-exact SparseAffine chaining of any unmasked input
        through the graph x graph CDQ pass (native chain_affine_graph_cdq):
        the tree sweep's timeline over every (path1, path2) family, solved
        offline, with bit-identical dp values. The traceback follows the
        backpointers; a step whose winning channel had several achievers is
        resolved by chain_ties.GraphTieResolver, the replica of that
        family's trees at the query's time. Returns (arows, fvals) in
        chain_affine_parity's output format, None when the input is outside
        the engine's reach, or _UNRESOLVED."""
        from .native import AffineGraphCDQ, reference_topological_order

        eng = AffineGraphCDQ(graph1, graph2, matches, num_sets, weights,
                             xmerge1, xmerge2, self.gap_open,
                             self.gap_extend, scale, sources1, sources2,
                             sinks1, sinks2, num_anchors, max_match_size)
        got = eng.values()
        if got is None:
            return None
        (dp, bp, tie, struct, stored, qtime, qfam, qshift, qoff,
         _init), opt = got

        rev = []
        here = opt
        resolver = None
        c2 = xmerge2.num_chains
        while here != -1:
            rev.append(here)
            if not tie[here]:
                here = int(bp[here])
                continue
            if resolver is None:
                from .chain_ties import GraphTieResolver
                _, _, _, _, e1, _, e2 = self._flat_anchors(matches, num_sets)
                order = reference_topological_order(graph1)
                rank1 = np.empty(graph1.node_size, dtype=_I64)
                rank1[order] = np.arange(graph1.node_size)
                resolver = GraphTieResolver(
                    e1, e2, xmerge1.index_on, xmerge2.index_on, rank1, dp,
                    self.gap_extend, scale)
            p1, p2 = divmod(int(qfam[here]), c2)
            here = resolver.resolve(here, int(struct[here]), stored[here],
                                    qtime[here], p1, p2, qshift[here],
                                    qoff[here])
            if here is None:
                return _UNRESOLVED
        rev.reverse()
        return eng.annotate(rev)

    @staticmethod
    def _flat_anchors(matches, num_sets):
        """(set, walk1 index, walk2 index, start1, end1, start2, end2) of
        every anchor of the first num_sets match sets, in MatchBank id
        order: set-major, then walk1, then walk2."""
        sets = [m for m in matches[:num_sets]
                if len(m.walks1) and len(m.walks2)]
        keep = [s for s in range(num_sets)
                if len(matches[s].walks1) and len(matches[s].walks2)]
        if not sets:
            return tuple(np.empty(0, dtype=_I64) for _ in range(7))
        n1 = np.array([len(m.walks1) for m in sets], dtype=_I64)
        n2 = np.array([len(m.walks2) for m in sets], dtype=_I64)
        ends = [np.concatenate([np.asarray(getattr(m, w), dtype=_I64)[:, c]
                                for m in sets])
                for w, c in (("walks1", 0), ("walks1", -1),
                             ("walks2", 0), ("walks2", -1))]
        cnt = n1 * n2
        k = np.repeat(np.arange(len(sets)), cnt)
        within = np.arange(int(cnt.sum()), dtype=_I64) - np.repeat(
            np.cumsum(cnt) - cnt, cnt)
        i1s, i2s = np.divmod(within, n2[k])
        base1 = (np.cumsum(n1) - n1)[k] + i1s
        base2 = (np.cumsum(n2) - n2)[k] + i2s
        return (np.asarray(keep, dtype=_I64)[k], i1s, i2s,
                ends[0][base1], ends[1][base1], ends[2][base2],
                ends[3][base2])

    def _cdq_values(self, ps1, pe1, ps2, pe2, aw, init, go, ge, scale):
        """CDQ value pass: dp/bp/tie/struct/stored/qshift per anchor.

        With CENTROLIGN_TPU_DEVICE_CDQ=1 and a device, the device
        realization (ops/chain_cdq.py: the CUDA scan of csrc/chain_cdq.cu on
        a card, its plain version on the CPU); a failure there raises.
        Otherwise the native engine (native/chain_affine_cdq.cpp). Outputs
        are bit-identical between the two (tests/test_torch_chain_cdq.py)."""
        import os
        if (os.environ.get("CENTROLIGN_TPU_DEVICE_CDQ") == "1"
                and self.device is not None):
            from .ops.chain_cdq import chain_cdq_device
            return chain_cdq_device(ps1, pe1, ps2, pe2, aw, init, go, ge,
                                    scale, self.device)
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
                      xmerge1, xmerge2, sources1, sources2, sinks1, sinks2):
        """Dispatch to the native CDQ sweep when both graphs are single
        chains; returns chain ids or None if not applicable."""
        from .native import chain_dp_seq

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
        best, backptr, _dp = chain_dp_seq(p1s, p1e, p2s, p2e, weights)
        return _traceback(best, backptr)

    def _chain_native_general(self, graph1, graph2, starts1, ends1,
                              starts2, ends2, weights, xmerge1, xmerge2,
                              sources1, sources2, sinks1, sinks2):
        from .native import chain_dp_general

        # canonical chain per node (graph2: and index on it)
        chain1 = xmerge1.path_head
        chain2 = xmerge2.path_head
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

        init_w, fin_w = self._boundary_weights(
            starts1, ends1, starts2, ends2, sources1, sources2, sinks1,
            sinks2, xmerge1, xmerge2)

        best, backptr, _dp = chain_dp_general(
            starts1, ends1, starts2, ends2, weights, init_w, fin_w,
            topo1, chain1, xmerge1.table, chain1_nodes,
            chain1_offsets, chain2, idx2, xmerge2.table)
        return _traceback(best, backptr)

    def _boundary_weights(self, starts1, ends1, starts2, ends2,
                          sources1, sources2, sinks1, sinks2,
                          xmerge1, xmerge2):
        """Free-gap source/sink boundary weights per anchor: 0 where a
        source pair reaches its starts (its ends reach a sink pair),
        -inf elsewhere; 0 throughout without global anchoring."""
        n = len(starts1)
        if sources1 is None:
            return np.zeros(n), np.zeros(n)
        init_w = np.full(n, _LOWEST)
        fin_w = np.full(n, _LOWEST)
        for s1 in sources1:
            r1 = xmerge1.reachable_matrix(np.array([s1]), starts1)[0] | (starts1 == s1)
            for s2 in sources2:
                r2 = xmerge2.reachable_matrix(np.array([s2]), starts2)[0] | (starts2 == s2)
                init_w[r1 & r2] = 0.0
        for k1 in sinks1:
            r1 = xmerge1.reachable_matrix(ends1, np.array([k1]))[:, 0] | (ends1 == k1)
            for k2 in sinks2:
                r2 = xmerge2.reachable_matrix(ends2, np.array([k2]))[:, 0] | (ends2 == k2)
                fin_w[r1 & r2] = 0.0
        return init_w, fin_w

    def _assemble_chain(self, chain_ids, matches, set_idx, i1s, i2s):
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
        return chain

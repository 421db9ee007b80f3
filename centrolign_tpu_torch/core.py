"""Top-level orchestrator: owns the pipeline stages and drives the
progressive alignment (reference core.hpp:30, src/core.cpp).

Pipeline per pairwise subproblem (reference core.hpp:256-403):
sentinel reassignment -> match finding -> PathMerge reachability ->
anchor chain -> partition -> despecify -> stitch -> fuse.

Calibration (reference src/core.cpp:96-194): per leaf, self-matches are
subset to the diagonal, a gap-free chain is computed, and the score scale is
the mean of the per-leaf (weight / anchored length) ratios.

Copy of centrolign_tpu/core.py, with a `device` argument that places its
stitcher's device tier and its anchorer's opt-in device chaining.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from . import logging as logmod
from .utils.memory import log_memory_usage
from .anchorer import Anchorer, ChainAlgorithm
from .alignment import fuse, internal_fuse, cigar as cigar_of
from .bonder import Bonder
from .execution import Execution, Subproblem
from .match_finder import find_matches, MatchSet
from .modify_graph import (SentinelTableau, purge_uncovered_nodes,
                           reassign_sentinels, simplify_bubbles)
from .snarls import InconsistencyIdentifier
from .partitioner import Partitioner
from .path_merge import PathMerge
from .score_function import ScoreFunction
from .stitcher import Stitcher
from .tree import Tree
from .device import resolve_device
from .io.gfa import write_gfa, read_gfa
from .modify_graph import add_sentinels


def prepare_pair_step(sub1, sub2, max_count, score_function,
                      match_finder=None, memory_restraint_size=1 << 30):
    """The scale-independent front half of one pairwise subproblem:
    sentinel reassignment, match finding, reachability. None of it reads
    the calibrated ``score_function.score_scale`` (anchor_weight is
    scale-free; the scale enters only at anchoring), so the multi-host
    scheduler overlaps this work with calibration. Returns
    (matches, xm1, xm2, merge_cls)."""
    reassign_sentinels(sub1.graph, sub1.tableau, 5, 6)
    reassign_sentinels(sub2.graph, sub2.tableau, 7, 8)
    logmod.log(logmod.Verbose, "Finding matches.")
    if match_finder is None:
        matches = find_matches(sub1.graph, sub2.graph,
                               sub1.tableau, sub2.tableau,
                               max_count, score_function)
    else:
        matches = match_finder.find_matches(
            sub1.graph, sub2.graph, sub1.tableau, sub2.tableau)
    logmod.log(logmod.Verbose, "Computing reachability.")
    # memory tier selection (reference core.hpp:310-327, replicating its
    # total-size expression): bit-packed tables above the restraint
    from .path_merge import PackedPathMerge
    total_size = (sub1.graph.node_size * sub1.graph.path_size
                  + sub2.graph.node_size + sub2.graph.path_size)
    merge_cls = (PackedPathMerge if total_size > memory_restraint_size
                 else PathMerge)
    xm1 = merge_cls(sub1.graph, sub1.tableau)
    xm2 = merge_cls(sub2.graph, sub2.tableau)
    log_memory_usage(logmod.Debug)
    return matches, xm1, xm2, merge_cls


def pairwise_align_step(sub1, sub2, max_count, score_function, anchorer,
                        partitioner, stitcher, match_finder=None,
                        is_main_execution=True,
                        memory_restraint_size=1 << 30,
                        prepared=None) -> np.ndarray:
    """One pairwise graph-graph alignment (the compute of one subproblem,
    reference core.hpp:256-403 minus the fuse): sentinel reassignment,
    match finding, reachability, chain/partition/stitch. Shared by the
    serial Core.do_execution and the multi-host scheduler workers.
    `prepared` accepts a precomputed prepare_pair_step result."""
    from .path_merge import PackedPathMerge
    if prepared is None:
        prepared = prepare_pair_step(
            sub1, sub2, max_count, score_function, match_finder,
            memory_restraint_size)
    matches, xm1, xm2, merge_cls = prepared
    anchors = anchorer.anchor_chain(
        matches, sub1.graph, sub2.graph, sub1.tableau, sub2.tableau,
        xm1, xm2)
    logmod.log(logmod.Verbose, f"Chained {len(anchors)} anchors.")
    segments = partitioner.partition_anchors(
        anchors, sub1.graph, sub2.graph, sub1.tableau, sub2.tableau,
        xm1, xm2, not is_main_execution)
    logmod.log(logmod.Verbose,
               f"Partitioned into {len(segments)} alignable segments; "
               "stitching.")
    segments = [stitcher.despecify_indel_breakpoints(seg)
                for seg in segments]
    aln = stitcher.stitch(
        segments, sub1.graph, sub2.graph, sub1.tableau, sub2.tableau,
        xm1, xm2)
    if merge_cls is PackedPathMerge:
        xm1.release()
        xm2.release()
    log_memory_usage(logmod.Debug)
    return aln


def fuse_step(sub1, sub2, alignment, preserve=False):
    """Fuse child graphs along the alignment into the parent graph
    (reference core.hpp:369-389). Returns (graph, tableau)."""
    logmod.log(logmod.Verbose, "Fusing MSAs along the alignment.")
    fused = sub1.graph.copy() if preserve else sub1.graph
    fuse(fused, sub2.graph, sub1.tableau, sub2.tableau, alignment)
    return fused, sub1.tableau


def leaf_intrinsic_scale(sub, max_count, score_function, anchorer):
    """Per-leaf self-match + scale estimate (the per-leaf body of
    calibration, reference src/core.cpp:122-175). Returns
    (scale, matches, chain) — matches/chain feed the -c bonding rounds."""
    from .path_merge import ChainMerge
    reassign_sentinels(sub.graph, sub.tableau, 5, 6)
    dummy = SentinelTableau(
        src_id=sub.tableau.src_id, snk_id=sub.tableau.snk_id,
        src_sentinel=7, snk_sentinel=8)
    matches = find_matches(sub.graph, sub.graph, sub.tableau, dummy,
                           max_count, score_function)
    diagonal = []
    for ms in matches:
        for walk in ms.walks1:
            diagonal.append(MatchSet(
                walks1=walk[None, :], walks2=walk[None, :],
                count1=ms.count1, count2=ms.count2,
                full_length=ms.full_length))
    xm = ChainMerge(sub.graph, sub.tableau)
    chain_out = []
    scale = anchorer.estimate_score_scale(
        diagonal, sub.graph, sub.graph, sub.tableau, dummy,
        xm, xm, chain_out=chain_out)
    return scale, matches, chain_out


def leaf_bond_alignments(sub, scale, matches, chain, anchorer, bonder,
                         stitcher, max_rounds, collect_raw=False):
    """The per-leaf tandem-duplication bonding rounds (reference
    src/core.cpp:176-297): masked secondary chaining -> bond identification
    -> internal stitch, iterated until no bonds. Independent across leaves
    once the global score scale is calibrated (the anchor budget reads it),
    which is what lets the multi-host scheduler farm leaves out to workers.

    Returns (bond_alns, raw_alns): bond_alns are (path name, alignment in
    path-offset coordinates); raw_alns (only when collect_raw) are the
    untranslated stitch alignments in the order the reference would write
    them with --bonds."""
    from .extractor import StepIndex
    from .path_merge import PathMerge

    path_merge = PathMerge(sub.graph, sub.tableau)
    mask = Core.generate_diagonal_mask(matches)
    logmod.log(logmod.Debug,
               f"Initial mask consists of {len(mask)} matches")
    step_index = None
    bond_alns = []
    raw_alns = []
    for rnd in range(max_rounds):
        logmod.log(
            logmod.Verbose,
            f"Beginning round {rnd + 1} of tandem duplication "
            f"detection for sequence {sub.name}.")
        secondary_chain = anchorer.anchor_chain(
            matches, sub.graph, sub.graph, sub.tableau,
            sub.tableau, path_merge, path_merge,
            masked_matches=mask, override_scale=scale)
        bonds = bonder.identify_bonds(
            sub.graph, sub.graph, sub.tableau, sub.tableau,
            path_merge, path_merge, chain, secondary_chain)
        bonds = bonder.deduplicate_self_bonds(bonds)
        logmod.log(logmod.Verbose,
                   f"Found {len(bonds)} tandem duplications in this round.")
        if not bonds:
            break
        if step_index is None:
            step_index = StepIndex(sub.graph)
        for bond in bonds:
            bond_chain = Core.bonds_to_chain(sub.graph, bond)
            aln = stitcher.internal_stitch(bond_chain, sub.graph, path_merge)
            if collect_raw:
                raw_alns.append(aln)
            aln = aln.copy()
            for r in range(len(aln)):
                if aln[r, 0] != -1:
                    aln[r, 0] = step_index.path_steps(int(aln[r, 0]))[0][1]
                if aln[r, 1] != -1:
                    aln[r, 1] = step_index.path_steps(int(aln[r, 1]))[0][1]
            bond_alns.append((sub.graph.path_name(0), aln))
        if rnd != max_rounds:
            Core.update_mask(matches, secondary_chain, mask, True)
            logmod.log(logmod.Debug,
                       f"Updated mask consists of {len(mask)} matches")
    return bond_alns, raw_alns


class Core:
    def __init__(self, names_and_sequences, tree: Tree,
                 device: torch.device | str | None = None):
        """`device` places the stitcher's device tier and the anchorer's
        opt-in device chaining: a torch.device, or a mode of
        device.resolve_device ("cuda", "cpu", "none"; None reads
        CENTROLIGN_TORCH_DEVICE)."""
        if not isinstance(device, torch.device):
            device = resolve_device(device)
        self.score_function = ScoreFunction()
        self.anchorer = Anchorer(score_function=self.score_function,
                                 device=device)
        self.partitioner = Partitioner(score_function=self.score_function)
        self.stitcher = Stitcher(device=device)
        self.bonder = Bonder()
        self.inconsistency_identifier = InconsistencyIdentifier()
        self.main_execution = Execution(names_and_sequences, tree)
        self.max_tandem_duplication_search_rounds = 3

        # params pushed in by config (reference parameters.cpp apply())
        self.max_count = 3000
        self.skip_calibration = False
        self.preserve_subproblems = False
        self.cyclize_tandem_duplications = False
        self.subproblems_prefix = ""
        self.subalignments_filepath = ""
        self.induced_pairwise_prefix = ""
        self.bonds_prefix = ""
        self.memory_restraint_size = 1 << 30
        self.threads = 1
        self._restarted_bond_alignments = None

    # ------------------------------------------------------------------

    def execute(self) -> None:
        bond_alignments = []
        if self._restarted_bond_alignments is not None:
            bond_alignments = self._restarted_bond_alignments
            if not self.skip_calibration:
                self.calibrate_anchor_scores_and_identify_bonds()
        elif not self.skip_calibration or self.cyclize_tandem_duplications:
            bond_alignments = self.calibrate_anchor_scores_and_identify_bonds()
        if self.cyclize_tandem_duplications and self.subproblems_prefix \
                and self._restarted_bond_alignments is None:
            self.emit_restart_bonds(bond_alignments)
        logmod.log(logmod.Minimal, "Beginning MSA.")
        self.do_execution(self.main_execution, is_main_execution=True)
        if self.induced_pairwise_prefix:
            self.output_pairwise_alignments(False)
        if self.cyclize_tandem_duplications:
            self.apply_bonds(bond_alignments)
            if self.induced_pairwise_prefix:
                logmod.log(logmod.Verbose,
                           "Outputting non-colinear pairwise alignments")
                self.output_pairwise_alignments(True)

    def calibrate_anchor_scores_and_identify_bonds(self):
        """(reference src/core.cpp:96-299). Returns bond alignments (list of
        (path name, alignment in path-offset coordinates))."""
        from .path_merge import ChainMerge
        logmod.log(logmod.Basic,
                   "Calibrating scale of anchoring parameters."
                   if not self.cyclize_tandem_duplications else
                   "Calibrating scale of anchoring parameters and "
                   "identifying tandem duplications.")
        log_memory_usage(logmod.Debug)
        scales = []
        bond_alns = []
        match_query_memo = []
        leaves = list(self.main_execution.leaf_subproblems())
        for i, sub in enumerate(leaves):
            logmod.log(logmod.Verbose,
                       f"Estimating scale for sequence {i + 1}.")
            scale, matches, chain_out = leaf_intrinsic_scale(
                sub, self.max_count, self.score_function, self.anchorer)
            scales.append(scale)
            logmod.log(logmod.Debug,
                       f"Computed intrinsic scale of {scale} for sequence {sub.name}")
            if self.cyclize_tandem_duplications:
                match_query_memo.append((matches, chain_out))
            log_memory_usage(logmod.Debug)
        if not self.skip_calibration and scales:
            self.score_function.score_scale = float(np.mean(scales))

        if (self.cyclize_tandem_duplications
                and self._restarted_bond_alignments is None):
            for i, sub in enumerate(leaves):
                matches, chain = match_query_memo[i]
                alns, raw = leaf_bond_alignments(
                    sub, scales[i], matches, chain, self.anchorer,
                    self.bonder, self.stitcher,
                    self.max_tandem_duplication_search_rounds,
                    collect_raw=bool(self.bonds_prefix))
                if self.bonds_prefix:
                    for k, raw_aln in enumerate(raw):
                        self.output_bond_alignment(raw_aln, sub.graph, 0, k)
                bond_alns.extend(alns)
        return bond_alns

    calibrate_anchor_scores = calibrate_anchor_scores_and_identify_bonds

    # -- cyclization helpers (reference src/core.cpp:301-360, 406-424) ----

    @staticmethod
    def generate_diagonal_mask(matches):
        mask = set()
        for i, ms in enumerate(matches):
            start_to_idx = {int(w[0]): j for j, w in enumerate(ms.walks1)}
            for k, w2 in enumerate(ms.walks2):
                j = start_to_idx.get(int(w2[0]))
                if j is not None:
                    mask.add((i, j, k))
        return mask

    @staticmethod
    def update_mask(matches, chain, mask, mask_reciprocal=True):
        paired = {}
        for a in chain:
            for i in range(len(a.walk1)):
                paired[int(a.walk1[i])] = int(a.walk2[i])
                if mask_reciprocal:
                    paired[int(a.walk2[i])] = int(a.walk1[i])
        for i, ms in enumerate(matches):
            L = ms.walks1.shape[1]
            walk2_node = [dict() for _ in range(L)]
            for k, w2 in enumerate(ms.walks2):
                for l in range(L):
                    walk2_node[l].setdefault(int(w2[l]), []).append(k)
            for j, w1 in enumerate(ms.walks1):
                for l in range(L):
                    pr = paired.get(int(w1[l]))
                    if pr is not None:
                        for k in walk2_node[l].get(pr, ()):
                            mask.add((i, j, k))

    @staticmethod
    def bonds_to_chain(graph, bond_interval):
        from .anchorer import Anchor
        chain = []
        for bond in bond_interval:
            p1 = graph.path(graph.path_id(bond.path1))
            p2 = graph.path(graph.path_id(bond.path2))
            chain.append(Anchor(
                walk1=np.asarray(
                    p1[bond.offset1:bond.offset1 + bond.length]),
                walk2=np.asarray(
                    p2[bond.offset2:bond.offset2 + bond.length]),
                count1=1, count2=1, full_length=bond.length,
                score=bond.score))
        return chain

    def output_bond_alignment(self, aln, graph, path_id, bond_number):
        """(reference core.hpp:427-501): explicit CIGAR of the bond alignment
        padded with full-sequence leading/trailing indels."""
        from .alignment import explicit_cigar, GAP
        name = (f"{self.bonds_prefix}_{graph.path_name(path_id)}"
                f"_cigar_{bond_number}.txt")
        first1 = first2 = last1 = last2 = -1
        for r in range(len(aln)):
            if first1 == -1 and aln[r, 0] != -1:
                first1 = int(aln[r, 0])
            if first2 == -1 and aln[r, 1] != -1:
                first2 = int(aln[r, 1])
            if first1 != -1 and first2 != -1:
                break
        for r in range(len(aln) - 1, -1, -1):
            if last1 == -1 and aln[r, 0] != -1:
                last1 = int(aln[r, 0])
            if last2 == -1 and aln[r, 1] != -1:
                last2 = int(aln[r, 1])
            if last1 != -1 and last2 != -1:
                break
        with open(name, "w") as f:
            if first1 == -1:
                f.write("\n")
                return
            path = graph.path(path_id)
            rows = []
            for v in path:
                if int(v) == first1:
                    break
                rows.append((int(v), GAP))
            for v in path:
                if int(v) == first2:
                    break
                rows.append((GAP, int(v)))
            rows.extend((int(a), int(b)) for a, b in aln)
            tail = []
            for v in path[::-1]:
                if int(v) == last2:
                    break
                tail.append((GAP, int(v)))
            for v in path[::-1]:
                if int(v) == last1:
                    break
                tail.append((int(v), GAP))
            rows.extend(reversed(tail))
            padded = np.array(rows, dtype=np.int64).reshape(-1, 2)
            f.write(explicit_cigar(padded, graph.labels, graph.labels)
                    + "\n")

    def apply_bonds(self, bond_alignments) -> None:
        """(reference src/core.cpp:594-648): fuse the bond alignments into
        the root graph, simplify its bubbles, then run the polish pass
        (polish_cyclized_graph, src/core.cpp:650-767)."""
        if not bond_alignments:
            return
        logmod.log(logmod.Basic, "Cyclizing the final graph.")
        root = self.root_subproblem()
        alns = []
        for (path_name, aln) in bond_alignments:
            pid = root.graph.path_id(path_name)
            path = root.graph.path(pid)
            aln = aln.copy()
            m1 = aln[:, 0] != -1
            m2 = aln[:, 1] != -1
            aln[m1, 0] = path[aln[m1, 0]]
            aln[m2, 1] = path[aln[m2, 1]]
            alns.append(aln)
        fused, tab, _ = internal_fuse(root.graph, alns, root.tableau)
        fused = simplify_bubbles(fused, tab)
        logmod.log(logmod.Debug,
                   f"Cyclized graph reduces from {root.graph.node_size} to "
                   f"{fused.node_size} nodes after merging.")
        root.graph = fused
        root.tableau = tab
        root.alignment = np.empty((0, 2), dtype=np.int64)
        self.polish_cyclized_graph(root)

    def polish_cyclized_graph(self, subproblem: Subproblem) -> None:
        """Realign regions of the cyclized graph flagged as inconsistent
        (reference src/core.cpp:650-767)."""
        from .extractor import StepIndex
        from .induced_match_finder import InducedMatchFinder
        from .utils.encoding import decode_seq

        logmod.log(logmod.Basic,
                   "Polishing inconsistencies in the cyclized alignment")
        inconsistencies = self.inconsistency_identifier \
            .identify_inconsistencies(subproblem.graph, subproblem.tableau)
        logmod.log(logmod.Verbose,
                   f"Identified {len(inconsistencies)} local regions that "
                   "may need realignment")
        if not inconsistencies:
            return
        step_index = StepIndex(subproblem.graph)
        logmod.log(logmod.Verbose,
                   "Querying global matches to obtain match count "
                   "statistics.")
        reassign_sentinels(subproblem.graph, subproblem.tableau, 5, 6)
        # fictitious second tableau so the self-match query treats the two
        # copies as distinct inputs (reference src/core.cpp:688-696)
        dummy_tableau = SentinelTableau(
            src_id=subproblem.tableau.src_id,
            snk_id=subproblem.tableau.snk_id,
            src_sentinel=7, snk_sentinel=8)
        full_match_set = find_matches(
            subproblem.graph, subproblem.graph,
            subproblem.tableau, dummy_tableau,
            self.max_count, self.score_function)

        logmod.log(logmod.Verbose,
                   "Localizing matches to positions inside realignment "
                   "subproblems.")
        induced = InducedMatchFinder(subproblem.graph, full_match_set,
                                     inconsistencies, step_index)

        realigned = []
        for i, (left, right) in enumerate(inconsistencies):
            path_locations = {}
            for p, s in step_index.path_steps(left):
                path_locations.setdefault(p, ([], []))[0].append(s)
            for p, s in step_index.path_steps(right):
                path_locations.setdefault(p, ([], []))[1].append(s)
            path_ids = sorted(path_locations)
            subpath_intervals = []
            subpaths = []
            for path_id in path_ids:
                firsts, seconds = path_locations[path_id]
                firsts.sort()
                seconds.sort()
                if len(firsts) != len(seconds):
                    raise RuntimeError("Path starts or ends in the middle "
                                       "of a cycle realignment interval")
                path = subproblem.graph.path(path_id)
                for k in range(len(firsts)):
                    subpath_intervals.append((path_id, firsts[k], seconds[k]))
                    name = self.get_subpath_name(
                        subproblem.graph.path_name(path_id),
                        firsts[k], seconds[k])
                    seq = decode_seq(subproblem.graph.labels[
                        path[firsts[k]:seconds[k] + 1]])
                    subpaths.append((name, seq))
            logmod.log(logmod.Verbose,
                       f"Performing realignment problem {i + 1} of "
                       f"{len(inconsistencies)}.")
            expanded_tree = self.make_copy_expanded_tree(subpath_intervals,
                                                         subpaths)
            realignment = Execution(subpaths, expanded_tree,
                                    suppress_logging=True)
            self.do_execution(realignment, is_main_execution=False,
                              match_finder=induced.component_view(i))
            realigned.append(realignment.root_subproblem())

        self.integrate_polished_subgraphs(subproblem, realigned)

    @staticmethod
    def get_subpath_name(path_name: str, begin: int, end: int) -> str:
        """(reference src/core.cpp:383-385)"""
        return f"{path_name}:{begin}-{end}"

    @staticmethod
    def parse_subpath_name(subpath_name: str):
        """(reference src/core.cpp:387-395: split on the last ':')"""
        sep = subpath_name.rfind(":")
        rng = subpath_name[sep + 1:]
        dash = rng.index("-")
        return subpath_name[:sep], int(rng[:dash]), int(rng[dash + 1:])

    def make_copy_expanded_tree(self, subpath_intervals, subpaths) -> Tree:
        """Expand the guide tree so each subpath copy gets its own leaf
        (reference src/core.cpp:769-847)."""
        tree = self.main_execution.tree

        copies: dict[str, list[str]] = {}
        for idx in sorted(range(len(subpath_intervals)),
                          key=lambda i: subpath_intervals[i]):
            name = self.parse_subpath_name(subpaths[idx][0])[0]
            copies.setdefault(name, []).append(subpaths[idx][0])

        # copy count per subtree: 0 = unobserved, -1 = inconsistent
        subtree_copy_count = [0] * tree.node_size
        for name, copy_list in copies.items():
            subtree_copy_count[tree.get_id(name)] = len(copy_list)
        for node_id in tree.postorder():
            if tree.is_leaf(node_id):
                continue
            last_count = -2  # sentinel for unobserved
            for child_id in tree.get_children(node_id):
                c = subtree_copy_count[child_id]
                if c == -1 or (last_count != -2 and c != last_count):
                    last_count = -1
                    break
                if c != 0:
                    last_count = c
            if last_count != -2:
                subtree_copy_count[node_id] = last_count

        root = tree.get_root()
        if subtree_copy_count[root] == 0:
            raise RuntimeError("Root is not included in induced subpath tree")

        out = []
        # stack frames: [node id (-1 = virtual), which copy, children, next]
        if subtree_copy_count[root] == -1:
            children = [(c, -1) for c in tree.get_children(root)
                        if subtree_copy_count[c] != 0]
            stack = [[root, -1, children, 0]]
        else:
            stack = [[-1, -1,
                      [(root, i) for i in range(subtree_copy_count[root])],
                      0]]
        while stack:
            top = stack[-1]
            if top[3] == len(top[2]):
                if top[2]:
                    out.append(")")
                if top[0] != -1 and tree.is_leaf(top[0]):
                    if top[1] == -1:
                        raise RuntimeError("Leaf of induced subpath tree was "
                                           "not marked as having consistent "
                                           "count")
                    out.append('"' + copies[tree.label(top[0])][top[1]] + '"')
                dist = 0.0 if top[0] == -1 else tree.distance(top[0])
                if dist != float("inf"):
                    out.append(f":{dist:g}")
                stack.pop()
                continue
            if top[3] == 0:
                out.append("(")
            else:
                out.append(",")
            next_id, which_copy = top[2][top[3]]
            top[3] += 1
            if which_copy == -1 and subtree_copy_count[next_id] != -1:
                # first copy-consistent subtree: virtual node for the copies
                stack.append([-1, -1,
                              [(next_id, i)
                               for i in range(subtree_copy_count[next_id])],
                              0])
            else:
                children = [(c, which_copy) for c in tree.get_children(next_id)
                            if subtree_copy_count[c] != 0]
                stack.append([next_id, which_copy, children, 0])
        out.append(";")

        expanded = Tree("".join(out))
        expanded.compact()
        expanded.binarize()
        return expanded

    def integrate_polished_subgraphs(self, root: Subproblem,
                                     realigned_graphs) -> None:
        """Splice realigned subgraphs back into the root graph and purge the
        replaced nodes (reference src/core.cpp:849-1069)."""
        for realigned in realigned_graphs:
            g, tab = realigned.graph, realigned.tableau
            inject = np.full(g.node_size, -1, dtype=np.int64)
            for node_id in range(g.node_size):
                if node_id != tab.src_id and node_id != tab.snk_id:
                    inject[node_id] = root.graph.add_node(
                        int(g.labels[node_id]))
            for node_id in range(g.node_size):
                if node_id == tab.src_id or node_id == tab.snk_id:
                    continue
                for next_id in g.next(node_id):
                    next_id = int(next_id)
                    if next_id == tab.src_id or next_id == tab.snk_id:
                        continue
                    root.graph.add_edge(int(inject[node_id]),
                                        int(inject[next_id]))
            path_adjacencies = set()
            for path_id in range(g.path_size):
                name, begin, end = self.parse_subpath_name(
                    g.path_name(path_id))
                if begin == end:
                    continue
                root_path_id = root.graph.path_id(name)
                rp = root.graph.path(root_path_id)
                prev_id = (root.tableau.src_id if begin == 0
                           else int(rp[begin - 1]))
                next_id = (root.tableau.snk_id if end + 1 == len(rp)
                           else int(rp[end + 1]))
                sp = g.path(path_id)
                front, back = int(inject[sp[0]]), int(inject[sp[-1]])
                if (prev_id, front) not in path_adjacencies:
                    path_adjacencies.add((prev_id, front))
                    root.graph.add_edge(prev_id, front)
                if (back, next_id) not in path_adjacencies:
                    path_adjacencies.add((back, next_id))
                    root.graph.add_edge(back, next_id)
                root.graph.reassign_subpath(root_path_id, begin, inject[sp])
        root.graph = purge_uncovered_nodes(root.graph, root.tableau)


    def do_execution(self, execution: Execution, is_main_execution: bool,
                     match_finder=None) -> None:
        while not execution.finished():
            parent, sub1, sub2 = execution.next()
            if parent.complete:
                logmod.log(logmod.Verbose,
                           "Problem already finished from restarted run.")
                continue
            parent.alignment = pairwise_align_step(
                sub1, sub2, self.max_count, self.score_function,
                self.anchorer, self.partitioner, self.stitcher,
                match_finder=match_finder,
                is_main_execution=is_main_execution,
                memory_restraint_size=self.memory_restraint_size)
            if self.subalignments_filepath and is_main_execution:
                self.emit_subalignment(parent, sub1, sub2)
            parent.graph, parent.tableau = fuse_step(
                sub1, sub2, parent.alignment,
                preserve=self.preserve_subproblems)
            parent.complete = True
            if not self.preserve_subproblems:
                sub1.graph = None
                sub2.graph = None
            if self.subproblems_prefix and is_main_execution:
                self.emit_subproblem(parent)
            from .native import malloc_trim
            malloc_trim()
            log_memory_usage(logmod.Verbose)

    def align(self, matches, sub1: Subproblem, sub2: Subproblem, xm1, xm2,
              is_main_execution: bool) -> np.ndarray:
        """(reference core.hpp:182-254). Chain + partition + stitch with
        already-computed matches and reachability."""
        anchors = self.anchorer.anchor_chain(
            matches, sub1.graph, sub2.graph, sub1.tableau, sub2.tableau,
            xm1, xm2)
        segments = self.partitioner.partition_anchors(
            anchors, sub1.graph, sub2.graph, sub1.tableau, sub2.tableau,
            xm1, xm2, not is_main_execution)
        segments = [self.stitcher.despecify_indel_breakpoints(seg)
                    for seg in segments]
        return self.stitcher.stitch(
            segments, sub1.graph, sub2.graph, sub1.tableau, sub2.tableau,
            xm1, xm2)

    # ------------------------------------------------------------------

    def emit_restart_bonds(self, bond_alignments) -> None:
        """(reference src/core.cpp:476-490)"""
        with open(f"{self.subproblems_prefix}_bonds.txt", "w") as f:
            for name, aln in bond_alignments:
                f.write(f"#{name}\n")
                for a, b in aln:
                    f.write(f"{int(a)}\t{int(b)}\n")

    def restart_bonds(self) -> None:
        """(reference src/core.cpp:491-521)"""
        if not self.cyclize_tandem_duplications:
            return
        out = []
        with open(f"{self.subproblems_prefix}_bonds.txt") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                if line[0] == "#":
                    out.append((line[1:], []))
                else:
                    a, b = line.split("\t")
                    out[-1][1].append((int(a), int(b)))
        self._restarted_bond_alignments = [
            (name, np.array(rows, dtype=np.int64).reshape(-1, 2))
            for name, rows in out]

    def restart(self) -> None:
        """Reload completed subproblems from -S checkpoint GFAs
        (reference src/execution.cpp:223-279, src/core.cpp:1071-1081).
        Leaf graphs are preserved when calibration will need them."""
        preserve_leaves = self.preserve_subproblems or not self.skip_calibration
        preserve_internal = self.preserve_subproblems
        ex = self.main_execution
        tree = ex.tree
        for node_id in tree.preorder():
            sub = ex.subproblems[node_id]
            if sub.complete:
                continue
            path = self._subproblem_path(node_id)
            if os.path.exists(path):
                with open(path) as f:
                    sub.graph = read_gfa(f)
                sub.tableau = add_sentinels(sub.graph, 5, 6)
                sub.complete = True
                # mark descendants complete; drop graphs we won't need
                stack = list(tree.get_children(node_id))
                while stack:
                    v = stack.pop()
                    dsub = ex.subproblems[v]
                    dsub.complete = True
                    is_leaf = tree.is_leaf(v)
                    if not (preserve_leaves and is_leaf) and not (
                            preserve_internal and not is_leaf):
                        dsub.graph = None
                    stack.extend(tree.get_children(v))
                logmod.log(logmod.Verbose,
                           f"Restarted subproblem {os.path.basename(path)}")
        if self.cyclize_tandem_duplications:
            self.restart_bonds()

    def _subproblem_path(self, node_id: int) -> str:
        h = self.main_execution.subproblem_hash(node_id)
        return f"{self.subproblems_prefix}_{h:016X}.gfa"

    def emit_subproblem(self, sub: Subproblem) -> None:
        """Write a completed subproblem as GFA + info line (reference
        src/core.cpp:397-422)."""
        node_id = self.main_execution.subproblems.index(sub)
        path = self._subproblem_path(node_id)
        with open(path, "w") as f:
            write_gfa(sub.graph, sub.tableau, f)
        info_path = f"{self.subproblems_prefix}_info.txt"
        new_file = not os.path.exists(info_path)
        with open(info_path, "a") as f:
            if new_file:
                f.write("filename\tsequences\n")
            names = ",".join(sorted(
                self.main_execution.leaf_descendents(node_id)))
            f.write(f"{path}\t{names}\n")

    def emit_subalignment(self, parent, sub1, sub2) -> None:
        """(reference src/core.cpp:424-475): per-position table with the
        sequence-name sets of both children."""
        from .extractor import StepIndex
        from .utils.encoding import decode_base
        ex = self.main_execution
        with open(self.subalignments_filepath, "a") as f:
            f.write("# sequence set 1\n")
            for name in ex.leaf_descendents(ex.subproblems.index(sub1)):
                f.write(name + "\n")
            f.write("# sequence set 2\n")
            for name in ex.leaf_descendents(ex.subproblems.index(sub2)):
                f.write(name + "\n")
            si1 = StepIndex(sub1.graph)
            si2 = StepIndex(sub2.graph)
            f.write("# alignment\n")
            for a, b in parent.alignment:
                if a == -1:
                    f.write("-\t-\t-")
                else:
                    pid, step = si1.path_steps(int(a))[0]
                    f.write(f"{sub1.graph.path_name(pid)}\t{step}\t"
                            f"{decode_base(sub1.graph.labels[sub1.graph.path(pid)[step]])}")
                f.write("\t")
                if b == -1:
                    f.write("-\t-\t-")
                else:
                    pid, step = si2.path_steps(int(b))[0]
                    f.write(f"{sub2.graph.path_name(pid)}\t{step}\t"
                            f"{decode_base(sub2.graph.labels[sub2.graph.path(pid)[step]])}")
                f.write("\n")

    def output_pairwise_alignments(self, cyclic: bool) -> None:
        """Induced pairwise alignments between every path pair of the root
        graph: explicit CIGARs for the colinear (acyclic) case, MAF blocks
        after cyclization (reference src/core.cpp:524-591)."""
        from .alignment import induced_pairwise_alignment, explicit_cigar
        from .induced import induced_cyclic_pairwise_alignment, output_maf
        root = self.root_subproblem()
        g = root.graph

        def write_one(i, j):
            n1 = g.path_name(i).replace("/", "_")
            n2 = g.path_name(j).replace("/", "_")
            ext = ".maf" if cyclic else ".txt"
            name = f"{self.induced_pairwise_prefix}_{n1}_{n2}{ext}"
            with open(name, "w") as f:
                if cyclic:
                    output_maf(f, induced_cyclic_pairwise_alignment(
                        g, i, j), g, i, j)
                else:
                    aln = induced_pairwise_alignment(g, i, j)
                    lab1 = g.labels[g.path(i)]
                    lab2 = g.labels[g.path(j)]
                    f.write(explicit_cigar(aln, lab1, lab2) + "\n")

        pairs = [(i, j) for i in range(g.path_size)
                 for j in range(i + 1, g.path_size)]
        if self.threads > 1 and len(pairs) > 1:
            # the one place the reference uses threads: writing the induced
            # pairwise alignment files (reference src/core.cpp:554-591)
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(self.threads) as pool:
                list(pool.map(lambda p: write_one(*p), pairs))
        else:
            for i, j in pairs:
                write_one(i, j)

    # ------------------------------------------------------------------

    def root_subproblem(self) -> Subproblem:
        return self.main_execution.root_subproblem()

    def leaf_subproblem(self, name: str) -> Subproblem:
        return self.main_execution.leaf_subproblem(name)

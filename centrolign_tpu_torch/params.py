"""Typed parameter registry with config-file round-trip.

Mirrors the reference Parameters (reference parameters.hpp:19-66,
src/parameters.cpp:22-108): ~70 parameters in 7 submodules with defaults,
help text, validation, and apply(Core&). The config format is a simple
YAML-ish document, round-trippable via generate_config()/parse_config().

Copy of centrolign_tpu/params.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

SUBMODULES = [
    ("IO", "Parameters related to file I/O and logging"),
    ("MatchFinding", "Parameters related to identifying matches between graphs"),
    ("Anchoring", "Parameters related to identifying high-scoring chains of matches to anchor alignments"),
    ("IdentifyingAlignability", "Parameters related to determining whether a graph region is alignable"),
    ("Aligning", "Parameters related to constructing a base-level alignment"),
    ("InducingCycles", "Parameters related to inducing cycles at tandem duplications"),
    ("DeveloperTools", "Parameters that were designed only to facilitate software development"),
]


@dataclass
class Param:
    submodule: str
    name: str
    type: str  # Integer | Bool | Double | String | Enum | DoubleArray3 | IntegerArray3
    default: Any
    help: str
    value: Any = None

    def get(self):
        return self.default if self.value is None else self.value


_REGISTRY = [
    ("IO", "fasta_name", "String", "", "The path to a FASTA file containing all of input sequences"),
    ("IO", "tree_name", "String", "", "The path to a guide tree for the alignment in Newick format (sample names must match sequence names from the input FASTA)"),
    ("IO", "logging_level", "Enum", 2, "The level of verbosity of logging to stderr during execution:\n- 0: Silent\n- 1: Minimal\n- 2: Basic\n- 3: Verbose\n- 4: Debug"),
    ("IO", "subproblems_prefix", "String", "", "If provided, save the results of the intermediate subproblems in GFA format to files with this prefix"),
    ("IO", "restart", "Bool", False, "Attempt to restart mid-execution using the saved partial results from 'subproblems_prefix'"),
    ("IO", "all_pairs_prefix", "String", "", "If provided, save the induced pairwise alignment for each pair of sequences in CIGAR format to files with this prefix"),
    ("IO", "subalignments_filepath", "String", "", "If provided, save the path-to-path alignment from each subproblem to files with this prefix"),
    ("IO", "threads", "Integer", 1, "The number of threads to use in parallel portions of the algorithm"),
    ("MatchFinding", "max_count", "Integer", 3000, "Only query matches that occur at most this many times on either of the two graphs"),
    ("MatchFinding", "use_color_set_size", "Bool", True, "Use Hui's (1992) color set size index instead of a merge sort tree (CSS is generally faster and uses less memory)"),
    ("Anchoring", "max_num_match_pairs", "Integer", 1250000, "The maximum number of matches between two graphs that will be considered during chaining"),
    ("Anchoring", "memory_restraint_size", "Integer", 1 << 30, "Switch to slower, more memory-efficient data structures when (graph size) * (num sequences) hits this amount"),
    ("Anchoring", "split_matches_at_branchpoints", "Bool", True, "Allow the chaining algorithm to split anchors at forking paths in the graph to avoid reachability artifacts"),
    ("Anchoring", "anchor_split_limit", "Integer", 5, "If splitting at branch points, how close to the end of the anchor must the split be"),
    ("Anchoring", "min_split_length", "Integer", 128, "If splitting at branch points, only split anchors that are at least this long"),
    ("Anchoring", "min_path_length_spread", "Integer", 50, "If splitting at branch points, only split anchors at forks whose paths differ by at least this much in length"),
    ("Anchoring", "max_split_match_set_size", "Integer", 16, "If splitting at branch points, only split anchors with at most this many matching sequences"),
    ("Anchoring", "chaining_algorithm", "Enum", 2, "The chaining algorithm used:\n- 0: Simple exhaustive algorithm (slow)\n- 1: Sparse algorithm with no gap penalties\n- 2: Sparse algorithm with affine gap penalties"),
    ("Anchoring", "anchor_gap_open", "DoubleArray3", (1.25, 50.0, 5000.0), "The gap open penalties used for anchoring with affine gap penalties"),
    ("Anchoring", "anchor_gap_extend", "DoubleArray3", (2.5, 0.1, 0.0015), "The gap extend penalties used for anchoring with affine gap penalties"),
    ("Anchoring", "anchor_score_function", "Enum", 2, "The scoring function used to prioritize anchors during chaining:\n- 0: Inverse of count\n- 1: Length of match scaled by inverse of count\n- 2: Length scaled by inverse of count with a subtracted convex monomial term based on length\n- 3: Length with a subtracted convex monomial term based on length and count"),
    ("Anchoring", "pair_count_power", "Double", 0.5, "The power that the count is raised to when used as an inverse factor to the anchor scoring function"),
    ("Anchoring", "length_intercept", "Double", 2250.0, "When using an anchoring scoring function with a convex subtracted term, the longest possible postively-scoring match"),
    ("Anchoring", "length_decay_power", "Double", 2.0, "When using an anchoring scoring function with a convex subtracted term, the power of the subtracted monomial"),
    ("Anchoring", "global_anchoring", "Bool", True, "Identify chains that cover the whole sequence, as opposed to local regions"),
    ("Anchoring", "do_fill_in_anchoring", "Bool", True, "Attempt to fill in gaps in the anchor chain using matches that were not considered due to the limit on the maximum number of matches"),
    ("IdentifyingAlignability", "constraint_method", "Enum", 3, "The method used to partition the anchor chain into alignable and unalignable regions:\n- 0: Do not attempt to partition; consider all sequences alignable\n- 1: Choose the highest scoring set of anchors\n- 2: Choose the highest scoring set of anchors, with each alignable segment having limit on its average value (score/length)\n- 3: Choose the highest scoring set of anchors, with each alignable segment having limit on a windowed average value (score/window size) across all windows inside the segment"),
    ("IdentifyingAlignability", "minimum_segment_score", "Double", 15000.0, "The minimum total score that an alignable segment must have"),
    ("IdentifyingAlignability", "minimum_segment_average", "Double", 0.1, "The minimum average score that an alignable segment must have"),
    ("IdentifyingAlignability", "window_length", "Double", 10000.0, "The length of the window used in the windowed average"),
    ("IdentifyingAlignability", "generalized_length_mean", "Double", -0.5, "Parameter of the Holder mean used to combine the lengths on the two graphs into a single length measurement"),
    ("IdentifyingAlignability", "boundary_score_factor", "Double", 0.95, "When realigning regions after inducing cycles, treat the boundaries of the realignment as having score equal to this proportion times the minimum segment score"),
    ("Aligning", "stitch_match", "Integer", 20, "Match value when stitching anchors into a base-level alignment"),
    ("Aligning", "stitch_mismatch", "Integer", 80, "Mismatch penalty when stitching anchors into a base-level alignment"),
    ("Aligning", "stitch_gap_open", "IntegerArray3", (60, 800, 2500), "Piecewise affine gap open penalties when stitching anchors into a base-level alignment"),
    ("Aligning", "stitch_gap_extend", "IntegerArray3", (30, 5, 1), "Piecewise affine gap extend penalties when stitching anchors into a base-level alignment"),
    ("Aligning", "max_trivial_size", "Integer", 30000, "Maximum size of a dynamic programming matrix that will be aligned even if it was identified as unalignable"),
    ("Aligning", "min_wfa_size", "Integer", 40000000, "Minimum size of a dynamic programming matrix that will be aligned using graph-graph WFA"),
    ("Aligning", "max_wfa_size", "Integer", 75000000, "Maximum size of a dynamic programming matrix that will be aligned using graph-graph WFA"),
    ("Aligning", "max_wfa_ratio", "Double", 1.05, "Maximum ratio of long-to-short side of the dynamic programming matrix for graph-graph WFA to be used"),
    ("Aligning", "wfa_pruning_dist", "Integer", 25, "The lagging distance for a diagonal to be pruned in graph-graph WFA"),
    ("Aligning", "deletion_alignment_ratio", "Integer", 8, "The minimum ratio of long-to-short side of the dynamic programming matrix to use WFA-based implied deletion algorithm"),
    ("Aligning", "deletion_alignment_short_max_size", "Integer", 1500, "The maximum size of the short side of the dynamic programming matrix to use WFA-based implied deletion algorithm"),
    ("Aligning", "deletion_alignment_long_min_size", "Integer", 2000, "The minimum size of the long side of the dynamic programming matrix to use WFA-based implied deletion algorithm"),
    ("Aligning", "indel_fuzz_score_proportion", "Double", 0.001, "Remove low-scoring anchors that are restricting the location of large indels when their score is worth at most this proportion of their neighboring anchors"),
    ("Aligning", "min_indel_fuzz_length", "Integer", 50, "When removing low-scoring anchors to de-specify the location of a indel, require the indel to be at least this long"),
    ("InducingCycles", "cyclize_tandem_duplications", "Bool", False, "Identify tandem duplications in the sequences and use them to induce cycles in the final graph"),
    ("InducingCycles", "max_tandem_duplication_search_rounds", "Integer", 3, "The maximum number of nested tandem duplications to attempt finding for any given subsequence"),
    ("InducingCycles", "min_cyclizing_length", "Integer", 100000, "The minimum size of a tandem duplication to look for"),
    ("InducingCycles", "tandem_dup_score_proportion", "Double", 0.2, "Require tandem duplication anchor chains to have at least this proportion of the score of the corresponding section of a self-to-self anchor chain"),
    ("InducingCycles", "include_tandem_dup_gap_scores", "Bool", True, "When computing the score of tandem duplication chains, include the gap scores"),
    ("InducingCycles", "deviation_drift_factor", "Double", 150.0, "When identifying tandem duplications, allow the chain to have indel deviations of this much times sqrt(length)"),
    ("InducingCycles", "separation_drift_factor", "Double", 50.0, "When identifying tandem duplications, require the chain to be separated from the main diagonal by the length minus this much times sqrt(length)"),
    ("InducingCycles", "trim_window_proportion", "Double", 0.1, "Trim off the ends of tandem duplications until they meet the minimum score requirement using only a window on each end of length equal to this proportion times 'min_cyclizing_length'"),
    ("InducingCycles", "deduplication_slosh_proportion", "Double", 0.1, "Consider two tandem duplications to be the same if they differ by at most this much times 'min_cyclizing_length'"),
    ("InducingCycles", "max_realignment_cycle_size", "Integer", 10000, "After cyclizing, realign cycles shorter than this length"),
    ("InducingCycles", "inconsistent_indel_window", "Integer", 100, "After cyclizing, look for inconsistently-placed indels to realign that are separated by at most this length"),
    ("InducingCycles", "min_inconsistency_disjoint_length", "Integer", 8, "Require inconsistently-placed indels to have disjoint un-merged sequences of at least this length from two segments of the same input sequence"),
    ("InducingCycles", "min_inconsistency_total_length", "Integer", 50, "Require inconsistently-placed indels to have total un-merged sequences of at least this length from two segments of the same input sequence"),
    ("InducingCycles", "realignment_min_padding", "Integer", 1000, "When realigning after cyclizing, try to pad alignment problems with this much padding sequence from every path"),
    ("InducingCycles", "realignment_max_padding", "Integer", 10000, "When realigning after cyclizing, stop adding padding if it would require any path to add this much sequence"),
    ("DeveloperTools", "bonds_prefix", "String", "", "If provided, save the alignments of all tandem duplications identified in the cyclization process to files with this prefix"),
    ("DeveloperTools", "preserve_subproblems", "Bool", False, "Do not clear out data from completed subproblems as the algorithm progresses"),
    ("DeveloperTools", "skip_calibration", "Bool", False, "Do not calibrate the scoring parameters to the input sequences' repetitiveness"),
]


class Parameters:
    def __init__(self, config_text: str | None = None):
        self._params: dict[str, Param] = {}
        for sub, name, typ, default, help_ in _REGISTRY:
            self._params[name] = Param(sub, name, typ, default, help_)
        if config_text is not None:
            self._parse(config_text)

    def set(self, name: str, value) -> None:
        p = self._params[name]
        p.value = self._coerce(p, value)

    def get(self, name: str):
        return self._params[name].get()

    def _coerce(self, p: Param, value):
        if p.type == "Integer" or p.type == "Enum":
            return int(value)
        if p.type == "Double":
            return float(value)
        if p.type == "Bool":
            if isinstance(value, str):
                return value.strip().lower() in ("1", "true", "yes")
            return bool(value)
        if p.type == "String":
            return str(value)
        if p.type in ("DoubleArray3", "IntegerArray3"):
            if isinstance(value, str):
                parts = [x for x in value.replace(",", " ").split() if x]
                conv = float if p.type == "DoubleArray3" else int
                value = tuple(conv(x) for x in parts)
            value = tuple(value)
            if len(value) != 3:
                raise ValueError(f"{p.name} requires 3 values")
            return value
        raise ValueError(p.type)

    def validate(self) -> None:
        if self.get("restart") and not self.get("subproblems_prefix"):
            raise ValueError("Restarting requires a subproblems prefix (-S) "
                             "from the original run")
        if self.get("fasta_name") == "":
            raise ValueError("FASTA input is missing")

    def __eq__(self, other):
        return all(self.get(n) == other.get(n) for n in self._params)

    # --------------- config round-trip ---------------

    def _value_str(self, p: Param) -> str:
        """(reference src/parameters.cpp:649-687; doubles use the stream
        default 6-significant-digit formatting)"""
        v = p.get()
        if p.type in ("Integer", "Enum"):
            return str(int(v))
        if p.type == "Bool":
            return "true" if v else "false"
        if p.type == "Double":
            return f"{float(v):.6g}"
        if p.type == "String":
            return str(v)
        if p.type == "DoubleArray3":
            return ",".join(f"{float(x):.6g}" for x in v)
        if p.type == "IntegerArray3":
            return ",".join(str(int(x)) for x in v)
        raise ValueError(p.type)

    def generate_config(self) -> str:
        """Emit the reference's config format byte-for-byte
        (reference src/parameters.cpp:335-359)."""
        out = ["---\n"]
        for sub, desc in SUBMODULES:
            out.append(" \n")
            out.append(" ##########\n")
            out.append(f" # {desc}\n")
            out.append(" ##########\n")
            out.append(" \n")
            for p in self._params.values():
                if p.submodule != sub:
                    continue
                for help_line in p.help.split("\n"):
                    out.append(f" # {help_line}\n")
                value = self._value_str(p)
                needs_quotes = value == "" or any(c.isspace() for c in value)
                q = '"' if needs_quotes else ""
                out.append(f" {p.name}: {q}{value}{q}\n")
        return "".join(out)

    def _parse(self, text: str) -> None:
        """Parse the reference's config format
        (reference src/parameters.cpp:219-290)."""
        delim = text.find("---")
        if delim != -1:
            text = text[delim + 3:]
        for line in text.splitlines():
            comment = line.find("#")
            body = line[:comment] if comment != -1 else line
            if body.strip() == "":
                continue
            colon = body.find(":")
            if colon == -1:
                raise ValueError(
                    f"Config has line missing ':' delimiter in line '{line}'")
            name = body[:colon].strip()
            value = body[colon + 1:].strip()
            if not name:
                raise ValueError(
                    f"Config has line with no variable name in line '{line}'")
            if not value:
                raise ValueError(
                    f"Config has line with no variable value in line '{line}'")
            if value.startswith('"'):
                if len(value) == 1 or not value.endswith('"'):
                    raise ValueError(f"Unmatched \" in config file line: {line}")
                value = value[1:-1]
            if name not in self._params:
                raise ValueError(f"No parameter with name {name}")
            self.set(name, value)

    # --------------- apply to core ---------------

    def apply(self, core) -> None:
        """Push values into the pipeline objects (reference
        src/parameters.cpp:110-180)."""
        from . import logging as logmod
        from .ops.align_params import AlignmentParams

        core.subproblems_prefix = self.get("subproblems_prefix")
        core.subalignments_filepath = self.get("subalignments_filepath")
        core.induced_pairwise_prefix = self.get("all_pairs_prefix")
        core.bonds_prefix = self.get("bonds_prefix")
        core.max_count = self.get("max_count")
        core.skip_calibration = self.get("skip_calibration")
        core.preserve_subproblems = self.get("preserve_subproblems")
        core.cyclize_tandem_duplications = self.get("cyclize_tandem_duplications")
        core.memory_restraint_size = self.get("memory_restraint_size")
        core.threads = self.get("threads")

        sf = core.score_function
        sf.anchor_score_function = self.get("anchor_score_function")
        sf.pair_count_power = self.get("pair_count_power")
        sf.length_intercept = self.get("length_intercept")
        sf.length_decay_power = self.get("length_decay_power")

        a = core.anchorer
        a.chaining_algorithm = self.get("chaining_algorithm")
        a.max_num_match_pairs = self.get("max_num_match_pairs")
        a.gap_open = self.get("anchor_gap_open")
        a.gap_extend = self.get("anchor_gap_extend")
        a.global_anchoring = self.get("global_anchoring")
        a.do_fill_in_anchoring = self.get("do_fill_in_anchoring")
        a.split_matches_at_branchpoints = self.get("split_matches_at_branchpoints")

        b = core.bonder
        b.min_length = self.get("min_cyclizing_length")
        b.min_opt_proportion = self.get("tandem_dup_score_proportion")
        b.include_gap_scores = self.get("include_tandem_dup_gap_scores")
        b.deviation_drift_factor = self.get("deviation_drift_factor")
        b.separation_drift_factor = self.get("separation_drift_factor")
        b.deduplication_slosh_proportion = self.get(
            "deduplication_slosh_proportion")
        b.trim_window_proportion = self.get("trim_window_proportion")
        core.max_tandem_duplication_search_rounds = self.get(
            "max_tandem_duplication_search_rounds")

        ii = core.inconsistency_identifier
        ii.max_tight_cycle_size = self.get("max_realignment_cycle_size")
        ii.max_bond_inconsistency_window = self.get("inconsistent_indel_window")
        ii.min_inconsistency_disjoint_length = self.get(
            "min_inconsistency_disjoint_length")
        ii.min_inconsistency_total_length = self.get(
            "min_inconsistency_total_length")
        ii.padding_target_min_length = self.get("realignment_min_padding")
        ii.padding_max_length_limit = self.get("realignment_max_padding")

        pt = core.partitioner
        pt.constraint_method = ["Null", "Unconstrained", "MinAverage",
                                "MinWindowAverage"][self.get("constraint_method")]
        pt.minimum_segment_score = self.get("minimum_segment_score")
        pt.minimum_segment_average = self.get("minimum_segment_average")
        pt.window_length = self.get("window_length")
        pt.generalized_length_mean = self.get("generalized_length_mean")
        pt.boundary_score_factor = self.get("boundary_score_factor")

        st = core.stitcher
        st.alignment_params = AlignmentParams(
            match=self.get("stitch_match"),
            mismatch=self.get("stitch_mismatch"),
            gap_open=tuple(self.get("stitch_gap_open")),
            gap_extend=tuple(self.get("stitch_gap_extend")))
        st.max_trivial_size = self.get("max_trivial_size")
        st.min_wfa_size = self.get("min_wfa_size")
        st.max_wfa_size = self.get("max_wfa_size")
        st.max_wfa_ratio = self.get("max_wfa_ratio")
        st.wfa_pruning_dist = self.get("wfa_pruning_dist")
        st.deletion_alignment_ratio = self.get("deletion_alignment_ratio")
        st.deletion_alignment_short_max_size = self.get("deletion_alignment_short_max_size")
        st.deletion_alignment_long_min_size = self.get("deletion_alignment_long_min_size")
        st.min_indel_fuzz_length = self.get("min_indel_fuzz_length")
        st.indel_fuzz_score_proportion = self.get("indel_fuzz_score_proportion")

        logmod.level = self.get("logging_level")

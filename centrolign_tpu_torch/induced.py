"""Induced pairwise alignments from cyclic (cyclized) graphs.

Behavioral equivalents of the reference's non-colinear induced-alignment
stack (src/alignment.cpp:229-907): Hunt-Szymanski LCS (align_hs), the
non-repeating LCS restriction, recursive block discovery, block merging,
maximum non-cyclic extension DP, dangling-insertion blocks, and MAF output.
Alignments are lists of (i, j) position pairs with -1 as the gap sentinel
(positions index into the paths, not node ids).

Copy of centrolign_tpu/induced.py.
"""

from __future__ import annotations

from bisect import bisect_left

GAP = -1

# convert double gaps up to this length into mismatches
# (reference src/alignment.cpp:128)
_MAX_MISMATCH_SIZE = 4


def align_hs(seq1, seq2):
    """Longest common subsequence via sparse Hunt-Szymanski
    (reference alignment.hpp:636-735)."""
    # bin seq2 occurrences by value in reverse order
    occurrences = {}
    for j in range(len(seq2) - 1, -1, -1):
        occurrences.setdefault(int(seq2[j]), []).append(j + 1)

    backpointer = {}
    score_heads = [(0, 0)]
    row = [0]
    for i in range(1, len(seq1) + 1):
        for j in occurrences.get(int(seq1[i - 1]), ()):
            pos = bisect_left(row, j)
            if pos == len(row):
                backpointer[(i, j)] = score_heads[-1]
                score_heads.append((i, j))
                row.append(j)
            elif row[pos] != j:
                backpointer[(i, j)] = score_heads[pos - 1]
                score_heads[pos] = (i, j)
                row[pos] = j

    traceback = []
    head = score_heads[-1]
    for i in range(len(seq1), head[0], -1):
        traceback.append((i - 1, GAP))
    for j in range(len(seq2), head[1], -1):
        traceback.append((GAP, j - 1))
    here = head
    while here in backpointer:
        traceback.append((here[0] - 1, here[1] - 1))
        nxt = backpointer[here]
        for i in range(here[0] - 1, nxt[0], -1):
            traceback.append((i - 1, GAP))
        for j in range(here[1] - 1, nxt[1], -1):
            traceback.append((GAP, j - 1))
        here = nxt
    traceback.reverse()
    return traceback


def long_common_subsequence_nonrepeating(str1, str2):
    """The most-matching interval of the LCS in which neither sequence
    repeats a value (reference alignment.hpp:2677-2798)."""
    lcs_aln = align_hs(str1, str2)

    matched_prefix_sum = [0] * (len(lcs_aln) + 1)
    for i, (a, b) in enumerate(lcs_aln):
        matched_prefix_sum[i + 1] = matched_prefix_sum[i] + (
            a != GAP and b != GAP)

    aln_idx1 = [0] * len(str1)
    aln_idx2 = [0] * len(str2)
    idx1 = idx2 = 0
    for i, (a, b) in enumerate(lcs_aln):
        if a != GAP:
            aln_idx1[idx1] = i
            idx1 += 1
        if b != GAP:
            aln_idx2[idx2] = i
            idx2 += 1

    search_limits = []
    for s in (str1, str2):
        prev = {}
        max_lim = 0
        limit = [0] * len(s)
        for i in range(len(s)):
            v = int(s[i])
            if v in prev:
                max_lim = max(max_lim, prev[v] + 1)
            prev[v] = i
            limit[i] = max_lim
        search_limits.append(limit)
    search_limit1, search_limit2 = search_limits

    opt_begin = opt_end = 0
    for i, (a, b) in enumerate(lcs_aln):
        if a != GAP and b != GAP:
            begin = max(aln_idx1[search_limit1[a]], aln_idx2[search_limit2[b]])
            if (opt_end == opt_begin
                    or matched_prefix_sum[i + 1] - matched_prefix_sum[begin]
                    > matched_prefix_sum[opt_end]
                    - matched_prefix_sum[opt_begin]):
                opt_begin = begin
                opt_end = i + 1

    while (opt_begin < opt_end
           and (lcs_aln[opt_begin][0] == GAP or lcs_aln[opt_begin][1] == GAP)):
        opt_begin += 1
    return lcs_aln[opt_begin:opt_end]


def _induced_cyclic_internal(path1, path2, coord_begin, coord_end,
                             alignments):
    """Recursive non-overlapping block discovery
    (reference src/alignment.cpp:229-333)."""
    sub1 = path1[coord_begin[0]:coord_end[0]]
    sub2 = path2[coord_begin[1]:coord_end[1]]

    aln = long_common_subsequence_nonrepeating(sub1, sub2)
    if not aln:
        return
    aln = [(a + coord_begin[0] if a != GAP else GAP,
            b + coord_begin[1] if b != GAP else GAP) for a, b in aln]

    # convert short double gaps into mismatches
    removed = 0
    i = 0
    while i < len(aln):
        if aln[i][0] != GAP and aln[i][1] != GAP:
            aln[i - removed] = aln[i]
            i += 1
        else:
            j = i
            gap1 = gap2 = 0
            while j < len(aln) and (aln[j][0] == GAP or aln[j][1] == GAP):
                if aln[j][0] == GAP:
                    gap1 += 1
                else:
                    gap2 += 1
                j += 1
            if gap1 == gap2 and gap1 <= _MAX_MISMATCH_SIZE:
                g1 = i - removed
                g2 = g1
                for k in range(i, j):
                    if aln[k][0] == GAP:
                        aln[g2] = (aln[g2][0], aln[k][1])
                        g2 += 1
                    else:
                        aln[g1] = (aln[k][0], aln[g1][1])
                        g1 += 1
                removed += gap1
            else:
                for k in range(i, j):
                    aln[k - removed] = aln[k]
            i = j
    del aln[len(aln) - removed:]

    aln_coord_begin = (aln[0][0], aln[0][1])
    aln_coord_end = (aln[-1][0] + 1, aln[-1][1] + 1)
    alignments.append(aln)

    if (aln_coord_begin[0] != coord_begin[0]
            and aln_coord_begin[1] != coord_begin[1]):
        _induced_cyclic_internal(path1, path2, coord_begin, aln_coord_begin,
                                 alignments)
    if (aln_coord_end[0] != coord_end[0]
            and aln_coord_end[1] != coord_end[1]):
        _induced_cyclic_internal(path1, path2, aln_coord_end, coord_end,
                                 alignments)


def maximum_noncyclic_extension(path, covered_intervals):
    """Extend covered intervals to close as many gaps (then cover as many
    bases) as possible without repeating a node
    (reference src/alignment.cpp:335-566)."""
    n = len(covered_intervals)
    maximal_extensions = [[] for _ in range(n)]
    lex_order = sorted(range(n), key=lambda i: covered_intervals[i])

    for i in range(len(lex_order)):
        extensions = maximal_extensions[lex_order[i]]
        interval = covered_intervals[lex_order[i]]
        left_lim = 0 if i == 0 else covered_intervals[lex_order[i - 1]][1]
        right_lim = (len(path) if i + 1 == len(lex_order)
                     else covered_intervals[lex_order[i + 1]][0])

        interval_nodes = set(int(x) for x in path[interval[0]:interval[1]])
        left_flank_positions = {}
        for j in range(interval[0], left_lim, -1):
            node_id = int(path[j - 1])
            if node_id in left_flank_positions or node_id in interval_nodes:
                break
            left_flank_positions[node_id] = j - 1

        current = [interval[0] - len(left_flank_positions), interval[1]]
        for j in range(interval[1], right_lim):
            node_id = int(path[j])
            if node_id in interval_nodes:
                break
            pos = left_flank_positions.get(node_id)
            if pos is not None and pos >= current[0]:
                extensions.append(tuple(current))
                current[0] = pos + 1
            current[1] += 1
            interval_nodes.add(node_id)
        extensions.append(tuple(current))

    # DP: (gaps closed to left, positions covered to left, backpointer)
    dp = [[] for _ in range(n)]
    for i in range(len(lex_order)):
        extensions = maximal_extensions[lex_order[i]]
        interval = covered_intervals[lex_order[i]]
        dp_col = dp[lex_order[i]] = [
            [0, 0, -1] for _ in range(len(extensions))]
        if i == 0:
            for j, extension in enumerate(extensions):
                dp_col[j][0] = int(interval[0] != 0 and extension[0] == 0)
                dp_col[j][1] = interval[0] - extension[0]
        else:
            prev_interval = covered_intervals[lex_order[i - 1]]
            prev_extensions = maximal_extensions[lex_order[i - 1]]
            prev_dp_col = dp[lex_order[i - 1]]
            for j, extension in enumerate(extensions):
                entry = dp_col[j]
                for k in range(len(prev_dp_col)):
                    gaps, bases = prev_dp_col[k][0], prev_dp_col[k][1]
                    prev_ext = prev_extensions[k]
                    if (prev_interval[1] != interval[0]
                            and prev_ext[1] >= extension[0]):
                        gaps += 1
                        bases += interval[0] - prev_interval[1]
                    else:
                        bases += (prev_ext[1] - prev_interval[1]
                                  + interval[0] - extension[0])
                    if gaps > entry[0] or (gaps == entry[0]
                                           and bases >= entry[1]):
                        entry[0], entry[1], entry[2] = gaps, bases, k

    opt_idx = -1
    opt_gaps = opt_bases = 0
    if lex_order:
        final_dp = dp[lex_order[-1]]
        final_interval = covered_intervals[lex_order[-1]]
        final_extensions = maximal_extensions[lex_order[-1]]
        for j in range(len(final_dp)):
            gaps, bases = final_dp[j][0], final_dp[j][1]
            extension = final_extensions[j]
            if final_interval[1] != len(path) and extension[1] == len(path):
                gaps += 1
            bases += extension[1] - final_interval[1]
            if gaps > opt_gaps or (gaps == opt_gaps and bases >= opt_bases):
                opt_idx, opt_gaps, opt_bases = j, gaps, bases

    result = [None] * n
    tb_row = opt_idx
    for i in range(len(lex_order) - 1, -1, -1):
        result[lex_order[i]] = list(maximal_extensions[lex_order[i]][tb_row])
        tb_row = dp[lex_order[i]][tb_row][2]
        if i + 1 != len(lex_order):
            result[lex_order[i]][1] = min(result[lex_order[i]][1],
                                          result[lex_order[i + 1]][0])
    return [tuple(r) for r in result]


def induced_cyclic_pairwise_alignment(graph, path_id1, path_id2):
    """Non-colinear induced alignment blocks between two paths of a cyclic
    graph (reference src/alignment.cpp:569-846)."""
    path1 = graph.path(path_id1)
    path2 = graph.path(path_id2)

    alignments = []
    _induced_cyclic_internal(path1, path2, (0, 0),
                             (len(path1), len(path2)), alignments)

    covered1 = [(a[0][0], a[-1][0] + 1) for a in alignments]
    covered2 = [(a[0][1], a[-1][1] + 1) for a in alignments]

    # merge adjacent blocks when that doesn't create a within-block cycle
    if alignments:
        order1 = sorted(range(len(covered1)), key=lambda i: covered1[i])
        order2 = sorted(range(len(covered2)), key=lambda i: covered2[i])
        index2 = [0] * len(order2)
        for pos, idx in enumerate(order2):
            index2[idx] = pos
        keep = [True] * len(covered1)
        merge_run = 0
        node_set1, node_set2 = set(), set()
        for i in range(1, len(order1)):
            did_merge = False
            if index2[order1[i]] == index2[order1[i - 1]] + 1:
                anchor = order1[i - 1 - merge_run]
                if not node_set1:
                    for j in range(covered1[anchor][0], covered1[anchor][1]):
                        node_set1.add(int(path1[j]))
                    for j in range(covered2[anchor][0], covered2[anchor][1]):
                        node_set2.add(int(path2[j]))
                compatible = True
                for j in range(covered1[anchor][1], covered1[order1[i]][1]):
                    v = int(path1[j])
                    if v in node_set1:
                        compatible = False
                        break
                    node_set1.add(v)
                if compatible:
                    for j in range(covered2[anchor][1],
                                   covered2[order1[i]][1]):
                        v = int(path2[j])
                        if v in node_set2:
                            compatible = False
                            break
                        node_set2.add(v)
                if compatible:
                    aln = alignments[anchor]
                    for j in range(covered1[anchor][1],
                                   covered1[order1[i]][0]):
                        aln.append((j, GAP))
                    for j in range(covered2[anchor][1],
                                   covered2[order1[i]][0]):
                        aln.append((GAP, j))
                    aln.extend(alignments[order1[i]])
                    alignments[order1[i]] = []
                    keep[order1[i]] = False
                    covered1[anchor] = (covered1[anchor][0],
                                        covered1[order1[i]][1])
                    covered2[anchor] = (covered2[anchor][0],
                                        covered2[order1[i]][1])
                    did_merge = True
            if did_merge:
                merge_run += 1
            else:
                node_set1.clear()
                node_set2.clear()
                merge_run = 0
        alignments = [alignments[i] for i in range(len(keep)) if keep[i]]
        covered1 = [covered1[i] for i in range(len(keep)) if keep[i]]
        covered2 = [covered2[i] for i in range(len(keep)) if keep[i]]

    extended1 = maximum_noncyclic_extension(path1, covered1)
    extended2 = maximum_noncyclic_extension(path2, covered2)

    for i, aln in enumerate(alignments):
        num_added_left = 0
        for j in range(extended1[i][0], covered1[i][0]):
            aln.append((j, GAP))
            num_added_left += 1
        for j in range(extended2[i][0], covered2[i][0]):
            aln.append((GAP, j))
            num_added_left += 1
        if num_added_left:
            aln[:] = aln[-num_added_left:] + aln[:-num_added_left]
        for j in range(covered1[i][1], extended1[i][1]):
            aln.append((j, GAP))
        for j in range(covered2[i][1], extended2[i][1]):
            aln.append((GAP, j))

    # dangling insertions for the uncovered tails of each path
    for pid, path, extended in ((0, path1, extended1), (1, path2, extended2)):
        order = sorted(range(len(extended)), key=lambda i: extended[i][0])
        for i in range(len(order) + 1):
            l = 0 if i == 0 else extended[order[i - 1]][1]
            r = len(path) if i == len(order) else extended[order[i]][0]
            if l == r:
                continue
            nodes_seen = set()
            alignments.append([])
            for j in range(l, r):
                v = int(path[j])
                if v in nodes_seen:
                    alignments.append([])
                    nodes_seen.clear()
                alignments[-1].append((j, GAP) if pid == 0 else (GAP, j))
                nodes_seen.add(v)

    return alignments


def output_maf(out, blocks, graph, path_id1, path_id2):
    """(reference src/alignment.cpp:848-907)"""
    from .utils.encoding import decode_base

    path1 = graph.path(path_id1)
    path2 = graph.path(path_id2)
    out.write(f"track name={graph.path_name(path_id1)}_vs_"
              f"{graph.path_name(path_id2)}_induced\n")
    out.write("##maf version=1\n")
    for block in blocks:
        start1 = start2 = -1
        size1 = size2 = 0
        for a, b in block:
            if a != GAP:
                if start1 == -1:
                    start1 = a
                size1 += 1
            if b != GAP:
                if start2 == -1:
                    start2 = b
                size2 += 1
        out.write("\na\n")
        for (name, path, start, size, col) in (
                (graph.path_name(path_id1), path1, start1, size1, 0),
                (graph.path_name(path_id2), path2, start2, size2, 1)):
            out.write(f"s\t{name}\t"
                      f"{len(path) if start == -1 else start}\t{size}\t+\t")
            chars = []
            for pair in block:
                p = pair[col]
                if p != GAP:
                    base = int(graph.labels[path[p]])
                    chars.append(decode_base(base) if base <= 4
                                 else chr(base))
                else:
                    chars.append("-")
            out.write("".join(chars))
            out.write("\n")

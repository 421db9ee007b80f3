"""Alignment representation, CIGAR emission, and graph fusion.

An alignment is an (L, 2) int64 numpy array of aligned node-id pairs; -1 (GAP)
marks a gap on that side. Column 0 indexes graph1, column 1 graph2. This
mirrors the reference's ``std::vector<AlignedPair>`` (reference
include/centrolign/alignment.hpp:34-50) as a struct-of-arrays.

CIGAR conventions follow the reference (src/alignment.cpp:47-130): a pair with
a gap on side 1 is 'I', a gap on side 2 is 'D', both present is 'M' (or '='/'X'
for the explicit variant).

Copy of centrolign_tpu/alignment.py.
"""

from __future__ import annotations

import numpy as np

from .graph import BaseGraph
from .modify_graph import SentinelTableau

GAP = -1
_I64 = np.int64


def empty_alignment() -> np.ndarray:
    return np.empty((0, 2), dtype=_I64)


def swap_sides(alignment: np.ndarray) -> np.ndarray:
    return alignment[:, ::-1].copy()


def _run_length(ops: np.ndarray) -> str:
    if len(ops) == 0:
        return ""
    change = np.flatnonzero(ops[1:] != ops[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [len(ops)]))
    return "".join(f"{e - s}{chr(ops[s])}" for s, e in zip(starts, ends))


def align_ond(seq1, seq2) -> np.ndarray:
    """Myers O(ND) unit-cost edit alignment (reference alignment.hpp:262-634,
    align_ond): matches are free, substitutions/insertions/deletions cost 1,
    the total edit distance is minimized. Accepts any indexable sequences of
    comparable elements; returns an (L, 2) pair array with GAP = -1.

    Time O((n+m)·D), memory O(D²) for the traceback frontier stack — the
    same regime the reference targets (near-identical sequences, small D).
    Used by the sim_centromere tool's monomer annotation; the reference also
    exposes it only as a test oracle / script helper."""
    n, m = len(seq1), len(seq2)

    def snake(a: int, k: int) -> int:
        # extend free matches along diagonal k from anti-diagonal a
        i = (a + k) // 2
        j = (a - k) // 2
        while i < n and j < m and seq1[i] == seq2[j]:
            i += 1
            j += 1
        return i + j

    frontiers = []
    V = {0: snake(0, 0)}
    frontiers.append(V)
    k_final = n - m
    a_final = n + m
    d = 0
    while V.get(k_final, -1) != a_final:
        d += 1
        nv = {}
        for k, a in V.items():
            # substitution (both advance), insertion (seq1), deletion (seq2)
            for nk, na in ((k, a + 2), (k + 1, a + 1), (k - 1, a + 1)):
                i = (na + nk) // 2
                j = (na - nk) // 2
                if 0 <= i <= n and 0 <= j <= m and na > nv.get(nk, -1):
                    nv[nk] = na
        V = {k: snake(a, k) for k, a in nv.items()}
        frontiers.append(V)

    # traceback: at (k, a) with d edits, find a predecessor whose op +
    # snake reaches exactly a
    pairs = []

    def emit_snake(a_hi: int, a_lo: int, k: int) -> None:
        i = (a_hi + k) // 2
        j = (a_hi - k) // 2
        while i + j > a_lo:
            pairs.append((i - 1, j - 1))
            i -= 1
            j -= 1

    k, a = k_final, a_final
    for d in range(len(frontiers) - 1, 0, -1):
        prev = frontiers[d - 1]
        found = False
        for pk, cost_adv, pair in ((k, 2, (0, 0)), (k - 1, 1, (1, GAP)),
                                   (k + 1, 1, (GAP, 1))):
            pa = prev.get(pk)
            if pa is None:
                continue
            op_a = pa + cost_adv
            if op_a > a or snake(op_a, k) < a:
                continue
            emit_snake(a, op_a, k)
            i = (op_a + k) // 2
            j = (op_a - k) // 2
            if cost_adv == 2:
                pairs.append((i - 1, j - 1))
            elif pair[0] == 1:
                pairs.append((i - 1, GAP))
            else:
                pairs.append((GAP, j - 1))
            k, a = pk, pa
            found = True
            break
        assert found, "O(ND) traceback failed"
    emit_snake(a, 0, k)
    pairs.reverse()
    return np.array(pairs, dtype=_I64).reshape(-1, 2)


def align_nw(seq1, seq2, params) -> tuple[np.ndarray, int]:
    """Independent full-matrix Needleman-Wunsch-Gotoh test oracle (reference
    align_nw, alignment.hpp:2341): global seq-seq alignment under the same
    piecewise-affine parameters as po_poa, written as a plain row-major
    numpy DP — deliberately a *different* formulation from the anti-diagonal
    kernels so the two can cross-validate (the reference uses align_nw the
    same way against WFA and O(ND), src/test/test_alignment.cpp).

    Returns (alignment (L, 2) pairs with GAP = -1, score). The optimal score
    is unique; the returned alignment attains it (tie-breaking here is this
    oracle's own: diagonal first, then I components, then D)."""
    s1 = np.asarray(seq1)
    s2 = np.asarray(seq2)
    n, m = len(s1), len(s2)
    npw = len(params.gap_open)
    go = np.asarray(params.gap_open, dtype=np.int64)
    ge = np.asarray(params.gap_extend, dtype=np.int64)
    NEG = np.int64(np.iinfo(np.int32).min // 2)

    M = np.full((n + 1, m + 1), NEG, dtype=np.int64)
    I = np.full((npw, n + 1, m + 1), NEG, dtype=np.int64)  # gap in seq2
    D = np.full((npw, n + 1, m + 1), NEG, dtype=np.int64)  # gap in seq1
    M[0, 0] = 0
    for pw in range(npw):
        I[pw, 1:, 0] = -go[pw] - ge[pw] * np.arange(1, n + 1)
        D[pw, 0, 1:] = -go[pw] - ge[pw] * np.arange(1, m + 1)
    M[1:, 0] = I[:, 1:, 0].max(axis=0)
    M[0, 1:] = D[:, 0, 1:].max(axis=0)

    for i in range(1, n + 1):
        sub = np.where(s1[i - 1] == s2, params.match,
                       -params.mismatch).astype(np.int64)
        Mrow = M[i]
        Mprev = M[i - 1]
        Mrow[1:] = Mprev[:-1] + sub
        for pw in range(npw):
            Irow = np.maximum(Mprev - go[pw], I[pw, i - 1]) - ge[pw]
            I[pw, i, 1:] = Irow[1:]
            np.maximum(Mrow[1:], Irow[1:], out=Mrow[1:])
        # D has an in-row dependency; sweep it serially
        Drow = D[:, i]
        for j in range(1, m + 1):
            dv = np.maximum(Mrow[j - 1] - go, Drow[:, j - 1]) - ge
            Drow[:, j] = dv
            best = dv.max()
            if best > Mrow[j]:
                Mrow[j] = best

    score = int(M[n, m])
    # traceback
    pairs = []
    i, j = n, m
    comp = 0  # 0 = M, +pw+1 = I[pw], -(pw+1) = D[pw]
    while i > 0 or j > 0:
        if comp == 0:
            v = M[i, j]
            if i > 0 and j > 0 and v == M[i - 1, j - 1] + (
                    params.match if s1[i - 1] == s2[j - 1]
                    else -params.mismatch):
                pairs.append((i - 1, j - 1))
                i -= 1
                j -= 1
                continue
            for pw in range(npw):
                if i > 0 and v == I[pw, i, j]:
                    comp = pw + 1
                    break
                if j > 0 and v == D[pw, i, j]:
                    comp = -(pw + 1)
                    break
            assert comp != 0, "align_nw traceback failed"
        elif comp > 0:
            pw = comp - 1
            pairs.append((i - 1, GAP))
            if I[pw, i, j] == M[i - 1, j] - go[pw] - ge[pw]:
                comp = 0
            i -= 1
        else:
            pw = -comp - 1
            pairs.append((GAP, j - 1))
            if D[pw, i, j] == M[i, j - 1] - go[pw] - ge[pw]:
                comp = 0
            j -= 1
    pairs.reverse()
    return np.array(pairs, dtype=_I64).reshape(-1, 2), score


def cigar(alignment: np.ndarray) -> str:
    """Run-length CIGAR with M/I/D ops (reference src/alignment.cpp:47)."""
    ops = np.where(
        alignment[:, 0] == GAP,
        ord("I"),
        np.where(alignment[:, 1] == GAP, ord("D"), ord("M")),
    ).astype(np.int32)
    return _run_length(ops)


def explicit_cigar(alignment: np.ndarray, labels1: np.ndarray, labels2: np.ndarray) -> str:
    """CIGAR with =/X instead of M (reference src/alignment.cpp:84).

    labels1/labels2 are the per-node label arrays of the two graphs (for the
    two-sequence output path these are the leaf chain graphs including their
    sentinel nodes; gaps/sentinels never appear as aligned pairs there).
    """
    a1, a2 = alignment[:, 0], alignment[:, 1]
    ops = np.where(
        a1 == GAP,
        ord("I"),
        np.where(
            a2 == GAP,
            ord("D"),
            np.where(
                labels1[np.where(a1 == GAP, 0, a1)] == labels2[np.where(a2 == GAP, 0, a2)],
                ord("="),
                ord("X"),
            ),
        ),
    ).astype(np.int32)
    return _run_length(ops)


def score_alignment(labels1, labels2, alignment: np.ndarray, params) -> int:
    """Score an explicit alignment under piecewise-affine params (min over
    gap components per gap run), mirroring reference score_alignment
    (alignment.hpp:73, src/alignment.cpp)."""
    a1, a2 = alignment[:, 0], alignment[:, 1]
    both = (a1 != GAP) & (a2 != GAP)
    n_match = int(np.sum(both & (np.asarray(labels1)[a1] == np.asarray(labels2)[a2])))
    n_mismatch = int(both.sum()) - n_match
    score = params.match * n_match - params.mismatch * n_mismatch
    # gap runs: consecutive rows with a gap on the same side
    is_gap = ~both
    if is_gap.any():
        side = np.where(a1 == GAP, 1, 2)
        idx = np.flatnonzero(is_gap)
        # split runs where the gap side changes
        splits = np.flatnonzero(np.diff(idx) != 1)
        starts = np.concatenate(([0], splits + 1))
        ends = np.concatenate((splits + 1, [len(idx)]))
        for s, e in zip(starts, ends):
            seg = idx[s:e]
            # a contiguous gap region may mix sides; cost applies per side-run
            sides = side[seg]
            side_breaks = np.flatnonzero(np.diff(sides) != 0)
            ss = np.concatenate(([0], side_breaks + 1))
            ee = np.concatenate((side_breaks + 1, [len(seg)]))
            for s2, e2 in zip(ss, ee):
                glen = e2 - s2
                score -= min(
                    params.gap_open[pw] + params.gap_extend[pw] * glen
                    for pw in range(len(params.gap_open))
                )
    return int(score)


def induced_pairwise_alignment(graph: BaseGraph, path_id1: int, path_id2: int) -> np.ndarray:
    """Pairwise alignment induced by two embedded paths: positions sharing a
    node align; equal-length double-gap runs up to 4 become mismatches
    (reference src/alignment.cpp:125-228). Row values are *path positions*."""
    path1 = graph.path(path_id1)
    path2 = graph.path(path_id2)
    index1 = np.full(graph.node_size, -1, dtype=_I64)
    if len(np.unique(path1)) != len(path1):
        raise ValueError("Cannot induce a colinear pairwise alignment from a "
                         "sequence that follows cycles in the graph")
    index1[path1] = np.arange(len(path1))

    rows = []
    j = 0
    for i in range(len(path2)):
        pos1 = index1[path2[i]]
        if pos1 == -1:
            rows.append((GAP, i))
        else:
            while j < pos1:
                rows.append((j, GAP))
                j += 1
            rows.append((j, i))
            j += 1
    while j < len(path1):
        rows.append((j, GAP))
        j += 1

    # consolidate equal-length double-gap runs (<= 4) into mismatches
    out = []
    i = 0
    max_mismatch_size = 4
    while i < len(rows):
        if rows[i][0] != GAP and rows[i][1] != GAP:
            out.append(rows[i])
            i += 1
            continue
        j2 = i
        gaps1 = gaps2 = 0
        while j2 < len(rows) and (rows[j2][0] == GAP or rows[j2][1] == GAP):
            gaps1 += rows[j2][0] == GAP
            gaps2 += rows[j2][1] == GAP
            j2 += 1
        last1, last2 = (out[-1] if out else (-1, -1))
        if gaps1 == gaps2 and gaps1 <= max_mismatch_size:
            for n in range(gaps1):
                out.append((last1 + n + 1, last2 + n + 1))
        else:
            for n in range(gaps2):
                out.append((last1 + n + 1, GAP))
            for n in range(gaps1):
                out.append((GAP, last2 + n + 1))
        i = j2
    return np.array(out, dtype=_I64).reshape(-1, 2)


def fuse(dest: BaseGraph, source: BaseGraph,
         dest_tab: SentinelTableau, source_tab: SentinelTableau,
         alignment: np.ndarray) -> np.ndarray:
    """Merge ``source`` into ``dest`` along the alignment (reference
    fuse.hpp:46-180): label-equal aligned pairs merge into the dest node,
    mismatched pairs become substitution edges, unmatched source nodes are
    appended, then source edges and paths are translated in. Returns the
    source->dest node translation array."""
    V2 = source.node_size
    trans = np.full(V2, -1, dtype=_I64)

    a1, a2 = alignment[:, 0], alignment[:, 1]
    both = (a1 != GAP) & (a2 != GAP)
    lab_eq = np.zeros(len(alignment), dtype=bool)
    if both.any():
        lab_eq[both] = dest.labels[a1[both]] == source.labels[a2[both]]
    matched = both & lab_eq
    trans[a2[matched]] = a1[matched]

    trans[source_tab.src_id] = dest_tab.src_id
    trans[source_tab.snk_id] = dest_tab.snk_id

    # append unmatched nodes in source-id order
    unmatched = np.flatnonzero(trans == -1)
    new_ids = dest.add_nodes(source.labels[unmatched])
    trans[unmatched] = new_ids

    # substitution edges: for each aligned mismatch at row i, connect into the
    # dest backbone at the nearest non-gap-on-side-1 rows left and right
    mismatch = both & ~lab_eq
    if mismatch.any():
        n = len(alignment)
        has1 = a1 != GAP
        idx = np.arange(n, dtype=_I64)
        # nearest row with a side-1 node strictly to the right (-1 if none)
        tmp = np.where(has1, idx, n)
        nxt_incl = np.minimum.accumulate(tmp[::-1])[::-1]
        nxt_right = np.concatenate((nxt_incl[1:], [np.int64(n)]))
        nxt_right = np.where(nxt_right == n, -1, nxt_right)
        # nearest row with a side-1 node strictly to the left (-1 if none)
        tmp = np.where(has1, idx, -1)
        prv_incl = np.maximum.accumulate(tmp)
        prv_left = np.concatenate(([np.int64(-1)], prv_incl[:-1]))
        ef, et = [], []
        for i in np.flatnonzero(mismatch):
            j = nxt_right[i]
            if j != -1:
                ef.append(trans[a2[i]])
                et.append(a1[j])
            j = prv_left[i]
            if j != -1:
                ef.append(a1[j])
                et.append(trans[a2[i]])
        if ef:
            dest.add_edges(np.array(ef, dtype=_I64), np.array(et, dtype=_I64))

    # translate remaining source edges, deduping against existing dest edges
    sef, set_ = source.edges()
    if len(sef):
        tef, tet = trans[sef], trans[set_]
        VD = dest.node_size
        new_keys = tef * VD + tet
        def_, det = dest.edges()
        exist = def_ * VD + det
        missing = ~np.isin(new_keys, exist)
        # also dedup within the batch itself, keeping first occurrence,
        # matching the reference's per-node membership check
        uniq_keys, first_idx = np.unique(new_keys[missing], return_index=True)
        order = np.sort(first_idx)
        sel = np.flatnonzero(missing)[order]
        # preserve (source-node-id, adjacency) order: the reference iterates
        # source nodes in id order and their next() lists in insertion order.
        # source.edges() is in global insertion order, so re-sort by CSR order
        csr_order = np.lexsort((np.arange(len(sef))[sel], sef[sel]))
        sel = sel[csr_order]
        dest.add_edges(tef[sel], tet[sel])

    # copy paths
    for pid in range(source.path_size):
        new_pid = dest.add_path(source.path_name(pid))
        dest.extend_path_array(new_pid, trans[source.path(pid)])

    return trans


class UnionFind:
    """Union-by-rank with path compression, replicating the reference's
    root-selection ties (union_find.hpp:44-77) so that group enumeration
    order matches."""

    def __init__(self, n: int):
        self.head = list(range(n))
        self.rank = [0] * n

    def find(self, i: int) -> int:
        path = []
        while self.head[i] != i:
            path.append(i)
            i = self.head[i]
        for p in range(1, len(path)):
            self.head[path[p - 1]] = i
        return i

    def union(self, i: int, j: int) -> None:
        hi, hj = self.find(i), self.find(j)
        if hi == hj:
            return
        if self.rank[hi] > self.rank[hj]:
            self.head[hj] = hi
        else:
            self.head[hi] = hj
            if self.rank[hj] == self.rank[hi]:
                self.rank[hj] += 1

    def groups(self):
        """Groups ordered by root id ascending, members ascending
        (union_find.hpp:79-88)."""
        out = {}
        for i in range(len(self.head)):
            out.setdefault(self.find(i), []).append(i)
        return [out[r] for r in sorted(out)]


def internal_fuse(graph: BaseGraph, alignments, tableau_in=None,
                  alignment_in=None):
    """Merge the graph with itself along self-alignments (reference
    fuse.hpp:145-243): aligned pairs union transitively; each group becomes
    one node per distinct label (label-sorted); edges dedup; paths rewalked.

    Returns (fused graph, tableau_out or None, alignment_out or None)."""
    V = graph.node_size
    uf = UnionFind(V)
    for aln in alignments:
        for a, b in aln:
            if a != GAP and b != GAP:
                uf.union(int(a), int(b))

    fused = BaseGraph()
    trans = np.full(V, -1, dtype=np.int64)
    labels = graph.labels
    for group in uf.groups():
        by_label = {}
        for v in group:
            by_label.setdefault(int(labels[v]), []).append(v)
        for lab in sorted(by_label):
            nid = fused.add_node(lab)
            for v in by_label[lab]:
                trans[v] = nid

    tableau_out = None
    if tableau_in is not None:
        from .modify_graph import SentinelTableau
        tableau_out = SentinelTableau(
            src_id=int(trans[tableau_in.src_id]),
            snk_id=int(trans[tableau_in.snk_id]),
            src_sentinel=tableau_in.src_sentinel,
            snk_sentinel=tableau_in.snk_sentinel)

    seen = [set() for _ in range(fused.node_size)]
    ef, et = [], []
    nptr, nind = graph.next_csr()
    for v in range(V):
        fv = int(trans[v])
        bucket = seen[fv]
        for k in range(nptr[v], nptr[v + 1]):
            fn = int(trans[nind[k]])
            if fn not in bucket:
                bucket.add(fn)
                ef.append(fv)
                et.append(fn)
    if ef:
        fused.add_edges(np.array(ef, dtype=np.int64),
                        np.array(et, dtype=np.int64))

    for pid in range(graph.path_size):
        fp = fused.add_path(graph.path_name(pid))
        fused.extend_path_array(fp, trans[graph.path(pid)])

    alignment_out = None
    if alignment_in is not None and len(alignment_in):
        alignment_out = np.asarray(alignment_in, dtype=np.int64).copy()
        m1 = alignment_out[:, 0] != GAP
        m2 = alignment_out[:, 1] != GAP
        alignment_out[m1, 0] = trans[alignment_out[m1, 0]]
        alignment_out[m2, 1] = trans[alignment_out[m2, 1]]

    return fused, tableau_out, alignment_out

"""Exact host implementation of partial-order × partial-order alignment.

Behavioral twin of the reference's po_poa (reference
include/centrolign/alignment.hpp:753-1150): int32 DP over (V1+1) × (V2+1)
cells {M, I[pw], D[pw]} with a boundary row/column at index V, topological
propagation, global opt over designated sink pairs, and a traceback whose
tie-breaking follows the reference exactly:

- gap-close preference at an M cell: I[0], D[0], I[1], D[1], ... then diagonal
- diagonal predecessor: the *last* prev1 (adjacency order, boundary appended
  last) that has a matching prev2 wins, with its *first* matching prev2
- within a gap component: gap-open before gap-extend, per predecessor in
  adjacency order
- boundary column I never re-opens from M (and boundary row D likewise)

The fill is a row-sweep pull formulation (provably equivalent to the
reference's push loops): rows advance in graph1-topological order with
whole-row numpy updates; the within-row D propagation walks graph2's
topological order. This is the correctness oracle for device kernels and the
host fallback for small problems.

Copy of centrolign_tpu/ops/popoa_ref.py (numpy only).
"""

from __future__ import annotations

import numpy as np

from .align_params import AlignmentParams, MININF
from ..alignment import GAP
from ..graph_algs import topological_order

_I32 = np.int32
_I64 = np.int64


def _csr_segments_max(values: np.ndarray, indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """out[v] = max(values[indices[indptr[v]:indptr[v+1]]]) or MININF if empty."""
    V = len(indptr) - 1
    out = np.full(V, MININF, dtype=values.dtype)
    if len(indices) == 0:
        return out
    gathered = values[indices]
    nonempty = indptr[:-1] < indptr[1:]
    segmax = np.maximum.reduceat(gathered, indptr[:-1][nonempty])
    out[nonempty] = segmax
    return out


def popoa_fill(graph1, graph2, sources1, sources2, params: AlignmentParams):
    """Fill DP matrices. Returns (M, I, D): M (V1+1, V2+1) int32,
    I/D (num_pw, V1+1, V2+1). Index V1/V2 is the boundary row/column."""
    V1, V2 = graph1.node_size, graph2.node_size
    npw = params.num_pw
    lab1 = graph1.labels.astype(np.int16)
    lab2 = graph2.labels.astype(np.int16)
    order1 = topological_order(graph1)
    order2 = topological_order(graph2)
    go = np.array(params.gap_open, dtype=_I32)
    ge = np.array(params.gap_extend, dtype=_I32)
    match, mismatch = params.match, params.mismatch

    sources1 = np.asarray(sources1, dtype=_I64)
    sources2 = np.asarray(sources2, dtype=_I64)
    is_src1 = np.zeros(V1, dtype=bool)
    is_src1[sources1] = True

    M = np.full((V1 + 1, V2 + 1), MININF, dtype=_I32)
    I = np.full((npw, V1 + 1, V2 + 1), MININF, dtype=_I32)
    D = np.full((npw, V1 + 1, V2 + 1), MININF, dtype=_I32)

    p1_ptr, p1_ind = graph1.prev_csr()
    n2_ptr, n2_ind = graph2.next_csr()
    p2_ptr, p2_ind = graph2.prev_csr()

    # alignment score of node n1 against every graph2 node, plus a MININF
    # guard in the boundary slot
    def align_row(n1):
        row = np.where(lab2 == lab1[n1], match, -mismatch).astype(_I32)
        return np.concatenate((row, [_I32(MININF)]))

    # --- corner inits (reference alignment.hpp:813-830)
    for s1 in sources1:
        M[s1, sources2] = np.maximum(M[s1, sources2], align_row(s1)[sources2])
        I[:, s1, V2] = -go - ge
    for s2 in sources2:
        D[:, V1, s2] = -go - ge

    # --- boundary row (i = V1): lead deletions along graph2
    # (reference "DP along initial deletions", alignment.hpp:861-895)
    for n2 in order2:
        M[V1, n2] = max(M[V1, n2], int(D[:, V1, n2].max(initial=MININF)))
        nxt2 = n2_ind[n2_ptr[n2]:n2_ptr[n2 + 1]]
        if len(nxt2):
            # boundary row D extends only (no re-open from M)
            D[:, V1, nxt2] = np.maximum(D[:, V1, nxt2], (D[:, V1, n2] - ge)[:, None])

    # --- interior + boundary column, row-sweep in graph1 topo order
    for n1 in order1:
        prevs1 = p1_ind[p1_ptr[n1]:p1_ptr[n1 + 1]]
        pull_rows = list(prevs1)
        if is_src1[n1]:
            pull_rows.append(V1)
        srow = align_row(n1)

        if pull_rows:
            Mprev = M[pull_rows]                       # (P, V2+1)
            Iprev = I[:, pull_rows, :]                 # (npw, P, V2+1)
            # I pull: open from M, extend from I — but never open in the
            # boundary column (reference boundary-column loop extends only)
            iopen = Mprev[None] - (go + ge)[:, None, None]
            iopen[:, :, V2] = MININF
            icand = np.maximum(iopen, Iprev - ge[:, None, None]).max(axis=1)
            I[:, n1, :] = np.maximum(I[:, n1, :], icand)
            # diagonal pull: P[j'] = max over pull rows of M[., j'], then
            # Mdiag[j] = align + max over p2 in prev2(j) (boundary appended)
            Pmax = Mprev.max(axis=0)                   # (V2+1,)
            Q = _csr_segments_max(Pmax, p2_ptr, p2_ind)  # over real prev2
            # sources2 additionally pull from the boundary column j' = V2
            Q[sources2] = np.maximum(Q[sources2], Pmax[V2])
            diag = np.where(Q > MININF // 2, Q + srow[:V2], MININF).astype(_I32)
            M[n1, :V2] = np.maximum(M[n1, :V2], diag)

        # fold I into M in the boundary column
        M[n1, V2] = max(M[n1, V2], int(I[:, n1, V2].max(initial=MININF)))

        # within-row: fold and propagate D in graph2 topological order
        Mrow = M[n1]
        Irow = I[:, n1, :]
        Drow = D[:, n1, :]
        # D open from the boundary column into sources2
        if Mrow[V2] > MININF // 2:
            Drow[:, sources2] = np.maximum(
                Drow[:, sources2], (Mrow[V2] - go - ge)[:, None])
        for n2 in order2:
            m = int(Mrow[n2])
            im = int(Irow[:, n2].max(initial=MININF))
            dm = int(Drow[:, n2].max(initial=MININF))
            m = max(m, im, dm)
            Mrow[n2] = m
            nxt2 = n2_ind[n2_ptr[n2]:n2_ptr[n2 + 1]]
            if len(nxt2):
                cand = np.maximum(m - go - ge, Drow[:, n2] - ge)
                Drow[:, nxt2] = np.maximum(Drow[:, nxt2], cand[:, None])

    return M, I, D


def popoa_traceback(graph1, graph2, sources1, sources2, sinks1, sinks2,
                    params: AlignmentParams, M, I, D):
    """Reference-exact traceback (alignment.hpp:1010-1145)."""
    V1, V2 = graph1.node_size, graph2.node_size
    npw = params.num_pw
    lab1, lab2 = graph1.labels, graph2.labels
    go, ge = params.gap_open, params.gap_extend
    src1 = set(int(s) for s in np.asarray(sources1).ravel())
    src2 = set(int(s) for s in np.asarray(sources2).ravel())

    p1_ptr, p1_ind = graph1.prev_csr()
    p2_ptr, p2_ind = graph2.prev_csr()

    # global opt among sink pairs (first strictly better wins)
    tb1 = tb2 = -1
    if V1 and V2:
        for s1 in sinks1:
            for s2 in sinks2:
                if tb1 == -1 or M[s1, s2] > M[tb1, tb2]:
                    tb1, tb2 = int(s1), int(s2)
    elif V1:
        for s1 in sinks1:
            if tb1 == -1 or M[s1, 0] > M[tb1, 0]:
                tb1, tb2 = int(s1), 0
    elif V2:
        for s2 in sinks2:
            if tb2 == -1 or M[0, s2] > M[0, tb2]:
                tb1, tb2 = 0, int(s2)

    score = int(M[tb1, tb2]) if tb1 != -1 else 0

    aln: list[tuple[int, int]] = []
    tb_comp = 0
    while tb1 != -1 and tb2 != -1:
        here1, here2 = tb1, tb2
        tb1 = tb2 = -1
        if tb_comp == 0:
            for pw in range(npw):
                if M[here1, here2] == I[pw, here1, here2]:
                    tb_comp = pw + 1
                    break
                if M[here1, here2] == D[pw, here1, here2]:
                    tb_comp = -pw - 1
                    break
        previous1 = list(p1_ind[p1_ptr[here1]:p1_ptr[here1 + 1]]) if here1 < V1 else []
        previous2 = list(p2_ind[p2_ptr[here2]:p2_ptr[here2 + 1]]) if here2 < V2 else []
        if here1 in src1:
            previous1.append(V1)
        if here2 in src2:
            previous2.append(V2)

        if tb_comp == 0:
            aln.append((here1, here2))
            a = params.match if lab1[here1] == lab2[here2] else -params.mismatch
            target = int(M[here1, here2])
            for prev1 in previous1:
                for prev2 in previous2:
                    if int(M[prev1, prev2]) + a == target:
                        tb1, tb2 = int(prev1), int(prev2)
                        break  # inner only: last prev1 with a match wins
        elif tb_comp > 0:
            pw = tb_comp - 1
            aln.append((here1, GAP))
            v = int(I[pw, here1, here2])
            for prev1 in previous1:
                if v == int(M[prev1, here2]) - go[pw] - ge[pw]:
                    tb_comp = 0
                    tb1, tb2 = int(prev1), here2
                    break
                if v == int(I[pw, prev1, here2]) - ge[pw]:
                    tb1, tb2 = int(prev1), here2
                    break
        else:
            pw = -tb_comp - 1
            aln.append((GAP, here2))
            v = int(D[pw, here1, here2])
            for prev2 in previous2:
                if v == int(M[here1, prev2]) - go[pw] - ge[pw]:
                    tb_comp = 0
                    tb1, tb2 = here1, int(prev2)
                    break
                if v == int(D[pw, here1, prev2]) - ge[pw]:
                    tb1, tb2 = here1, int(prev2)
                    break

    aln.reverse()
    out = np.array(aln, dtype=_I64).reshape(-1, 2)
    return out, score


def popoa(graph1, graph2, sources1, sources2, sinks1, sinks2,
          params: AlignmentParams):
    """Full PO-POA: fill + traceback. Returns (alignment, score)."""
    M, I, D = popoa_fill(graph1, graph2, sources1, sources2, params)
    return popoa_traceback(graph1, graph2, sources1, sources2, sinks1, sinks2,
                           params, M, I, D)

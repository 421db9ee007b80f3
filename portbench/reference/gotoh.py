"""Plain NumPy reference of the chain tier's piecewise-affine Gotoh
alignment: the fill, its backpointers and the traceback, with the tie rules
of the port's kernels, and the score of any alignment.

Written for the benchmark from the recurrence and tie rules that
centrolign_tpu_torch/ops/gotoh.py documents (a frozen restatement, not an
import: it reads nothing of the port). A job is (seq1, seq2, swap_pref,
match, mismatch, gap_open, gap_extend) with the sequences as integer
codes. Cells hold

    M(i, j) = max(M(i-1, j-1) + s(i, j), I_p(i, j), D_p(i, j))
    I_p(i, j) = max(M(i-1, j) - go_p - ge_p, I_p(i-1, j) - ge_p)
    D_p(i, j) = max(M(i, j-1) - go_p - ge_p, D_p(i, j-1) - ge_p)

with M(0, 0) = 0, s = match on equal codes and -mismatch otherwise, I
consuming seq1 and D seq2, and cells outside the matrix at MININF. The
fill runs a row of i at a time: I from the row above, then D along the
row by a running maximum of M(i, k) + ge_p k, once over the row's M
without D and once over the whole M (a deletion opened from a deletion of
another piece never scores best, so the first pass gives M and the second
the exact D). Backpointers, as the kernels pack them: bits 0-2 the source
of M, the first of I_0, D_0, I_1, D_1, ... equal to it (D before I for a
swapped job), else the diagonal; bit 3 + p when I_p ties or beats its
extension by opening; bit 6 + p the same for D_p.

`dtype` is the precision of the cells: int32 as the configuration states
(the C++ reference's IntDP), or int16 for the control, whose sums wrap.
"""

from __future__ import annotations

import numpy as np

GAP = -1
MAX_PW = 3


def _mininf(dtype) -> int:
    return -(int(np.iinfo(dtype).max) + 1) // 2


def fill(seq1, seq2, swap, match, mismatch, gap_open, gap_extend,
         dtype=np.int32):
    """(backpointers uint16 (V1+1, V2+1), score) of one job."""
    dt = np.dtype(dtype)
    neg = dt.type(_mininf(dt))
    a = np.asarray(seq1, np.int64)
    b = np.asarray(seq2, np.int64)
    V1, V2 = len(a), len(b)
    P = len(gap_open)
    if not 1 <= P <= MAX_PW or len(gap_extend) != P:
        raise ValueError(f"1 to {MAX_PW} gap pieces, not {P}")
    go = [dt.type(x) for x in gap_open]
    ge = [dt.type(x) for x in gap_extend]
    go_ge = [dt.type(g + e) for g, e in zip(go, ge)]
    # ge_p * k along a row, for the running maxima
    ramp = [np.arange(V2 + 1, dtype=np.int64).astype(dt) * e for e in ge]
    # the codes of M's sources in priority order
    order = []
    for p in range(P):
        pair = [("D", p, 2 + 2 * p), ("I", p, 1 + 2 * p)] if swap else \
            [("I", p, 1 + 2 * p), ("D", p, 2 + 2 * p)]
        order += pair
    bp = np.zeros((V1 + 1, V2 + 1), np.uint16)
    # s(i, j) for each code seq1 may hold
    codes = np.unique(a)
    subst = {int(c): np.where(b == c, dt.type(match),
                              dt.type(-mismatch)).astype(dt) for c in codes}
    bit_i = [np.uint16(1 << (3 + p)) for p in range(P)]
    bit_d = [np.uint16(1 << (6 + p)) for p in range(P)]
    with np.errstate(over="ignore"):
        M_prev = np.full(V2 + 1, neg, dt)
        I_prev = [np.full(V2 + 1, neg, dt) for _ in range(P)]
        for i in range(V1 + 1):
            M0 = np.full(V2 + 1, neg, dt)
            I = []
            i_open = []
            if i >= 1:
                M0[1:] = M_prev[:-1] + subst[int(a[i - 1])]
                for p in range(P):
                    op = M_prev - go_ge[p]
                    I.append(np.maximum(op, I_prev[p] - ge[p]))
                    i_open.append(op)
                    M0 = np.maximum(M0, I[p])
            else:
                I = [np.full(V2 + 1, neg, dt) for _ in range(P)]
                M0[0] = 0
            M = M0
            for p in range(P):
                M = np.maximum(M, _deletions(M0, ramp[p], go[p], neg))
            if i == 0:
                M[0] = 0
            D, d_open = [], []
            for p in range(P):
                d = _deletions(M, ramp[p], go[p], neg)
                D.append(d)
                op = np.full(V2 + 1, neg, dt)
                op[1:] = M[:-1] - go_ge[p]
                d_open.append(op)
            row = np.zeros(V2 + 1, np.uint16)
            code = np.zeros(V2 + 1, np.uint16)
            for p in range(P):
                if i >= 1:
                    row[I[p] == i_open[p]] |= bit_i[p]
                opened = D[p] == d_open[p]
                opened[0] = False
                row[opened] |= bit_d[p]
            for kind, p, c in reversed(order):
                src = I[p] if kind == "I" else D[p]
                hit = src == M
                if kind == "I" and i == 0:
                    hit[:] = False
                if kind == "D":
                    hit[0] = False
                code[hit] = c
            if i == 0:
                code[0] = 0
            bp[i] = row | code
            M_prev, I_prev = M, I
    return bp, int(M_prev[V2])


def _deletions(M, ramp, go, neg):
    """D(j) = max over k < j of M(k) - go - ge (j - k), D(0) = MININF:
    the running maximum of M(k) + ge k, shifted by one."""
    run = np.maximum.accumulate(M + ramp)
    out = np.empty_like(M)
    out[0] = neg
    out[1:] = run[:-1] - ramp[1:] - go
    return out


def traceback(bp: np.ndarray) -> np.ndarray:
    """The alignment (L, 2) int64, GAP = -1, walked from (V1, V2). Raises
    ValueError where the backpointers lead out of the matrix (they cannot,
    from a fill of exact cells)."""
    i, j = bp.shape[0] - 1, bp.shape[1] - 1
    comp = 0
    pairs = []
    while i != 0 or j != 0:
        if i < 0 or j < 0:
            raise ValueError("the backpointers lead out of the matrix")
        b = int(bp[i, j])
        if comp == 0:
            code = b & 0b111
            if code == 0:
                pairs.append((i - 1, j - 1))
                i -= 1
                j -= 1
                continue
            comp = (code + 1) // 2 if code % 2 == 1 else -(code // 2)
        if comp > 0:
            pairs.append((i - 1, GAP))
            if (b >> (3 + comp - 1)) & 1:
                comp = 0
            i -= 1
        else:
            pairs.append((GAP, j - 1))
            if (b >> (6 - comp - 1)) & 1:
                comp = 0
            j -= 1
    pairs.reverse()
    return np.array(pairs, dtype=np.int64).reshape(-1, 2)


def align(job, dtype=np.int32):
    """(alignment, score) of a job (seq1, seq2, swap, match, mismatch,
    gap_open, gap_extend)."""
    bp, score = fill(*job, dtype=dtype)
    return traceback(bp), score


def score_of(alignment, seq1, seq2, match, mismatch, gap_open, gap_extend):
    """The score of an alignment of seq1 against seq2 under the job's
    parameters, each maximal gap run at its cheapest piece; None when the
    alignment does not take every position of both sequences once, in
    order."""
    aln = np.asarray(alignment, np.int64).reshape(-1, 2)
    a = np.asarray(seq1, np.int64)
    b = np.asarray(seq2, np.int64)
    for col, n in ((aln[:, 0], len(a)), (aln[:, 1], len(b))):
        used = col[col != GAP]
        if not np.array_equal(used, np.arange(n)):
            return None
    both = (aln[:, 0] != GAP) & (aln[:, 1] != GAP)
    if ((aln[:, 0] == GAP) & (aln[:, 1] == GAP)).any():
        return None
    eq = a[aln[both, 0]] == b[aln[both, 1]]
    total = int(eq.sum()) * match - int((~eq).sum()) * mismatch
    kind = np.where(both, 0, np.where(aln[:, 1] == GAP, 1, 2))
    if len(kind):
        change = np.flatnonzero(np.diff(kind)) + 1
        starts = np.concatenate(([0], change))
        ends = np.concatenate((change, [len(kind)]))
        for s, e in zip(starts, ends):
            if kind[s]:
                L = e - s
                total -= min(g + x * L for g, x in zip(gap_open, gap_extend))
    return total

"""DAG x DAG PO-POA over anti-diagonals of topological positions (twin of
centrolign_tpu/ops/popoa_dag.py).

In any topological order every edge goes forward, so cell (r1, r2) — r1,
r2 positions in the two orders — depends only on cells of smaller
anti-diagonal r1 + r2. Each node's predecessors become offsets (delta = own
position minus predecessor position); with in-degree <= K and offsets <= S
a diagonal is computed from rings of the last S diagonals.

Semantics are the JAX package's, an exact twin of ops.popoa_ref.popoa
(itself the byte-parity twin of reference alignment.hpp:753-1150):

 - int32 DP cells {M, I[pw], D[pw]}, MININF = -2^30, with the JAX
   expressions' unguarded MININF-minus-gap terms (every value stays above
   MININF - 2 * (go + ge), so nothing wraps);
 - the boundary row/column (lead deletions/insertions) is precomputed on
   the host and fed to the fill as vectors;
 - the traceback tie rules are encoded during the fill into one packed
   int32 per cell: the M source (first match in I0, D0, I1, D1, ...), the
   diagonal predecessor pair (last prev1 in adjacency order with a
   matching prev2, then that prev1's first matching prev2, from a
   two-stage column-max PM ring with a last-wins argmax), and per gap
   piece the I/D choice digit k + 5*open (first predecessor in adjacency
   order, open before extend); the source-pair corner wins only when
   strictly better;
 - the traceback walks the packed backpointers until it enters the
   boundary row/column (the lead gap), which the host finishes from its
   boundary arrays.

Envelope: in-degree <= K_MAX = 4 and topological span <= S_MAX = 32 on
both sides. K_MAX is where the base-5 packing of predecessor slots decodes
exactly (slots 0..K plus the boundary slot K must stay below 5); the JAX
package admits K <= 8 and misdecodes slots >= 5. A graph outside the
envelope goes to the host `po` engine.

Launch layout, shared by the plain versions here and the CUDA kernels of
csrc/popoa_dag.cu (built by ops/popoa_dag_cuda.py::dag_job_table and
pack_dag_jobs):
 - one int32 table row of N_COLS per job (COL_* below);
 - one int32 `data` buffer: per job a graph-1 block of (6 + K1) rows of V1
   (labels, is-source, boundary-column M, boundary-column diagonal value,
   its k1, sink index or -1, then K1 delta rows), a graph-2 block of
   (4 + K2) rows of V2 (labels, is-source, boundary-row M, sink index or
   -1, then K2 delta rows) and the sink positions (n1, then n2);
 - backpointers: one int32 per in-matrix cell, V1 * V2 per job at an int64
   offset, diagonal-major (diagonal d holds r1 = lo(d)..hi(d) in order);
 - sink M: M at every (sink1, sink2) pair, n1 * n2 per job, s1-major.
The traceback writes (n, cap + 3, 2) int32 rows per launch: row 0 =
(count, exit kind), row 1 = (exit r1, exit r2), row 2 = (best score, best
sink pair), the pairs (positions, GAP = -1) end at the last row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..alignment import GAP
from .align_params import MININF, AlignmentParams

_I32 = np.int32
_I64 = np.int64
_NEG = np.int32(MININF)
_NEG_HALF = np.int32(MININF // 2)

K_MAX = 4    # real predecessor slots; slot index K == boundary
S_MAX = 32   # max topological edge span
MAX_PW = 3

# table columns
(COL_V1, COL_V2, COL_K1, COL_K2, COL_R, COL_NPW, COL_MATCH,
 COL_MISMATCH) = range(8)
COL_GO, COL_GE = 8, 11          # MAX_PW columns each
COL_G1, COL_G2, COL_N1, COL_N2, COL_SINKPOS, COL_SINKM = range(14, 20)
COL_BP_LO, COL_BP_HI, COL_SCRATCH_LO, COL_SCRATCH_HI = range(20, 24)
N_COLS = 24
# rows of a graph-1 / graph-2 block before the delta rows
G1_LAB, G1_SRC, G1_BCOLM, G1_BDIAG, G1_BDIAGK1, G1_SINK, G1_DELTA = range(7)
G2_LAB, G2_SRC, G2_BROWM, G2_SINK, G2_DELTA = range(5)
HEADER_ROWS = 3

# how a traceback walk ended
_EXIT_ROW = 1       # walk continues on the boundary row (r1 == V1)
_EXIT_COL = 2       # walk continues on the boundary column (r2 == V2)
_EXIT_CORNER = 3    # terminated at the source-pair corner
_EXIT_NO_ALIGNMENT = 4  # best sink score <= MININF / 2
_EXIT_LOST = 5      # no exit within V1 + V2 steps (a broken backpointer)


# ---------------------------------------------------------------------------
# host-side graph tables


class DagTables:
    """Topological-position-space tables for one graph."""

    def __init__(self, graph, sources):
        from ..native import reference_topological_order
        V = graph.node_size
        self.V = V
        order = reference_topological_order(graph)
        self.order = order
        pos = np.empty(V, dtype=_I64)
        pos[order] = np.arange(V)
        self.pos = pos
        pptr, pind = graph.prev_csr()
        indeg = pptr[1:] - pptr[:-1]
        self.K = int(indeg.max()) if V else 0
        K = max(self.K, 1)
        # delta[k, r] = r - pos[k-th predecessor (CSC adjacency order)] or 0
        delta = np.zeros((K, V), dtype=_I32)
        nodes = np.arange(V)
        for k in range(self.K):
            has = indeg > k
            prevs = pind[pptr[:-1][has] + k]
            delta[k, pos[nodes[has]]] = (pos[nodes[has]] - pos[prevs])
        self.delta = delta
        self.S = int(delta.max()) if V else 0
        self.is_src = np.zeros(max(V, 1), dtype=_I32)
        self.is_src[pos[np.asarray(sources, dtype=_I64)]] = 1
        self.labels = graph.labels[order].astype(_I32)

    @property
    def eligible(self) -> bool:
        return self.K <= K_MAX and self.S <= S_MAX and self.V >= 1


def _boundaries(t1: DagTables, t2: DagTables, params: AlignmentParams):
    """Boundary column (graph1 side, lead insertions) and boundary row
    (graph2 side, lead deletions) in position space, exact popoa_ref
    arithmetic, plus the boundary-column diagonal tables."""
    npw = params.num_pw
    go = np.asarray(params.gap_open, dtype=_I32)
    ge = np.asarray(params.gap_extend, dtype=_I32)

    def one_side(t: DagTables):
        # seeds -go-ge at sources, pull-extend (-ge) along predecessors
        # (popoa_ref corner init + the extend-only boundary loops)
        arr = np.full((npw, t.V), _NEG, dtype=_I32)
        arr[:, t.is_src[:t.V].astype(bool)] = (-go - ge)[:, None]
        for r in range(t.V):
            for k in range(t.K):
                d = t.delta[k, r]
                if d:
                    np.maximum(arr[:, r], arr[:, r - d] - ge, out=arr[:, r])
        return arr

    bcol_I = one_side(t1)                    # I[pw, u, V2]
    bcol_M = bcol_I.max(axis=0)
    brow_D = one_side(t2)                    # D[pw, V1, v]
    brow_M = brow_D.max(axis=0)

    # diagonal pulls from the boundary COLUMN (prev2 = V2): value
    # max over real prev1 of M[prev1, V2] = bcol_M, plus the last-wins
    # argmax k1 (the reference scans prev1 in adjacency order)
    bdiag = np.full(t1.V, _NEG, dtype=_I32)
    bdiag_k1 = np.zeros(t1.V, dtype=_I32)
    for k in range(t1.K):
        d = t1.delta[k]
        has = d > 0
        cand = np.full(t1.V, _NEG, dtype=_I32)
        cand[has] = bcol_M[np.arange(t1.V)[has] - d[has]]
        upd = has & (cand >= bdiag)
        bdiag[upd] = cand[upd]
        bdiag_k1[upd] = k
    return bcol_I, bcol_M, brow_D, brow_M, bdiag, bdiag_k1


def _first_occurrences(positions) -> np.ndarray:
    """`positions` without repeats, in order of first occurrence. The first
    best pair of the s1-major sink-pair scan is always a pair of first
    occurrences, so the scan over these gives the same pair."""
    positions = np.asarray(positions, dtype=_I64)
    _, first = np.unique(positions, return_index=True)
    return positions[np.sort(first)]


# ---------------------------------------------------------------------------
# host boundary completion


def _finish_boundary_row(t2: DagTables, params, brow_D, brow_M, j):
    """D-walk along the boundary row from (V1, j) in M state, exactly like
    popoa_ref.popoa_traceback. Returns pairs (GAP, j) in backward order."""
    npw = params.num_pw
    go, ge = params.gap_open, params.gap_extend
    pairs = []
    comp = 0
    while True:
        if comp == 0:
            # M[V1, j] is the D fold; I[pw, V1, j] is MININF and the
            # reference's I checks can never match a real value first
            found = False
            for pw in range(npw):
                if brow_M[j] == brow_D[pw, j]:
                    comp = -pw - 1
                    found = True
                    break
            if not found:
                break
        pw = -comp - 1
        v = int(brow_D[pw, j])
        pairs.append((GAP, int(j)))
        nxt = None
        for k in range(t2.K):
            dlt = int(t2.delta[k, j])
            if dlt == 0:
                continue
            if v == int(brow_M[j - dlt]) - go[pw] - ge[pw]:
                nxt = j - dlt
                comp = 0
                break
            if v == int(brow_D[pw, j - dlt]) - ge[pw]:
                nxt = j - dlt
                break
        # the boundary prev2 (the corner) never matches: M/D there are junk
        if nxt is None:
            break
        j = nxt
    return pairs


def _finish_boundary_col(t1: DagTables, params, bcol_I, bcol_M, i):
    """I-walk along the boundary column from (i, V2) in M state."""
    npw = params.num_pw
    go, ge = params.gap_open, params.gap_extend
    pairs = []
    comp = 0
    while True:
        if comp == 0:
            found = False
            for pw in range(npw):
                if bcol_M[i] == bcol_I[pw, i]:
                    comp = pw + 1
                    found = True
                    break
            if not found:
                break
        pw = comp - 1
        v = int(bcol_I[pw, i])
        pairs.append((int(i), GAP))
        nxt = None
        for k in range(t1.K):
            dlt = int(t1.delta[k, i])
            if dlt == 0:
                continue
            # the reference checks open-from-M first even though the
            # boundary column never opens in the fill — value equality can
            # still hold and decides the path (alignment.hpp traceback)
            if v == int(bcol_M[i - dlt]) - go[pw] - ge[pw]:
                nxt = i - dlt
                comp = 0
                break
            if v == int(bcol_I[pw, i - dlt]) - ge[pw]:
                nxt = i - dlt
                break
        if nxt is None:
            break
        i = nxt
    return pairs


# ---------------------------------------------------------------------------
# jobs


class _DagJob:
    __slots__ = ("t1", "t2", "bcol_I", "bcol_M", "brow_D", "brow_M",
                 "bdiag", "bdiag_k1", "sinks1", "sinks2", "sink_pos1",
                 "sink_pos2", "params")

    def __init__(self, graph1, graph2, sources1, sources2, sinks1, sinks2,
                 params):
        self.t1 = DagTables(graph1, sources1)
        self.t2 = DagTables(graph2, sources2)
        self.sinks1 = sinks1
        self.sinks2 = sinks2
        self.params = params

    @property
    def eligible(self):
        return bool(self.t1.eligible and self.t2.eligible
                    and len(self.sinks1) and len(self.sinks2)
                    and self.params.num_pw <= MAX_PW)

    def prepare(self):
        """Boundary vectors and the sink positions the fill needs."""
        (self.bcol_I, self.bcol_M, self.brow_D, self.brow_M, self.bdiag,
         self.bdiag_k1) = _boundaries(self.t1, self.t2, self.params)
        self.sink_pos1 = _first_occurrences(self.t1.pos[
            np.asarray(self.sinks1, dtype=_I64)])
        self.sink_pos2 = _first_occurrences(self.t2.pos[
            np.asarray(self.sinks2, dtype=_I64)])

    @property
    def cells(self) -> int:
        return self.t1.V * self.t2.V

    @property
    def ring(self) -> int:
        """Diagonals a fill keeps: the longest span on either side + 1."""
        return max(self.t1.S, self.t2.S, 1) + 1


def _assemble_result(job: _DagJob, rows: np.ndarray):
    """(alignment (L, 2) int64 in node ids, score) from one job's
    traceback rows, or None when it has no interior alignment."""
    count, exit_kind = int(rows[0, 0]), int(rows[0, 1])
    exit_r1, exit_r2 = int(rows[1, 0]), int(rows[1, 1])
    score = int(rows[2, 0])
    if exit_kind == _EXIT_NO_ALIGNMENT:
        return None
    if exit_kind == _EXIT_LOST:
        raise RuntimeError("DAG traceback found no exit within V1 + V2 "
                           "steps")
    t1, t2, params = job.t1, job.t2, job.params
    lead = []
    if exit_kind == _EXIT_ROW:
        lead = _finish_boundary_row(t2, params, job.brow_D, job.brow_M,
                                    exit_r2)
        lead.reverse()
    elif exit_kind == _EXIT_COL:
        lead = _finish_boundary_col(t1, params, job.bcol_I, job.bcol_M,
                                    exit_r1)
        lead.reverse()
    pairs = np.concatenate([np.array(lead, dtype=_I64).reshape(-1, 2),
                            rows[len(rows) - count:].astype(_I64)])
    out = np.full_like(pairs, GAP)
    m1, m2 = pairs[:, 0] != GAP, pairs[:, 1] != GAP
    out[m1, 0] = t1.order[pairs[m1, 0]]
    out[m2, 1] = t2.order[pairs[m2, 1]]
    return out, score


# ---------------------------------------------------------------------------
# plain versions of the kernels


def diag_offset(V1, V2, d):
    """In-matrix cells on the diagonals before d (numpy or torch int64):
    the offset of diagonal d in a job's backpointers."""
    full = d * (d + 1) // 2
    past = V1 * (V1 + 1) // 2 + (d - V1) * V1
    a = full * (d <= V1) + past * (d > V1)
    t = (d - V2) * (d > V2)
    return a - t * (t + 1) // 2


def cell_index(V1, V2, r1, r2):
    """Index of in-matrix cell (r1, r2) in a job's backpointers."""
    d = r1 + r2
    lo = (d - V2 + 1) * (d - V2 + 1 > 0)
    return diag_offset(V1, V2, d) + r1 - lo


def job_fields(table: torch.Tensor) -> np.ndarray:
    """The table as host int64, with the int64 offsets joined into the
    low-word columns (COL_BP_LO, COL_SCRATCH_LO)."""
    t = table.cpu().numpy().astype(_I64)
    for lo in (COL_BP_LO, COL_SCRATCH_LO):
        t[:, lo] = (t[:, lo] & 0xFFFFFFFF) | (t[:, lo + 1] << 32)
    return t


def launch_sizes(table_np: np.ndarray):
    """(bp entries, sink-M entries, traceback cap) of one launch."""
    if not len(table_np):
        return 0, 0, 0
    t = table_np
    return (int((t[:, COL_BP_LO] + t[:, COL_V1] * t[:, COL_V2]).max()),
            int((t[:, COL_SINKM] + t[:, COL_N1] * t[:, COL_N2]).max()),
            int((t[:, COL_V1] + t[:, COL_V2]).max()))


def popoa_dag_fill_plain(table: torch.Tensor, data: torch.Tensor):
    """Fill every job of `table` on the tensors' device: the diagonal loop
    of centrolign_tpu/ops/popoa_dag.py::_fill_scan over a batch of jobs
    (rows), lanes r1. Returns (bp int32 flat, sink M int32 flat), the
    layouts of csrc/popoa_dag.cu's fill."""
    dev = table.device
    t = job_fields(table)
    n = len(t)
    bp_size, sinkm_size, _ = launch_sizes(t)
    i32 = torch.int32
    bp = torch.zeros(bp_size, dtype=i32, device=dev)
    sinkm = torch.full((sinkm_size,), MININF, dtype=i32, device=dev)
    if n == 0:
        return bp, sinkm
    V1, V2 = t[:, COL_V1], t[:, COL_V2]
    K1, K2, npw = t[:, COL_K1], t[:, COL_K2], t[:, COL_NPW]
    W, V2m = int(V1.max()), int(V2.max())
    Km1, Km2, R = int(K1.max()), int(K2.max()), int(t[:, COL_R].max())
    d_np = data.cpu().numpy()

    def block(off, base_rows, K, V, width):
        """Each job's rows of one graph block, zero-padded to `width`."""
        out = np.zeros((n, base_rows + int(K.max()), width), _I32)
        for b in range(n):
            nr = base_rows + K[b]
            out[b, :nr, :V[b]] = d_np[off[b]:off[b] + nr * V[b]].reshape(
                nr, V[b])
        return out

    # lanes past a job's V1 (and rows past its K) stay 0: they are out of
    # the matrix, and every value read there is masked
    g1 = block(t[:, COL_G1], G1_DELTA, K1, V1, W)
    g2 = block(t[:, COL_G2], G2_DELTA, K2, V2, V2m)

    def tt(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    def col(x):
        return tt(np.asarray(x))[:, None]

    G1, G2 = tt(g1), tt(g2)
    lab1, src1 = G1[:, G1_LAB], G1[:, G1_SRC] == 1
    bcolM, bdiag, bdiagk1 = G1[:, G1_BCOLM], G1[:, G1_BDIAG], G1[:, G1_BDIAGK1]
    sink1 = G1[:, G1_SINK]
    delta1 = [G1[:, G1_DELTA + k] for k in range(Km1)]
    V1c, V2c = col(V1), col(V2)
    K1c, K2c, npwc = col(K1).to(i32), col(K2).to(i32), col(npw)
    match, mismatch = col(t[:, COL_MATCH]).to(i32), col(t[:, COL_MISMATCH]).to(i32)
    go = [col(t[:, COL_GO + p]).to(i32) for p in range(MAX_PW)]
    ge = [col(t[:, COL_GE + p]).to(i32) for p in range(MAX_PW)]
    n2c = col(t[:, COL_N2])
    bpoff, smoff = col(t[:, COL_BP_LO]), col(t[:, COL_SINKM])

    neg = torch.tensor(MININF, dtype=i32, device=dev)
    negh = MININF // 2
    zero = torch.zeros((), dtype=i32, device=dev)
    lane = torch.arange(W, device=dev)[None, :]
    rows = torch.arange(n, device=dev)[:, None]
    Mring = torch.full((R, n, W), MININF, dtype=i32, device=dev)
    PMring = Mring.clone()
    PMk1ring = torch.zeros_like(Mring)
    Iring = [Mring.clone() for _ in range(MAX_PW)]
    Dring = [Mring.clone() for _ in range(MAX_PW)]

    def lagged(ring, d, delta, shift_lane):
        """ring value at diagonal d - delta, lane - delta (shift_lane) or
        lane, where delta > 0; delta == 0 reads a slot the caller masks."""
        src = lane - delta if shift_lane else lane.expand_as(delta)
        return ring[(d - delta) % R, rows, src.clamp(min=0)]

    for d in range(int((V1 + V2 - 1).max())):
        r2 = d - lane
        in_mat = (lane < V1c) & (r2 >= 0) & (r2 < V2c)
        r2c = r2.clamp(0, V2m - 1).expand(n, W)

        def g2row(r):
            return G2[:, r].gather(1, r2c)

        lab2, src2 = g2row(G2_LAB), g2row(G2_SRC) == 1
        browM, sink2 = g2row(G2_BROWM), g2row(G2_SINK)
        delta2 = [g2row(G2_DELTA + k) for k in range(Km2)]
        score = torch.where(lab1 == lab2, match, -mismatch)

        # PM: column max over prev1 (+ boundary row), last-wins argmax
        M1 = [torch.where(delta1[k] > 0, lagged(Mring, d, delta1[k], True),
                          neg) for k in range(Km1)]
        PM = torch.full((n, W), MININF, dtype=i32, device=dev)
        PMk1 = torch.zeros((n, W), dtype=i32, device=dev)
        for k in range(Km1):
            upd = (delta1[k] > 0) & (M1[k] >= PM)
            PM = torch.where(upd, M1[k], PM)
            PMk1 = torch.where(upd, k, PMk1)
        bm = torch.where(src1, browM, neg)
        upd = src1 & (bm >= PM)
        PM = torch.where(upd, bm, PM)
        PMk1 = torch.where(upd, K1c, PMk1)

        # diagonal: Q over prev2 columns of PM (+ the boundary column for
        # source2 lanes); the source-pair corner joins only strictly
        colval, colk1 = [], []
        for k in range(Km2):
            has = delta2[k] > 0
            colval.append(torch.where(
                has, lagged(PMring, d, delta2[k], False), neg))
            colk1.append(torch.where(
                has, lagged(PMk1ring, d, delta2[k], False), neg))
        colval.append(torch.where(src2, bdiag, neg))
        colk1.append(bdiagk1)
        Qmax = torch.full((n, W), MININF, dtype=i32, device=dev)
        for v in colval:
            Qmax = torch.maximum(Qmax, v)
        k1star = torch.zeros((n, W), dtype=i32, device=dev)
        for v, k1 in zip(colval, colk1):
            k1star = torch.maximum(k1star, torch.where(v == Qmax, k1, zero))
        # first k2 in scan order (real ascending, boundary last)
        k2star = torch.where((colval[-1] == Qmax) & (colk1[-1] == k1star),
                             K2c, zero)
        for k in range(Km2 - 1, -1, -1):
            hit = (colval[k] == Qmax) & (colk1[k] == k1star)
            k2star = torch.where(hit, k, k2star)
        corner_wins = src1 & src2 & (0 > Qmax)
        Qeff = torch.where(corner_wins, zero, Qmax)
        k1star = torch.where(corner_wins, K1c, k1star)
        k2star = torch.where(corner_wins, K2c, k2star)
        Mdiag = torch.where(Qeff > negh, Qeff + score, neg)

        M2 = [torch.where(delta2[k] > 0, lagged(Mring, d, delta2[k], False),
                          neg) for k in range(Km2)]

        def gap(Mlag, ring, delta, Kc, bopen, shift_lane, pw):
            """New value and choice digit of one I or D piece."""
            gpen = go[pw] + ge[pw]
            opens, exts = [], []
            for k in range(len(delta)):
                has = delta[k] > 0
                opens.append(torch.where(has, Mlag[k] - gpen, neg))
                exts.append(torch.where(
                    has, lagged(ring, d, delta[k], shift_lane) - ge[pw], neg))
            new = bopen
            for o, e in zip(opens, exts):
                new = torch.maximum(new, torch.maximum(o, e))
            choice = torch.where(bopen == new, Kc + 5, zero)
            for k in range(len(delta) - 1, -1, -1):
                mine = k < Kc
                choice = torch.where(mine & (exts[k] == new), k, choice)
                choice = torch.where(mine & (opens[k] == new), k + 5, choice)
            return new, choice

        Mnew = Mdiag
        Inew, Dnew, ipack, dpack = [], [], zero, zero
        for pw in range(MAX_PW):
            live = pw < npwc
            gpen = go[pw] + ge[pw]
            iv, ic = gap(M1, Iring[pw], delta1, K1c,
                         torch.where(src1, browM - gpen, neg), True, pw)
            dv, dc = gap(M2, Dring[pw], delta2, K2c,
                         torch.where(src2 & (bcolM > negh), bcolM - gpen,
                                     neg), False, pw)
            Mnew = torch.where(live, torch.maximum(
                Mnew, torch.maximum(iv, dv)), Mnew)
            Inew.append(iv)
            Dnew.append(dv)
            ipack = ipack + torch.where(live, ic, zero) * 10 ** pw
            dpack = dpack + torch.where(live, dc, zero) * 10 ** pw
        code = torch.zeros((n, W), dtype=i32, device=dev)
        for pw in range(MAX_PW - 1, -1, -1):
            live = pw < npwc
            code = torch.where(live & (Dnew[pw] == Mnew), 2 * pw + 2, code)
            code = torch.where(live & (Inew[pw] == Mnew), 2 * pw + 1, code)
        packed = (code + 7 * (k1star + 5 * k2star) + (ipack << 8)
                  + (dpack << 18))

        slot = d % R
        Mring[slot] = torch.where(in_mat, Mnew, neg)
        PMring[slot] = torch.where(in_mat, PM, neg)
        PMk1ring[slot] = PMk1
        for pw in range(MAX_PW):
            Iring[pw][slot] = torch.where(in_mat, Inew[pw], neg)
            Dring[pw][slot] = torch.where(in_mat, Dnew[pw], neg)

        idx = bpoff + cell_index(V1c, V2c, lane, r2)
        bp[idx[in_mat]] = packed[in_mat]
        at_sink = in_mat & (sink1 >= 0) & (sink2 >= 0)
        sidx = smoff + sink1 * n2c + sink2
        sinkm[sidx[at_sink]] = Mnew[at_sink]
    return bp, sinkm


def _walk(bp, off, V1, V2, K1, K2, delta1, delta2, r1, r2):
    """Walk one job's packed backpointers from (r1, r2) in M state, as
    centrolign_tpu/ops/popoa_dag.py::_traceback_scan does. Returns
    (pairs in backward order, exit kind, exit r1, exit r2)."""
    pairs = []
    comp = 0
    for _ in range(V1 + V2):
        v = int(bp[off + cell_index(V1, V2, r1, r2)])
        diagcode, ipack, dpack = v & 255, (v >> 8) & 1023, (v >> 18) & 1023
        code = diagcode % 7
        k1, k2 = (diagcode // 7) % 5, (diagcode // 7) // 5
        c = code if comp == 0 else comp
        if c == 0:
            pairs.append((r1, r2))
            b1, b2 = k1 >= K1, k2 >= K2
            if b1 and b2:
                return pairs, _EXIT_CORNER, r1, r2
            if not b2:
                r2 -= int(delta2[k2, r2])
            if b1:
                return pairs, _EXIT_ROW, r1, r2
            r1 -= int(delta1[k1, r1])
            if b2:
                return pairs, _EXIT_COL, r1, r2
            comp = 0
        elif c % 2 == 1:
            dig = (ipack // 10 ** ((c - 1) // 2)) % 10
            pairs.append((r1, GAP))
            if dig % 5 >= K1:
                return pairs, _EXIT_ROW, r1, r2
            r1 -= int(delta1[dig % 5, r1])
            comp = 0 if dig // 5 == 1 else c
        else:
            dig = (dpack // 10 ** (c // 2 - 1)) % 10
            pairs.append((GAP, r2))
            if dig % 5 >= K2:
                return pairs, _EXIT_COL, r1, r2
            r2 -= int(delta2[dig % 5, r2])
            comp = 0 if dig // 5 == 1 else c
    return pairs, _EXIT_LOST, r1, r2


def popoa_dag_traceback_plain(bp: torch.Tensor, sinkm: torch.Tensor,
                              table: torch.Tensor, data: torch.Tensor,
                              cap: int) -> torch.Tensor:
    """Host walk of every job into the (n, cap + 3, 2) int32 rows of
    csrc/popoa_dag.cu's traceback (layout in the module docstring)."""
    t = job_fields(table)
    bp_np = bp.cpu().numpy()
    sm = sinkm.cpu().numpy()
    d_np = data.cpu().numpy()
    out = np.zeros((len(t), cap + HEADER_ROWS, 2), np.int32)
    for b in range(len(t)):
        V1, V2, K1, K2 = (int(x) for x in t[b, [COL_V1, COL_V2, COL_K1,
                                                COL_K2]])
        if V1 + V2 > cap:
            raise ValueError(f"cap {cap} is shorter than a job's V1 + V2")
        n1, n2 = int(t[b, COL_N1]), int(t[b, COL_N2])
        vals = sm[t[b, COL_SINKM]:t[b, COL_SINKM] + n1 * n2]
        best = int(np.argmax(vals))
        out[b, 2] = (vals[best], best)
        if vals[best] <= _NEG_HALF:
            out[b, 0] = (0, _EXIT_NO_ALIGNMENT)
            continue
        g1, g2 = int(t[b, COL_G1]), int(t[b, COL_G2])
        delta1 = d_np[g1 + G1_DELTA * V1:g1 + (G1_DELTA + K1) * V1
                      ].reshape(K1, V1)
        delta2 = d_np[g2 + G2_DELTA * V2:g2 + (G2_DELTA + K2) * V2
                      ].reshape(K2, V2)
        sp = int(t[b, COL_SINKPOS])
        r1, r2 = int(d_np[sp + best // n2]), int(d_np[sp + n1 + best % n2])
        pairs, kind, e1, e2 = _walk(bp_np, int(t[b, COL_BP_LO]), V1, V2,
                                    K1, K2, delta1, delta2, r1, r2)
        out[b, 0] = (len(pairs), kind)
        out[b, 1] = (e1, e2)
        if pairs:
            out[b, len(out[b]) - len(pairs):] = pairs[::-1]
    return torch.from_numpy(out).to(bp.device)


# ---------------------------------------------------------------------------
# entries


def popoa_dag_batch(jobs, device: torch.device):
    """jobs: list of _DagJob (all eligible, prepared). One fill and one
    traceback launch on `device` (the plain versions on the CPU). Returns
    per job (alignment, score) equal to ops.popoa_ref.popoa, or None when
    the job has no interior alignment."""
    from .popoa_dag_cuda import popoa_dag_align_jobs
    rows = popoa_dag_align_jobs(jobs, device)
    return [_assemble_result(job, r) for job, r in zip(jobs, rows)]


def popoa_dag_device(graph1, graph2, sources1, sources2, sinks1, sinks2,
                     params: AlignmentParams, device: torch.device):
    """Device PO-POA for one DAG x DAG gap. Returns (alignment, score)
    exactly equal to ops.popoa_ref.popoa, or None when the graphs are
    outside the envelope or the job has no interior alignment."""
    job = _DagJob(graph1, graph2, sources1, sources2, sinks1, sinks2, params)
    if not job.eligible:
        return None
    job.prepare()
    return popoa_dag_batch([job], device)[0]

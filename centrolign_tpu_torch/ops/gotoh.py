"""Plain PyTorch versions of the chain-gap Gotoh fill and traceback (twin of
centrolign_tpu/ops/gotoh.py).

The fill is the skewed anti-diagonal recurrence of
centrolign_tpu/ops/gotoh.py::_diag_math written as a loop over diagonals,
each step one set of tensor operations over a batch of problems (rows) and
their lanes. Cells are int32 {M, I[pw], D[pw]}; MININF = -2^30.

Backpointer encoding (uint16), as in the JAX package:
- bits 0..2: M source: 0=diagonal, 1=I[0], 2=D[0], 3=I[1], 4=D[1], 5=I[2], 6=D[2]
- bit 3+pw:  I[pw] opened from M (else extended)
- bit 6+pw:  D[pw] opened from M (else extended)
The M source is the first of I0, D0, I1, D1, ... equal to M (D before I
for an operand-swapped problem), else the diagonal; a gap that ties
between opening and extending is marked opened.

Problems arrive as a parameter table (one int32 row of 16 columns per job,
built by ops/gotoh_cuda.py::params_table) and one int32 buffer holding
each job's seq1 followed by its seq2. A job's backpointers occupy
(V1 + V2 + 1) x W entries of one flat buffer at its own offset, laid out
[d][lane], W = short side + 1; lanes index i when V1 <= V2, else j.
Entries outside the matrix are 0.

These are the references the CUDA kernels (csrc/gotoh.cu) are held
against, and what the device tier runs when its device is the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..alignment import GAP
from .align_params import MININF, AlignmentParams

# parameter table columns (0-3 and the go/ge run as in gotoh_pallas.py:753)
COL_V1, COL_V2, COL_MATCH, COL_MISMATCH, COL_GAPS = 0, 1, 2, 3, 4
COL_LANE_IS_I, COL_SWAP, COL_NPW, COL_SEQ_OFF = 10, 11, 12, 13
COL_BP_LO, COL_BP_HI = 14, 15
N_COLS = 16
MAX_PW = 3


def _build_skew_inputs(seq1, seq2, lane_is_i: bool, W: int, b_cap: int):
    """Host-side padded lane vectors for the score gather. b_cap bounds the
    reversed-side length so array shapes depend only on the bucket."""
    V1, V2 = len(seq1), len(seq2)
    if lane_is_i:
        # lane k holds i = k; score needs seq1[i-1] and seq2[j-1] = seq2[d-i-1]
        a = np.full(W, -1, dtype=np.int32)
        a[1:V1 + 1] = seq1
        b_src, b_len = seq2, V2
    else:
        a = np.full(W, -1, dtype=np.int32)
        a[1:V2 + 1] = seq2
        b_src, b_len = seq1, V1
    # reversed, padded both sides so every slice offset is valid
    b = np.full(2 * W + b_cap, -2, dtype=np.int32)
    b[W:W + b_len] = b_src[::-1]
    return a, b


def _job_fields(table: torch.Tensor):
    """Host numpy views of the table: (rows int64, V1, V2, lane_is_i, W,
    bp offset)."""
    t = table.cpu().numpy().astype(np.int64)
    V1, V2 = t[:, COL_V1], t[:, COL_V2]
    lane_is_i = t[:, COL_LANE_IS_I] != 0
    W = np.where(lane_is_i, V1, V2) + 1
    bp_off = (t[:, COL_BP_LO] & 0xFFFFFFFF) | (t[:, COL_BP_HI] << 32)
    return t, V1, V2, lane_is_i, W, bp_off


def _shift(x: torch.Tensor) -> torch.Tensor:
    """out[..., k] = x[..., k-1]; out[..., 0] = MININF."""
    return torch.cat([torch.full_like(x[..., :1], MININF), x[..., :-1]], -1)


def gotoh_fill_plain(table: torch.Tensor, seqs: torch.Tensor):
    """Fill every job of `table` on the tensors' device. Returns (bp flat
    uint16, score int32 (n,)), the layouts of csrc/gotoh.cu's fill."""
    dev = table.device
    t, V1, V2, lane_is_i, W, bp_off = _job_fields(table)
    n = len(t)
    if n == 0:
        return (torch.zeros(0, dtype=torch.int16, device=dev).view(torch.uint16),
                torch.zeros(0, dtype=torch.int32, device=dev))
    last = V1 + V2
    bp_size = int((bp_off + (last + 1) * W).max())
    Wm, Dm = int(W.max()), int(last.max()) + 1
    seqs_np = seqs.cpu().numpy()
    a = np.empty((n, Wm), np.int32)
    b = np.empty((n, 2 * Wm + Dm), np.int32)
    for r in range(n):
        s1 = seqs_np[t[r, COL_SEQ_OFF]:t[r, COL_SEQ_OFF] + V1[r]]
        s2 = seqs_np[t[r, COL_SEQ_OFF] + V1[r]:t[r, COL_SEQ_OFF] + last[r]]
        a[r], b[r] = _build_skew_inputs(s1, s2, bool(lane_is_i[r]), Wm, Dm)

    def col(x):
        return torch.as_tensor(np.asarray(x), device=dev)[:, None]

    npw = t[:, COL_NPW]
    pw = np.arange(MAX_PW)
    go = np.zeros((n, MAX_PW), np.int64)
    ge = np.zeros((n, MAX_PW), np.int64)
    for r in range(n):
        go[r, :npw[r]] = t[r, COL_GAPS:COL_GAPS + npw[r]]
        ge[r, :npw[r]] = t[r, COL_GAPS + npw[r]:COL_GAPS + 2 * npw[r]]
    i32 = torch.int32
    go = torch.as_tensor(go, dtype=i32, device=dev)[:, :, None]
    ge = torch.as_tensor(ge, dtype=i32, device=dev)[:, :, None]
    go_ge = go + ge
    pw_ok = torch.as_tensor(pw[None, :] < npw[:, None], device=dev)[:, :, None]
    swap = col(t[:, COL_SWAP] != 0)
    # the first and second checked component of each pair, per row
    first_code = [torch.where(swap, 2 + 2 * p, 1 + 2 * p).to(i32)
                  for p in range(MAX_PW)]
    second_code = [torch.where(swap, 1 + 2 * p, 2 + 2 * p).to(i32)
                   for p in range(MAX_PW)]

    lii = col(lane_is_i)
    V1t, V2t = col(V1).to(i32), col(V2).to(i32)
    other = col(np.where(lane_is_i, V2, V1))
    Lt = col(W - 1)
    match = col(t[:, COL_MATCH]).to(i32)
    mismatch = col(t[:, COL_MISMATCH]).to(i32)
    a_t = torch.as_tensor(a, device=dev)
    b_t = torch.as_tensor(b, device=dev)
    lane = torch.arange(Wm, device=dev)[None, :]
    # flat target of each (row, lane) on diagonal 0; invalid -> dump slot
    W_t = col(W)
    base = col(bp_off) + lane
    lane_ok = lane < W_t
    dump = bp_size

    neg = torch.tensor(MININF, dtype=i32, device=dev)
    M1 = torch.full((n, Wm), MININF, dtype=i32, device=dev)
    M2 = M1.clone()
    I1 = torch.full((n, MAX_PW, Wm), MININF, dtype=i32, device=dev)
    D1 = I1.clone()
    bp = torch.zeros(bp_size + 1, dtype=i32, device=dev)
    score = torch.zeros(n, dtype=i32, device=dev)
    last_t = col(last)
    for d in range(Dm):
        i = torch.where(lii, lane, d - lane)
        j = torch.where(lii, d - lane, lane)
        idx = (Wm + other - d + lane).clamp_(0, b_t.shape[1] - 1)
        bvec = torch.gather(b_t, 1, idx)
        sc = torch.where(a_t == bvec, match, -mismatch)
        in_m = (i >= 0) & (i <= V1t) & (j >= 0) & (j <= V2t)
        i_pos, j_pos = i >= 1, j >= 1
        corner = (i == 0) & (j == 0)

        M_up = torch.where(lii, _shift(M1), M1)
        M_left = torch.where(lii, M1, _shift(M1))
        Mnew = torch.where(in_m & i_pos & j_pos, _shift(M2) + sc, neg)
        I_up = torch.where(lii[:, :, None], _shift(I1), I1)
        D_left = torch.where(lii[:, :, None], D1, _shift(D1))
        i_open = M_up[:, None, :] - go_ge
        Inew = torch.maximum(i_open, I_up - ge)
        Inew = torch.where((in_m & i_pos)[:, None, :] & pw_ok, Inew, neg)
        d_open = M_left[:, None, :] - go_ge
        Dnew = torch.maximum(d_open, D_left - ge)
        Dnew = torch.where((in_m & j_pos)[:, None, :] & pw_ok, Dnew, neg)
        Mnew = torch.maximum(Mnew, torch.maximum(Inew.amax(1), Dnew.amax(1)))
        Mnew = torch.where(corner, torch.zeros_like(Mnew), Mnew)
        Mnew = torch.where(in_m, Mnew, neg)

        bits = torch.zeros_like(Mnew)
        code = torch.zeros_like(Mnew)
        for p in reversed(range(MAX_PW)):
            bits |= ((Inew[:, p] == i_open[:, p]) & (Inew[:, p] > neg)).to(i32) << (3 + p)
            bits |= ((Dnew[:, p] == d_open[:, p]) & (Dnew[:, p] > neg)).to(i32) << (6 + p)
            first = torch.where(swap, Dnew[:, p], Inew[:, p])
            second = torch.where(swap, Inew[:, p], Dnew[:, p])
            code = torch.where(second == Mnew, second_code[p], code)
            code = torch.where(first == Mnew, first_code[p], code)
        code = torch.where(corner, torch.zeros_like(code), code)
        row = torch.where(in_m, bits | code, torch.zeros_like(code))

        tgt = torch.where(lane_ok & (d <= last_t), base + d * W_t, dump)
        bp.scatter_(0, tgt.reshape(-1), row.reshape(-1))
        at_end = (last_t[:, 0] == d)
        score = torch.where(at_end, Mnew.gather(1, Lt)[:, 0], score)
        M2, M1, I1, D1 = M1, Mnew, Inew, Dnew
    return bp[:bp_size].to(torch.int16).view(torch.uint16), score


def _traceback_bp(bp: np.ndarray, V1: int, V2: int, lane_is_i: bool, npw: int):
    """Walk packed backpointers from (V1, V2) to (0, 0) (host)."""
    i, j = V1, V2
    comp = 0
    pairs = []
    while i != 0 or j != 0:
        d = i + j
        lane = i if lane_is_i else j
        b = int(bp[d, lane])
        if comp == 0:
            code = b & 0b111
            if code == 0:
                pairs.append((i - 1, j - 1))
                i -= 1
                j -= 1
                continue
            comp = (code + 1) // 2 if code % 2 == 1 else -(code // 2)
        if comp > 0:
            pw = comp - 1
            pairs.append((i - 1, GAP))
            if (b >> (3 + pw)) & 1:
                comp = 0
            i -= 1
        else:
            pw = -comp - 1
            pairs.append((GAP, j - 1))
            if (b >> (6 + pw)) & 1:
                comp = 0
            j -= 1
    pairs.reverse()
    return np.array(pairs, dtype=np.int64).reshape(-1, 2)


def _job_bp(bp_np: np.ndarray, off: int, V1: int, V2: int, W: int):
    return bp_np[off:off + (V1 + V2 + 1) * W].reshape(V1 + V2 + 1, W)


def gotoh_traceback_plain(bp: torch.Tensor, score: torch.Tensor,
                          table: torch.Tensor, cap: int) -> torch.Tensor:
    """Host walk of every job's backpointers into the (n, cap+1, 2) int32
    rows of csrc/gotoh.cu's traceback: row 0 = (count, score), the pairs
    end at row cap, GAP = -1, rows in between 0."""
    t, V1, V2, lane_is_i, W, bp_off = _job_fields(table)
    if len(t) and int((V1 + V2).max()) > cap:
        raise ValueError(f"cap {cap} is shorter than a job's V1 + V2")
    bp_np = bp.view(torch.int16).cpu().numpy()
    sc = score.cpu().numpy()
    rows = np.zeros((len(t), cap + 1, 2), np.int32)
    for r in range(len(t)):
        aln = _traceback_bp(_job_bp(bp_np, bp_off[r], V1[r], V2[r], W[r]),
                            int(V1[r]), int(V2[r]), bool(lane_is_i[r]),
                            int(t[r, COL_NPW]))
        rows[r, 0] = (len(aln), sc[r])
        rows[r, cap + 1 - len(aln):] = aln
    return torch.from_numpy(rows).to(bp.device)


def gotoh_align(seq1: np.ndarray, seq2: np.ndarray, params: AlignmentParams,
                swap_pref: bool = False):
    """Global piecewise-affine alignment of two encoded sequences on the
    CPU. Returns (alignment (L,2) int64 with GAP=-1, score int), identical
    to centrolign_tpu.ops.gotoh.gotoh_align."""
    from .gotoh_cuda import pack_seqs, params_table

    job = (np.asarray(seq1, np.int32), np.asarray(seq2, np.int32),
           swap_pref, params)
    table = params_table([job])
    bp, score = gotoh_fill_plain(table, pack_seqs([job]))
    V1, V2 = len(job[0]), len(job[1])
    lane_is_i = V1 <= V2
    W = (V1 if lane_is_i else V2) + 1
    bp_np = _job_bp(bp.view(torch.int16).numpy(), 0, V1, V2, W)
    aln = _traceback_bp(bp_np, V1, V2, lane_is_i, params.num_pw)
    return aln, int(score[0])

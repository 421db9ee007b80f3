"""The lane-sharded Gotoh fill, one shard's chunk of diagonals: layouts and
the plain PyTorch version of csrc/sharded_gotoh.cu (twin of the step of
centrolign_tpu/parallel/sharded_gotoh.py::_make_step).

The fill is the int32 piecewise-affine Gotoh of ops/gotoh.py on the skewed
anti-diagonal state (M of the diagonal, M of the one before, I and D per
gap piece), with the lanes (positions on the short side) cut into blocks of
Wl, one per shard. Each diagonal, lane k reads lanes k and k - 1 of the
diagonal before and lane k - 1 of the one before that, so a shard needs its
left neighbour's last lane once a diagonal.

A shard fills a CHUNK of up to H diagonals per call. Its lanes are cut into
`blocks` blocks (`block_starts`, each of at least H lanes), and each block
works on H + its own lanes ("extended" lanes): at the chunk's start the H
lanes left of it hold their values after the previous chunk, from the block
before it or, left of the shard, from the halo its left neighbour
published (MININF for shard 0 and before the first chunk). Every diagonal
of the chunk is computed over all extended lanes, the leftmost from
MININF: after h + 1 diagonals lanes 0..h of the extension are wrong, so
after at most H diagonals every own lane is exact (the DP is integer). The
shard then publishes its own last H lanes for its right neighbour's next
chunk. So one chunk is one launch and one halo of H lanes, not H of each,
and the result does not depend on the cut.

Per problem, the layouts are:
- `state` (2, Bl, Q, Wl) int32: the own lanes after a chunk, in the buffer
  of the chunk's parity (chunk c = d0 // H reads buffer (c + 1) % 2 and
  writes buffer c % 2, so no block reads what another block of the same
  chunk writes). Q = 2 + 2 * MAX_PW planes: M of the chunk's last
  diagonal, M of the one before, then I of each piece and D of each piece
  on the last diagonal.
- a halo (Bl, Q, H) int32: the same planes for the shard's last H lanes.
- backpointers (num_diags, Bl, Wl) uint16 per shard, the code order and
  open bits of the JAX step (swap_pref included), for every lane: outside
  the matrix the code is that of the first gap component, as there.
- the score (Bl,) int32: M of the opt cell (V1, V2) when it is an own lane
  of this shard, else left as it was (MININF).
"""

from __future__ import annotations

import torch

from .align_params import MININF

MAX_PW = 3
HALO_Q = 2 + 2 * MAX_PW


def block_starts(Wl: int, blocks: int) -> list:
    """The first lane of each of the `blocks` blocks of a shard's Wl
    lanes, and Wl: block b owns lanes [starts[b], starts[b + 1])."""
    return [b * Wl // blocks for b in range(blocks + 1)]


def block_count(Wl: int, H: int, block_lanes: int) -> int:
    """Blocks of at most `block_lanes` lanes, fewer where a block would own
    fewer than H lanes: each owns at least H, and at most max(block_lanes,
    2 H - 1)."""
    n = max(1, -(-Wl // block_lanes))
    while n > 1 and Wl // n < H:
        n -= 1
    return n


def chunk_fill_plain(a, b, V1, V2, params, state, halo_in, halo_out, bp,
                     score, *, L0: int, Wl: int, H: int, d0: int, nd: int,
                     lane_is_i: bool, swap_pref: bool, blocks: int = 1):
    """One shard's chunk: diagonals d0 .. d0 + nd - 1 over its Bl problems,
    in place on `state`, `halo_out` (Bl, Q, H) or None, `bp` or None and
    `score`. a (Bl, W_total), b (Bl, Lb) int32 full rows; V1, V2 (Bl,)
    int32; `halo_in` (Bl, Q, H) or None for MININF; the shard's own lanes
    start at global lane L0 and are cut into `blocks` blocks."""
    dev = state.device
    i32 = torch.int32
    Bl = a.shape[0]
    npw = params.num_pw
    W_total, Lb = a.shape[1], b.shape[1]
    neg = torch.tensor(MININF, dtype=i32, device=dev)
    go = [int(params.gap_open[k]) for k in range(npw)]
    ge = [int(params.gap_extend[k]) for k in range(npw)]
    v1, v2 = V1.to(i32)[:, None, None], V2.to(i32)[:, None, None]
    other = v2 if lane_is_i else v1

    # x: the shard lane of each block's extended lanes, (blocks, E); the
    # widest block sets E, the others run past their own lanes
    starts = block_starts(Wl, blocks)
    lo = torch.tensor(starts[:-1], dtype=i32, device=dev)[:, None]
    hi = torch.tensor(starts[1:], dtype=i32, device=dev)[:, None]
    wmax = max(starts[k + 1] - starts[k] for k in range(blocks))
    E = H + wmax
    x = lo - H + torch.arange(E, dtype=i32, device=dev)[None, :]
    own = (x >= lo) & (x < hi)
    lane = L0 + x

    # the chunk's start: the halo left of the shard, the previous chunk's
    # state, MININF right of the shard
    c = d0 // H
    prev, cur = state[(c + 1) % 2], state[c % 2]
    halo = (halo_in if halo_in is not None else
            torch.full((Bl, HALO_Q, H), MININF, dtype=i32, device=dev))
    src = torch.cat([halo, prev, torch.full((Bl, HALO_Q, wmax), MININF,
                                            dtype=i32, device=dev)], 2)
    ext = src[:, :, (x + H).long()]  # (Bl, Q, blocks, E)
    M1, M2 = ext[:, 0], ext[:, 1]
    I1 = [ext[:, 2 + k] for k in range(npw)]
    D1 = [ext[:, 2 + MAX_PW + k] for k in range(npw)]

    def shift(t):
        return torch.cat([torch.full_like(t[..., :1], MININF), t[..., :-1]],
                         -1)

    a_ix = lane.clamp(0, W_total - 1).long().flatten()
    a_lab = a[:, a_ix].view(Bl, blocks, E)
    opt_lane = v1 if lane_is_i else v2
    for d in range(d0, d0 + nd):
        ml, m2l = shift(M1), shift(M2)
        M_up, M_left = (ml, M1) if lane_is_i else (M1, ml)
        i = lane if lane_is_i else d - lane
        j = d - lane if lane_is_i else lane
        in_m = (i >= 0) & (i <= v1) & (j >= 0) & (j <= v2)
        i_pos, j_pos = i >= 1, j >= 1
        corner = (i == 0) & (j == 0)
        diag = in_m & i_pos & j_pos
        b_ix = (W_total + other - d + lane).clamp(0, Lb - 1)
        b_lab = torch.gather(b, 1, b_ix.long().view(Bl, -1)).view(Bl, blocks,
                                                                   E)
        sc = torch.where(a_lab == b_lab, int(params.match),
                         -int(params.mismatch)).to(i32)
        Mnew = torch.where(diag, m2l + sc, neg)
        Iv, Dv, i_opens, d_opens = [], [], [], []
        for k in range(npw):
            I_up, D_left = ((shift(I1[k]), D1[k]) if lane_is_i
                            else (I1[k], shift(D1[k])))
            i_open = M_up - (go[k] + ge[k])
            d_open = M_left - (go[k] + ge[k])
            iv = torch.where(in_m & i_pos,
                             torch.maximum(i_open, I_up - ge[k]), neg)
            dv = torch.where(in_m & j_pos,
                             torch.maximum(d_open, D_left - ge[k]), neg)
            Mnew = torch.maximum(Mnew, torch.maximum(iv, dv))
            Iv.append(iv)
            Dv.append(dv)
            i_opens.append(i_open)
            d_opens.append(d_open)
        Mnew = torch.where(corner, torch.zeros_like(Mnew), Mnew)
        Mnew = torch.where(in_m, Mnew, neg)

        if bp is not None:
            order = []
            for k in range(npw):
                pair = [(Iv[k], 1 + 2 * k), (Dv[k], 2 + 2 * k)]
                order += pair[::-1] if swap_pref else pair
            code = torch.zeros_like(Mnew)
            for val, cd in reversed(order):
                code = torch.where(val == Mnew, cd, code)
            code = torch.where(corner, 0, code)
            for k in range(npw):
                code |= ((Iv[k] == i_opens[k]) & (Iv[k] > neg)).to(i32) << (3 + k)
                code |= ((Dv[k] == d_opens[k]) & (Dv[k] > neg)).to(i32) << (6 + k)
            # the own lanes, block after block: the shard's lanes in order
            bp[d] = code[:, own].to(torch.int16)
        hit = own & (d == v1 + v2) & (lane == opt_lane)
        got = hit.flatten(1).any(1)
        score[got] = Mnew[hit]
        M2, M1, I1, D1 = M1, Mnew, Iv, Dv

    cur[:, 0] = M1[:, own]
    cur[:, 1] = M2[:, own]
    for k in range(npw):
        cur[:, 2 + k] = I1[k][:, own]
        cur[:, 2 + MAX_PW + k] = D1[k][:, own]
    if halo_out is not None:
        halo_out.copy_(cur[:, :, Wl - H:])


def run_schedule_plain(ops, shards, params, *, Wl: int, H: int, blocks: int,
                       num_diags: int, lane_is_i: bool, swap_pref: bool,
                       chunk=None) -> None:
    """The plain version of a fill's schedule
    (parallel/sharded_gotoh.py::chunk_schedule): its ops in list order, a
    serial order, on each device's current stream; every chunk by `chunk`
    (default chunk_fill_plain), a halo copy by Tensor.copy_, the stream
    and event ops nothing. `shards` maps the schedule's keys (gap row,
    lane shard) to fill_shards' dicts of tensors."""
    chunk = chunk or chunk_fill_plain
    for op in ops:
        kind, (g, s) = op[0], op[1]
        sh = shards[(g, s)]
        if kind == "copy":
            sh["in"][op[2]].copy_(shards[(g, s - 1)]["out"][op[2]])
        elif kind == "fill":
            c = op[2]
            halo_in = None
            if s and c:
                halo_in = (sh["in"][c - 1] if "in" in sh
                           else shards[(g, s - 1)]["out"][c - 1])
            d0 = c * H
            chunk(sh["a"], sh["b"], sh["V1"], sh["V2"], params, sh["state"],
                  halo_in, None if sh["out"] is None else sh["out"][c],
                  sh["bp"], sh["score"], L0=s * Wl, Wl=Wl, H=H, d0=d0,
                  nd=min(H, num_diags - d0), lane_is_i=lane_is_i,
                  swap_pref=swap_pref, blocks=blocks)

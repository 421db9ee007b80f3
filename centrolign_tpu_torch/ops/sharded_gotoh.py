"""The lane-sharded Gotoh fill, one shard's chunk of diagonals: layouts and
the plain PyTorch version of csrc/sharded_gotoh.cu (twin of the step of
centrolign_tpu/parallel/sharded_gotoh.py::_make_step).

The fill is the int32 piecewise-affine Gotoh of ops/gotoh.py on the skewed
anti-diagonal state (M of the diagonal, M of the one before, I and D per
gap piece), with the lanes (positions on the short side) cut into blocks of
Wl, one per shard. Each diagonal, lane k reads lanes k and k - 1 of the
diagonal before and lane k - 1 of the one before that, so a shard needs its
left neighbour's last lane once a diagonal.

A shard fills a CHUNK of up to H diagonals per call, on H + Wl "extended"
lanes: the H lanes left of its block and its own. At the chunk's start the
extended lanes hold the left neighbour's last H lanes as the neighbour left
them after its previous chunk (the halo; MININF for shard 0 and before the
first chunk). Every diagonal of the chunk is computed over all extended
lanes, the leftmost from MININF: after h + 1 diagonals lanes 0..h of the
extension are wrong, so after at most H diagonals every own lane is exact
(the DP is integer). The shard then publishes its own last H lanes for its
right neighbour's next chunk. So one chunk is one launch and one halo of H
lanes, not H of each.

Per problem, the layouts are:
- `state` (P, E) int32, E = H + Wl extended lanes, P = 3 + 4 * MAX_PW
  planes: M of diagonal d in plane d % 3; I of piece k in plane 3 +
  (d % 2) * MAX_PW + k, D in plane 3 + 2 * MAX_PW + (d % 2) * MAX_PW + k.
  It carries the shard's own lanes from one chunk to the next.
- a halo (Q, H) int32, Q = 2 + 2 * MAX_PW: M of the chunk's last diagonal,
  M of the one before, then I and D of each piece on the last diagonal,
  for the last H own lanes.
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
PLANES = 3 + 4 * MAX_PW
HALO_Q = 2 + 2 * MAX_PW


def i_plane(buf: int, k: int) -> int:
    return 3 + buf * MAX_PW + k


def d_plane(buf: int, k: int) -> int:
    return 3 + 2 * MAX_PW + buf * MAX_PW + k


def chunk_fill_plain(a, b, V1, V2, params, state, halo_in, halo_out, bp,
                     score, *, L0: int, Wl: int, H: int, d0: int, nd: int,
                     lane_is_i: bool, swap_pref: bool):
    """One shard's chunk: diagonals d0 .. d0 + nd - 1 over its Bl problems,
    in place on `state`, `halo_out` (Bl, Q, H) or None, `bp` or None and
    `score`. a (Bl, W_total), b (Bl, Lb) int32 full rows; V1, V2 (Bl,)
    int32; `halo_in` (Bl, Q, H) or None for MININF; the shard's own lanes
    start at global lane L0."""
    dev = state.device
    i32 = torch.int32
    Bl, _, E = state.shape
    npw = params.num_pw
    W_total, Lb = a.shape[1], b.shape[1]
    neg = torch.tensor(MININF, dtype=i32, device=dev)
    go = [int(params.gap_open[k]) for k in range(npw)]
    ge = [int(params.gap_extend[k]) for k in range(npw)]
    v1, v2 = V1.to(i32)[:, None], V2.to(i32)[:, None]
    other = v2 if lane_is_i else v1
    lane = (L0 - H + torch.arange(E, device=dev, dtype=i32))[None, :]
    own = lane >= L0

    # the halo: the left neighbour's last H lanes at d0 - 1 and d0 - 2
    m1, m2, x1 = (d0 + 2) % 3, (d0 + 1) % 3, (d0 + 1) % 2
    if halo_in is None:
        state[:, :, :H] = MININF
    else:
        state[:, m1, :H] = halo_in[:, 0]
        state[:, m2, :H] = halo_in[:, 1]
        for k in range(MAX_PW):
            state[:, i_plane(x1, k), :H] = halo_in[:, 2 + k]
            state[:, d_plane(x1, k), :H] = halo_in[:, 2 + MAX_PW + k]

    def shift(x):
        return torch.cat([torch.full_like(x[:, :1], MININF), x[:, :-1]], 1)

    opt_lane = v1 if lane_is_i else v2
    for d in range(d0, d0 + nd):
        c3, p3, q3 = d % 3, (d + 2) % 3, (d + 1) % 3
        c2, p2 = d % 2, (d + 1) % 2
        M1, M2 = state[:, p3], state[:, q3]
        ml, m2l = shift(M1), shift(M2)
        M_up, M_left = (ml, M1) if lane_is_i else (M1, ml)
        i = lane if lane_is_i else d - lane
        j = d - lane if lane_is_i else lane
        in_m = (i >= 0) & (i <= v1) & (j >= 0) & (j <= v2)
        i_pos, j_pos = i >= 1, j >= 1
        corner = (i == 0) & (j == 0)
        diag = in_m & i_pos & j_pos
        a_ix = lane.clamp(0, W_total - 1).expand(Bl, E)
        b_ix = (W_total + other - d + lane).clamp(0, Lb - 1)
        sc = torch.where(torch.gather(a, 1, a_ix) == torch.gather(b, 1, b_ix),
                         int(params.match), -int(params.mismatch)).to(i32)
        Mnew = torch.where(diag, m2l + sc, neg)
        Iv, Dv, i_opens, d_opens = [], [], [], []
        for k in range(npw):
            I1, D1 = state[:, i_plane(p2, k)], state[:, d_plane(p2, k)]
            I_up, D_left = (shift(I1), D1) if lane_is_i else (I1, shift(D1))
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

        state[:, c3] = Mnew
        for k in range(npw):
            state[:, i_plane(c2, k)] = Iv[k]
            state[:, d_plane(c2, k)] = Dv[k]
        if bp is not None:
            order = []
            for k in range(npw):
                pair = [(Iv[k], 1 + 2 * k), (Dv[k], 2 + 2 * k)]
                order += pair[::-1] if swap_pref else pair
            code = torch.zeros_like(Mnew)
            for val, c in reversed(order):
                code = torch.where(val == Mnew, c, code)
            code = torch.where(corner, 0, code)
            for k in range(npw):
                code |= ((Iv[k] == i_opens[k]) & (Iv[k] > neg)).to(i32) << (3 + k)
                code |= ((Dv[k] == d_opens[k]) & (Dv[k] > neg)).to(i32) << (6 + k)
            bp[d] = code[:, H:].to(torch.int16)
        hit = own & (d == v1 + v2) & (lane == opt_lane)
        got = hit.any(1)
        score[got] = Mnew[hit]

    if halo_out is not None:
        last = d0 + nd - 1
        halo_out[:, 0] = state[:, last % 3, E - H:]
        halo_out[:, 1] = state[:, (last + 2) % 3, E - H:]
        for k in range(MAX_PW):
            halo_out[:, 2 + k] = state[:, i_plane(last % 2, k), E - H:]
            halo_out[:, 2 + MAX_PW + k] = state[:, d_plane(last % 2, k),
                                                E - H:]

"""SparseAffine chain x chain chaining values on the device (twin of
centrolign_tpu/ops/chain_cdq.py).

The value pass of the native offline CDQ engine (native/chain_affine_cdq.cpp)
as one dependent loop over anchors in start-position order: anchor i
publishes 6 piecewise channel values f32(f64(dp_i) -/+ scale*ge[k]*shift_i),
keyed by (shift_i = e1 - e2, its end positions), plus dp_i on the gap-free
channel; anchor j takes the maxima of the anchors whose ends precede its
start on both chains (gap-free channel: the same shift; piecewise channels:
a larger or a smaller shift) and folds the 7 channel maxima with the
reference's exact f32/f64 rounding sequence (reference
sparse_affine_chain_dp, anchorer.hpp:1812-2470, fold order
anchorer.hpp:2381-2420). Each channel maximum also gives its first index
and the count of entries equal to it; a count over 1 flags a tie, which
the caller resolves on the host (chain_ties.AffineTieResolver), as it does
for the native engine.

The per-anchor f64 constants (scale*ge[k]*shift_i and scale*(go[k] +/-
ge[k]*qshift_j)) are computed on the host with numpy in the native
engine's op order (`_prepare`); the scan performs only f32 adds, f64
widen/add/sub and rounding to f32, so dp/tie/struct/stored are bit-equal
to the native engine's and bp is equal wherever the winning channel is
untied.

Launch layout (built by `pack`, read by `cdq_scan_plain` and by
csrc/chain_cdq.cu), per problem b of a batch of B, N rows in sorted order:
 - key int32 (B, N, 4): (pe1, pe2, shift, valid), the static keys;
 - step int32 (B, N, 4): (ps1, ps2, qshift, has_query);
 - wi float32 (B, N, 2): (w, init);
 - fc float64 (B, N, 6), cs float64 (B, N, 3): the f64 constants;
 - prefix int32 (B,): 1 when every anchor has pe1 >= ps1, so that no row
   at or after row t can pass pe1 < ps1_t and a step scans only earlier
   rows; 0 makes it scan all N rows;
 - levels int32 (S, 4): the kernel's schedule, one row per dependency
   level of each problem, problem after problem: (b, q0, q1, index of the
   level in its problem). The level of row j is 1 + the largest level of a
   row i < j with pe1_i < ps1_j (1 when there is none): a row reads only
   rows of lower levels, and since ps1 is sorted the levels never fall, so
   level L is the run of rows [q0, q1) and the rows of lower levels are
   [0, q0). A row of the same level never passes a query's mask (it would
   sit a level higher), and the rows after a query hold -FLT_MAX until
   their level is published in both schedules, so the level-synchronous
   kernel gives the sequential scan's outputs bit for bit.
Outputs per row: dp float32, bp int32 (sorted index or -1), tie uint8,
struct uint8 (the winning channel, 255 for none), stored float32.

Unlike the JAX package there are no power-of-two shape buckets (nothing
is compiled per shape): a single problem is not padded, and a batch is
padded to its largest problem with rows that no anchor can reach.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import metrics
from ..device import make_context
from ..native import cdq_row_levels

_NEGF = np.float32(np.finfo(np.float32).min)
_NPW = 3


def _prepare(ps1, pe1, ps2, pe2, w, init, go, ge, scale, n_pad):
    """Host-side exact f64 constant preparation + start-order sort/pad
    (verbatim from the JAX package)."""
    n = len(ps1)
    order = np.lexsort((np.arange(n), ps1))  # (ps1, id) ascending

    def pad_i32(a, fill):
        out = np.full(n_pad, fill, dtype=np.int32)
        out[:n] = a[order]
        return out

    qs = (ps1 - ps2).astype(np.int64)
    go = np.asarray(go, dtype=np.float64)
    ge = np.asarray(ge, dtype=np.float64)
    scale = np.float64(scale)
    ck = scale * ge  # native: ck[k] = scale * gap_extend[k]

    sh = (pe1 - pe2).astype(np.float64)
    cs = np.empty((n, _NPW), dtype=np.float64)
    for k in range(_NPW):
        cs[:, k] = ck[k] * sh  # native store_channels: ck[k]*(double)sh

    # fold constants fc[j, pw] = scale * (go[k] +/- ge[k]*qshift_j) with
    # the native op order: t = ge*q; inner = go +/- t; fc = scale*inner
    q64 = qs.astype(np.float64)
    fc = np.empty((n, 2 * _NPW), dtype=np.float64)
    for k in range(_NPW):
        t = ge[k] * q64
        fc[:, 2 * k] = scale * (go[k] - t)      # pw even: shift > qshift
        fc[:, 2 * k + 1] = scale * (go[k] + t)  # pw odd: shift < qshift

    big = np.int32(2**31 - 2)
    pe1_s = pad_i32(pe1.astype(np.int64), big)
    pe2_s = pad_i32(pe2.astype(np.int64), big)
    shift_s = pad_i32((pe1 - pe2).astype(np.int64), big)
    valid = np.zeros(n_pad, dtype=bool)
    valid[:n] = True

    def pad_f(a, fill, dtype):
        out = np.full(a.shape[:0] + (n_pad,) + a.shape[1:], fill,
                      dtype=dtype)
        out[:n] = a[order]
        return out

    xs = (
        np.arange(n_pad, dtype=np.int32),
        pad_i32(ps1.astype(np.int64), big),
        pad_i32(ps2.astype(np.int64), big),
        pad_i32(qs, big),
        pad_f(np.asarray(w, dtype=np.float32), 0.0, np.float32),
        pad_f(np.asarray(init, dtype=np.float32), _NEGF, np.float32),
        np.concatenate([(ps1[order] >= 1), np.zeros(n_pad - n, bool)]),
        pad_f(fc, 0.0, np.float64),
        pad_f(cs, 0.0, np.float64),
    )
    return order, (pe1_s, pe2_s, shift_s, valid), xs


def _unsort(order, n, dp, bp, tie, strct, stored):
    """Scatter sorted-layout outputs back to anchor-id order; remap bp
    through the sort order."""
    out_dp = np.empty(n, np.float32)
    out_bp = np.full(n, -1, np.int64)
    out_tie = np.zeros(n, np.uint8)
    out_struct = np.full(n, 255, np.uint8)
    out_stored = np.full(n, _NEGF, np.float32)
    order = np.asarray(order)
    dp = np.asarray(dp[:n])
    bp = np.asarray(bp[:n])
    out_dp[order] = dp
    mapped = np.where(bp >= 0, order[np.clip(bp, 0, n - 1)], -1)
    out_bp[order] = mapped
    out_tie[order] = np.asarray(tie[:n])
    out_struct[order] = np.asarray(strct[:n])
    out_stored[order] = np.asarray(stored[:n])
    return out_dp, out_bp, out_tie, out_struct, out_stored


def runs(level):
    """(starts, ends) of the runs of equal values of a non-decreasing
    array."""
    level = np.asarray(level, np.int64)
    if not len(level):
        return level, level
    starts = np.flatnonzero(np.diff(level, prepend=level[0] - 1))
    return starts, np.append(starts[1:], len(level))


def level_steps(b, ps1, pe1):
    """The schedule rows (b, q0, q1, index of the level) of problem b, its
    rows in sorted order (module docstring)."""
    starts, ends = runs(cdq_row_levels(ps1, pe1))
    return np.stack([np.full(len(starts), b), starts, ends,
                     np.arange(len(starts))], axis=1).astype(np.int32)


def pack(problems, n_pad):
    """(orders, (key, step, wi, fc, cs, prefix, levels) as numpy arrays) of
    a batch of problems, each (ps1, pe1, ps2, pe2, w, init, go, ge, scale)
    with at most n_pad anchors (layout in the module docstring)."""
    B = len(problems)
    key = np.zeros((B, n_pad, 4), np.int32)
    step = np.zeros((B, n_pad, 4), np.int32)
    wi = np.zeros((B, n_pad, 2), np.float32)
    fc = np.zeros((B, n_pad, 2 * _NPW), np.float64)
    cs = np.zeros((B, n_pad, _NPW), np.float64)
    prefix = np.zeros(B, np.int32)
    levels = [np.zeros((0, 4), np.int32)]
    orders = []
    for b, (ps1, pe1, ps2, pe2, w, init, go, ge, scale) in enumerate(
            problems):
        ps1, pe1, ps2, pe2 = (np.asarray(a, np.int64)
                              for a in (ps1, pe1, ps2, pe2))
        order, (pe1_s, pe2_s, shift_s, valid), xs = _prepare(
            ps1, pe1, ps2, pe2, w, init, go, ge, scale, n_pad)
        orders.append(order)
        key[b] = np.stack([pe1_s, pe2_s, shift_s, valid], axis=1)
        step[b] = np.stack([xs[1], xs[2], xs[3], xs[6]], axis=1)
        wi[b] = np.stack([xs[4], xs[5]], axis=1)
        fc[b] = xs[7]
        cs[b] = xs[8]
        prefix[b] = bool((pe1 >= ps1).all())
        n = len(ps1)
        levels.append(level_steps(b, xs[1][:n], pe1_s[:n]))
    return orders, (key, step, wi, fc, cs, prefix, np.concatenate(levels))


def cdq_scan_plain(key, step, wi, fc, cs, prefix, levels=None):
    """Plain PyTorch version of the scan (the JAX package's _cdq_scan, one
    problem of the batch after the other; it takes the kernel's arguments
    and needs no schedule, `levels`): a loop over the N steps, each
    taking the 7 masked channel maxima over the table on the inputs'
    device with torch.argmax's first-index rule (over rows [0, t) only
    where `prefix` says so, as the kernel does), then folding them and
    publishing the row on the host in numpy with the same f32/f64
    rounding. Returns (dp, bp, tie, struct, stored), each (B, N), on the
    inputs' device."""
    B, N = key.shape[:2]
    dev = key.device
    out_dp = np.empty((B, N), np.float32)
    out_bp = np.full((B, N), -1, np.int32)
    out_tie = np.zeros((B, N), np.uint8)
    out_struct = np.full((B, N), 255, np.uint8)
    out_stored = np.full((B, N), _NEGF, np.float32)
    ninf = torch.tensor(-np.inf, dtype=torch.float32, device=dev)
    iota = torch.arange(N, device=dev)
    for b in range(B):
        pe1, pe2, shift, valid = key[b].unbind(1)
        valid = valid != 0
        pre = bool(prefix[b])
        steps = step[b].cpu().numpy()
        w_np, fc_np, cs_np = (a[b].cpu().numpy() for a in (wi, fc, cs))
        # column 0: dp (the gap-free channel), 1 + pw: the published
        # channel pw
        table = torch.full((N, 1 + 2 * _NPW), float(_NEGF),
                           dtype=torch.float32, device=dev)
        row = np.empty(1 + 2 * _NPW, np.float32)
        for t in range(N):
            ps1_j, ps2_j, qs_j, hasq_j = (int(x) for x in steps[t])
            w_j, init_j = w_np[t]
            dp_j = init_j
            if hasq_j:
                base = (pe1 < ps1_j) & (pe2 < ps2_j) & valid
                if pre:
                    base &= iota < t
                gt, lt = (shift > qs_j) & base, (shift < qs_j) & base
                # fold order: gap-free, then pw = 0..5 (pw even: shift >
                # qshift, odd: shift < qshift)
                mask = torch.stack([(shift == qs_j) & base]
                                   + [gt, lt] * _NPW, dim=1)
                m = torch.where(mask, table, ninf)
                v = m.max(dim=0).values
                who = m.argmax(dim=0)
                cnt = (mask & (table == v)).sum(dim=0)
                has = mask.any(dim=0)
                # one copy to the host: f64 holds each exactly
                v_np, who, cnt, has = torch.stack(
                    [v.double(), who.double(), cnt.double(),
                     has.double()]).cpu().numpy()
                v_np = v_np.astype(np.float32)
                who, cnt, has = who.astype(np.int64), cnt.astype(np.int64), \
                    has.astype(bool)
                best = init_j
                for c in range(1 + 2 * _NPW):
                    value = v_np[c] + w_j  # plain f32 add
                    if c > 0:
                        # (f32)((f64)(f32)(v + w) - scale*inner)
                        value = np.float32(np.float64(value)
                                           - fc_np[t, c - 1])
                    if has[c] and value > best:
                        best = value
                        out_bp[b, t], out_tie[b, t] = who[c], cnt[c] > 1
                        out_struct[b, t], out_stored[b, t] = c, v_np[c]
                dp_j = best
            out_dp[b, t] = dp_j
            # publish: dp, then (f32)((f64)dp -/+ cs[k]) for k = 0..2
            d64 = np.float64(dp_j)
            row[0] = dp_j
            row[1::2] = (d64 - cs_np[t]).astype(np.float32)
            row[2::2] = (d64 + cs_np[t]).astype(np.float32)
            table[t] = torch.from_numpy(row).to(dev)
    return tuple(torch.from_numpy(x).to(dev) for x in (
        out_dp, out_bp, out_tie, out_struct, out_stored))


def _empty(qshift):
    return (np.empty(0, np.float32), np.empty(0, np.int64),
            np.empty(0, np.uint8), np.empty(0, np.uint8),
            np.empty(0, np.float32), qshift)


def chain_cdq_device_batch(problems, device: torch.device):
    """Several chain problems in ONE scan on `device`: the kernel of
    csrc/chain_cdq.cu (one launch, level after level) on a card, the plain
    version on the CPU. problems: list of (ps1, pe1, ps2, pe2, w, init, go,
    ge, scale) tuples. Returns a list of (dp, bp, tie, struct, stored, qshift)
    per problem in anchor-id order, as native.chain_affine_cdq does."""
    from .chain_cdq_cuda import cdq_scan
    if not problems:
        return []
    qshifts = [np.asarray(p[0], np.int64) - np.asarray(p[2], np.int64)
               for p in problems]
    live = [b for b, p in enumerate(problems) if len(p[0])]
    res = [_empty(q) for q in qshifts]
    if not live:
        return res
    n_pad = max(len(problems[b][0]) for b in live)
    orders, arrays = pack([problems[b] for b in live], n_pad)
    make_context(device)
    outs = cdq_scan(*(torch.from_numpy(a).to(device) for a in arrays),
                    anchors=sum(len(problems[b][0]) for b in live))
    with metrics.span("device.wait"):
        outs = [o.cpu().numpy() for o in outs]
    for k, b in enumerate(live):
        n = len(problems[b][0])
        res[b] = (*_unsort(orders[k], n, *(o[k] for o in outs)), qshifts[b])
    return res


def chain_cdq_device(ps1, pe1, ps2, pe2, w, init, go, ge, scale,
                     device: torch.device):
    """Drop-in device twin of native.chain_affine_cdq on `device`: returns
    (dp, bp, tie, struct, stored, qshift) in anchor-id order."""
    return chain_cdq_device_batch(
        [(ps1, pe1, ps2, pe2, w, init, go, ge, scale)], device)[0]

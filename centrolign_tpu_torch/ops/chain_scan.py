"""Free-gap sparse chaining on chain graphs as an event scan (twin of
centrolign_tpu/ops/chain_scan.py).

The reference's sparse_chain_dp (anchorer.hpp:1511-1750) sweeps graph1 in
topological order, maintaining one max-search tree per (path1, path2) pair
keyed by (index-on-path2 of the anchor's end, match id): anchor ends insert
their DP value, anchor starts query the prefix of path2 positions strictly
before their own. On single-path (chain) graphs — every calibration
workload, and any gap subgraph that is a chain — there is exactly one tree
and the whole sweep linearizes into an EVENT SCAN:

    for each position p of chain1, in order:
        ends at p:    val[slot(id)] = dp[id]          (insert)
        starts with predecessor p:
                      dp[id] = max(w[id], max(val[slot : idx2 <= pred2])
                                          + w[id])    (query)

with a dense value table in place of the tree: inserts are stores, queries
are maxima over a prefix of the table. DP values are IEEE f32 adds in the
reference's own order, so scores are bit-identical to the native engine.
Backpointer TIES (several predecessors attaining the same f32 prefix max)
are resolved on the host by the native search tree's visit/insert-order
rules (`_tree_tie_winner`), so chains are identical too on the calibration
workloads.

The scan itself runs on the device: csrc/chain_scan.cu on a card, the
plain version `event_scan_plain` on the CPU (ops/chain_scan_cuda.py::
event_scan routes by the tensors' device). Event layout, shared by both:
one int32 row of 4 per event, (kind: 0 query / 1 insert, slot: the
anchor's value-table slot, qhi: a query's exclusive slot bound, the bit
pattern of the f32 weight). The table has one slot per anchor, and there
is one event per insert and per query: no padding.

The kernel runs one step per dependency level, not per event (`levels`,
from `event_steps`): a query with qhi > 0 sits one level above every
insert before it, and an insert has the level of its slot's query when
that query came first, else 0 (native/chain_levels.cpp). Levels never fall
along the stream, so a level is a run of consecutive queries. A level-L
query takes the leftmost maximum over the slots below its bound whose
insert event precedes its own: each such slot was written in a lower
level, so it holds the value the sequential scan reads, and a slot
inserted later holds -FLT_MAX there, which never wins. The schedule is
(steps (S, 4) int32: (q0, q1, hi, level) over `queries`, hi the largest
bound of the level's queries; queries (Q,) int32: the event index of each
query with qhi > 0, in stream order).

Used by Anchorer._chain_parity when CENTROLIGN_TPU_DEVICE_CHAIN=1, both
graphs are single chains and the anchorer has a device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import metrics
from ..device import make_context
from ..chain_ties import _heap_rank, _subtree_interval
from ..native import chain_event_levels
from .chain_cdq import runs

_NEGF = np.float32(np.finfo(np.float32).min)


def event_scan_plain(ev, dp0):
    """Plain PyTorch version of the scan (the JAX package's _event_scan): a
    loop over the events, a query taking torch.argmax's leftmost maximum of
    the table below its bound (the slots at or above it hold -FLT_MAX in
    the JAX scan's masked table, and a query needs more). Returns (dp
    (n,) f32, winner (E,) int32 slot of each query's winner or -1), on the
    inputs' device."""
    dev = dp0.device
    kind, slot, qhi, wbits = ev.cpu().numpy().T
    weight = torch.from_numpy(np.ascontiguousarray(wbits).view(np.float32)
                              ).to(dev)
    dp = dp0.clone()
    val = torch.full_like(dp0, float(_NEGF))
    negf = torch.tensor(float(_NEGF), dtype=torch.float32, device=dev)
    winner = torch.full((len(kind),), -1, dtype=torch.int32, device=dev)
    for e in range(len(kind)):
        s = int(slot[e])
        if kind[e] == 1:
            val[s] = dp[s]
        elif qhi[e] > 0:
            win = val[:int(qhi[e])].argmax()  # leftmost max in key order
            best = val[win]
            cand = best + weight[e]
            upd = (best > negf) & (cand > dp[s])
            dp[s] = torch.where(upd, cand, dp[s])
            winner[e] = torch.where(upd, win.to(torch.int32), winner[e])
    return dp, winner


# ---------------------------------------------------------------------------
# Exact tie resolution. DP VALUES are winner-independent, but when several
# predecessors attain the same f32 prefix max, the reference's MaxSearchTree
# picks a history-dependent winner: its range_max visits the Eytzinger tree
# in a fixed order keeping the FIRST max (strict >), and each subtree's
# cached submax identity is the FIRST-INSERTED among its equal maxima
# (updates use strict > too). Both rules are pure rank arithmetic — the
# tree's in-order rank of a heap node and each subtree's rank interval —
# so the winner can be computed WITHOUT building the tree, in O(log^2 n)
# per tied query. (_heap_rank and _subtree_interval live in chain_ties.)


def _tree_tie_winner(n, qhi, tied_slots, insert_rank):
    """The native MaxTreeP.range_max winner over prefix range [0, qhi) when
    `tied_slots` (sorted in-order ranks) all hold the range-max value.
    insert_rank[slot] orders equal-value submax adoption (first wins)."""
    tied = np.asarray(tied_slots)

    def subtree_candidate(x):
        lo, hi, _r = _subtree_interval(x, n)
        inside = tied[(tied >= lo) & (tied < hi)]
        if len(inside) == 0:
            return None
        return int(inside[np.argmin(insert_rank[inside])])

    def rank_of(x):
        return _subtree_interval(x, n)[2]

    # descend to the top of the range decomposition (lo is minimal)
    cursor = 0
    while cursor < n and rank_of(cursor) >= qhi:
        cursor = 2 * cursor + 1
    if cursor >= n:
        return None
    r = rank_of(cursor)
    if r in tied:
        return int(r)
    # left-boundary walk: whole left spine below cursor is in range
    lc = 2 * cursor + 1
    while lc < n:
        r = rank_of(lc)
        if r in tied:
            return int(r)
        rgt = 2 * lc + 2
        if rgt < n:
            cand = subtree_candidate(rgt)
            if cand is not None:
                return cand
        lc = 2 * lc + 1
    # right-boundary walk
    rc = 2 * cursor + 2
    while rc < n:
        if rank_of(rc) < qhi:
            r = rank_of(rc)
            if r in tied:
                return int(r)
            lft = 2 * rc + 1
            if lft < n:
                cand = subtree_candidate(lft)
                if cand is not None:
                    return cand
            rc = 2 * rc + 2
        else:
            rc = 2 * rc + 1
    return None


def event_steps(ev, n):
    """The kernel's schedule (steps, queries) of the event stream `ev` over
    n slots (module docstring)."""
    level = chain_event_levels(ev, n)
    queries = np.flatnonzero(level > 0).astype(np.int32)
    starts, ends = runs(level[queries])
    hi = (np.minimum(np.maximum.reduceat(ev[queries, 2], starts), n)
          if len(starts) else np.empty(0, np.int32))
    steps = np.stack([starts, ends, hi, np.arange(len(starts))], axis=1)
    return steps.astype(np.int32), queries


def build_events(starts1_pos, ends1_pos, idx2_start, idx2_end, weights,
                 reach_src):
    """The scan's inputs for n >= 1 anchors (arguments as for
    sparse_chain_scan): (order: slot -> anchor, qhi per slot, ev (E, 4)
    int32 in the event layout, dp0 (n,) f32, levels: the kernel's schedule
    (steps, queries))."""
    n = len(weights)
    w32 = np.asarray(weights, dtype=np.float32)

    # value-table slots: key-sorted by (idx2 of end, anchor id) — the
    # native tree's key order, so prefix bounds are searchsorted indices.
    # Everything below lives in SLOT space; `order` maps slot -> anchor.
    order = np.lexsort((np.arange(n), idx2_end))
    idx2_sorted = np.asarray(idx2_end, dtype=np.int64)[order]
    w_slot = w32[order]
    dp0 = np.where(np.asarray(reach_src)[order], w_slot, _NEGF
                   ).astype(np.float32)
    ends_pos = np.asarray(ends1_pos, dtype=np.int64)[order]
    pred1 = np.asarray(starts1_pos, dtype=np.int64)[order] - 1
    pred2 = np.asarray(idx2_start, dtype=np.int64)[order] - 1
    has_query = pred1 >= 0
    qhi = np.searchsorted(idx2_sorted, pred2, side="right").astype(np.int32)

    # events: position-major over chain1; inserts (at end position) and
    # queries (at start's predecessor position) interleave exactly as the
    # reference sweep visits them: per node, ends first, then starts
    slots = np.arange(n, dtype=np.int32)
    ev_pos = np.concatenate([ends_pos, np.where(has_query, pred1, -1)])
    ev_kind = np.concatenate([np.ones(n, np.int32), np.zeros(n, np.int32)])
    ev_slot = np.concatenate([slots, slots])
    ev_qhi = np.concatenate([np.zeros(n, np.int32), qhi])
    ev_w = np.concatenate([w_slot, w_slot])
    keep = np.concatenate([np.ones(n, bool), has_query])
    ev_pos, ev_kind, ev_slot, ev_qhi, ev_w = (
        a[keep] for a in (ev_pos, ev_kind, ev_slot, ev_qhi, ev_w))
    ev_order = np.lexsort((-ev_kind, ev_pos))
    ev_kind = ev_kind[ev_order]
    ev_slot = ev_slot[ev_order]
    ev_qhi = ev_qhi[ev_order]
    ev_w = ev_w[ev_order]

    ev = np.stack([ev_kind, ev_slot, ev_qhi, ev_w.view(np.int32)], axis=1)
    return order, qhi, ev, dp0, event_steps(ev, n)


def sparse_chain_scan(starts1_pos, ends1_pos, idx2_start, idx2_end,
                      weights, reach_src, reach_snk, device: torch.device):
    """Free-gap sparse chain DP over one (chain1, chain2) pair, its event
    scan on `device`.

    Inputs are per-anchor numpy arrays: positions of walk endpoints on the
    two chains (graph1 topological positions / graph2 chain indices),
    f32-cast anchor weights, and boolean source/sink reachability gates
    (the reference's global-anchoring dp-init and final-term gates,
    sparse_parity_impl). Returns (order of chained anchor indices,
    opt score) — an empty chain when no positive-score chain exists.
    """
    from .chain_scan_cuda import event_scan

    n = len(weights)
    if n == 0:
        return [], 0.0
    order, qhi, ev, dp0, levels = build_events(
        starts1_pos, ends1_pos, idx2_start, idx2_end, weights, reach_src)
    make_context(device)
    dp, winners = event_scan(
        torch.from_numpy(ev).to(device), torch.from_numpy(dp0).to(device),
        tuple(torch.from_numpy(a).to(device) for a in levels), anchors=n)
    with metrics.span("device.wait"):
        dp = dp.cpu().numpy()
        winners = winners.cpu().numpy()
    ev_kind, ev_slot = ev[:, 0], ev[:, 1]
    ends_pos = np.asarray(ends1_pos, dtype=np.int64)[order]

    # backpointers (slot -> slot) from the query winners
    bp = np.full(n, -1, dtype=np.int64)
    q_mask = ev_kind == 0
    got = winners[q_mask] >= 0
    bp[ev_slot[q_mask][got]] = winners[q_mask][got]

    # native insert order (for exact tie resolution): ends by position,
    # bank (anchor) order within a position
    insert_rank = np.empty(n, dtype=np.int64)
    ir_anchor = np.empty(n, dtype=np.int64)
    ir_anchor[np.lexsort((np.arange(n), np.asarray(ends1_pos)))] = \
        np.arange(n)
    slot_lookup = np.empty(n, dtype=np.int64)
    slot_lookup[order] = np.arange(n)
    insert_rank[slot_lookup] = ir_anchor

    starts_pos = np.asarray(starts1_pos, dtype=np.int64)[order]

    def exact_winner(j):
        """Slot of the native tree's winner for chained slot j (bp[j] when
        the prefix max is unique; the visit/insert-order tie winner when
        several predecessors attain it)."""
        w = int(bp[j])
        if w < 0:
            return -1
        best = dp[w]
        visible = (ends_pos < starts_pos[j]) & \
                  (np.arange(n) < qhi[j]) & (dp == best)
        tied = np.flatnonzero(visible)
        if len(tied) <= 1:
            return w
        win = _tree_tie_winner(n, int(qhi[j]), tied, insert_rank)
        return w if win is None else win

    # traceback (reference traceback_sparse_dp): opt over sink-reachable
    # anchors with dp > 0
    final = np.where(np.asarray(reach_snk)[order], dp, _NEGF)
    if not len(final) or final.max() <= 0.0:
        return [], 0.0
    # opt tie rule: the native loop keeps the FIRST max in anchor order
    final_anchor = np.empty(n, dtype=np.float32)
    final_anchor[order] = final
    slot_of = np.empty(n, dtype=np.int64)
    slot_of[order] = np.arange(n)
    opt = int(slot_of[np.argmax(final_anchor)])
    chain = []
    at = opt
    while at != -1:
        chain.append(int(order[at]))
        at = exact_winner(at)
    chain.reverse()
    return chain, float(final[opt])

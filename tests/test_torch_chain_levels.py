"""The level schedule of the device-chaining scans and a model of their
level-synchronous kernels (csrc/chain_cdq.cu, csrc/chain_scan.cu), on the
CPU.

The schedule (ops/chain_cdq.py::pack, ops/chain_scan.py::event_steps,
native/chain_levels.cpp) is checked against its definition by brute force:
levels contiguous and monotone, no query reading a row of its own or a
higher level, a chain of N dependent anchors N levels deep. The model
follows the kernels' algorithm: per level, the rows to scan cut into one
chunk per block, each chunk staged `stage_rows` at a time and split over
the threads of each query, one partial per (block, thread), the partials
merged ("greater wins; on equal values the lower index wins and the counts
add"), then the fold and the publication after the level. Several
chunkings are tried, the card's among them and one row a block.

Tolerance: 0. Every output of the model is compared bit for bit with the
plain versions (`cdq_scan_plain`, `event_scan_plain`) and with the JAX
package's scans (`chain_cdq_device` over `_cdq_scan`, `_event_scan`), run
on the CPU as the JAX package's own tests run them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centrolign_tpu.ops import chain_cdq as jax_cdq
from centrolign_tpu.ops import chain_scan as jax_scan
from centrolign_tpu_torch.native import chain_event_levels
from centrolign_tpu_torch.ops import chain_cdq, chain_scan

# chip_smoke's bag generators
from chip_smoke import (cdq_problem, chain_events, chain_problem,
                        scan_problem, two_level_problem)

NEGF = np.float32(np.finfo(np.float32).min)
NONE = 2 ** 31 - 1

# (blocks, threads, stage_rows, part_queries): the card's launch, one row a
# block, and small ones that split levels over passes and query chunks
CHUNKINGS = {
    "card": (132, 1024, 4096, 2048),
    "row_a_block": (10 ** 6, 32, 4096, 2048),
    "small": (3, 8, 2, 5),
    "narrow": (7, 4, 6, 2),
}


def _cdq_problems(name):
    rng = np.random.default_rng(7100 + len(name))
    return {
        "random": lambda: [cdq_problem(rng, 200)],
        "tie_dense": lambda: [cdq_problem(rng, 300, tie_dense=True)],
        "bent": lambda: [cdq_problem(rng, 250, bent=True)],
        "chain": lambda: [chain_problem(64)],
        "two_levels": lambda: [two_level_problem(rng, 80)],
        "batch": lambda: [cdq_problem(rng, 150), chain_problem(40),
                          cdq_problem(rng, 0), two_level_problem(rng, 60),
                          cdq_problem(rng, 120, bent=True)],
    }[name]()


CDQ_PROBLEMS = ["random", "tie_dense", "bent", "chain", "two_levels",
                "batch"]


# ---------------------------------------------------------------------------
# the model


def _width(nq, threads):
    """Threads a query in a pass of nq queries (csrc/*.cu)."""
    return threads // (1 << max(int(nq) - 1, 0).bit_length())


def _chunks(q0, q1, threads, part_queries):
    """A level's queries as the kernels take them: chunks of at most
    part_queries queries between two grid barriers, each a list of passes
    (first query, queries, width) of at most `threads` queries."""
    for a0 in range(q0, q1, part_queries):
        a1 = min(q1, a0 + part_queries)
        yield [(p0, min(a1 - p0, threads), _width(min(a1 - p0, threads),
                                                   threads))
               for p0 in range(a0, a1, threads)]


def _groups(lim, blocks, stage_rows, width, even=False):
    """The (block, thread) each row of [0, lim) goes to, as one id: a
    contiguous chunk per block (of an even size for the event scan's
    16-byte copies), staged stage_rows at a time, every width-th staged row
    to one thread."""
    chunk = -(-lim // blocks)
    if even:
        chunk += chunk & 1
    if not chunk:
        return np.zeros(0, np.int64)
    r = np.arange(lim)
    return (r // chunk) * width + ((r % chunk) % stage_rows) % width


def _partials(vals, passed, rows, group):
    """Each group's triple (max, first row with it, count of it) over its
    passing rows, as a thread's take() in ascending rows makes it, then the
    groups merged (the max; among groups with it the lowest row, the
    counts added)."""
    if not passed.any():
        return -np.inf, NONE, 0
    ids, inv = np.unique(group[passed], return_inverse=True)
    v = vals[passed]
    mx = np.full(len(ids), -np.inf, np.float32)
    np.maximum.at(mx, inv, v)
    att = v == mx[inv]
    first = np.full(len(ids), NONE, np.int64)
    np.minimum.at(first, inv[att], rows[passed][att])
    cnt = np.bincount(inv[att], minlength=len(ids))
    best = mx.max()
    win = mx == best
    return best, int(first[win].min()), int(cnt[win].sum())


def cdq_level_model(key, step, wi, fc, cs, prefix, levels, blocks, threads,
                    stage_rows, part_queries):
    """The level-synchronous CDQ scan on numpy arrays in the launch layout:
    (dp, bp, tie, struct, stored), each (B, N)."""
    B, N = key.shape[:2]
    dp = wi[:, :, 1].copy()
    bp = np.full((B, N), -1, np.int32)
    tie = np.zeros((B, N), np.uint8)
    strct = np.full((B, N), 255, np.uint8)
    stored = np.full((B, N), NEGF, np.float32)
    # column 0: dp (the gap-free channel), 1 + pw: channel pw
    table = np.full((B, N, 7), NEGF, np.float32)
    rows = np.arange(N)
    for b, q0, q1, _ in levels:
        pe1, pe2, shift, valid = key[b].T
        lim = q0 if prefix[b] else N
        for chunk in _chunks(q0, q1, threads, part_queries):
            found = {}  # the partials of the chunk's queries, merged
            for p0, nq, width in chunk:
                group = _groups(lim, blocks, stage_rows, width)
                for t in range(p0, p0 + nq):
                    ps1, ps2, qs, hasq = step[b, t]
                    if not hasq:
                        continue
                    base = ((pe1[:lim] < ps1) & (pe2[:lim] < ps2)
                            & (valid[:lim] != 0))
                    masks = [base & (shift[:lim] == qs)] + [
                        base & ((shift[:lim] < qs) if pw % 2
                                else (shift[:lim] > qs)) for pw in range(6)]
                    found[t] = [_partials(table[b, :lim, c], masks[c],
                                          rows[:lim], group)
                                for c in range(7)]
            # fold: after every partial of the chunk
            for t, triples in found.items():
                w, best = wi[b, t]
                for c, (v, idx, cnt) in enumerate(triples):
                    value = np.float32(np.float32(v) + w)
                    if c > 0:
                        value = np.float32(np.float64(value) - fc[b, t, c - 1])
                    if cnt > 0 and value > best:
                        best = value
                        bp[b, t], tie[b, t] = idx, cnt > 1
                        strct[b, t], stored[b, t] = c, v
                dp[b, t] = best
        # publish the level after all its queries
        for t in range(q0, q1):
            d64 = np.float64(dp[b, t])
            table[b, t, 0] = dp[b, t]
            table[b, t, 1::2] = (d64 - cs[b, t]).astype(np.float32)
            table[b, t, 2::2] = (d64 + cs[b, t]).astype(np.float32)
    return dp, bp, tie, strct, stored


def event_level_model(ev, dp0, steps, queries, blocks, threads, stage_rows,
                      part_queries):
    """The level-synchronous event scan: (dp, winner)."""
    n, E = len(dp0), len(ev)
    kind, slot, qhi, wbits = ev.T
    weight = np.ascontiguousarray(wbits).view(np.float32)
    dp = dp0.copy()
    val = dp0.copy()
    ins = np.full(n, NONE, np.int64)
    ins[slot[kind == 1]] = np.flatnonzero(kind == 1)
    winner = np.full(E, -1, np.int32)
    rows = np.arange(n)
    for q0, q1, hi, _ in steps:
        for chunk in _chunks(q0, q1, threads, part_queries):
            found = []
            for p0, nq, width in chunk:
                group = _groups(hi, blocks, stage_rows, width, even=True)
                for qi in range(p0, p0 + nq):
                    e = queries[qi]
                    passed = ((rows[:hi] < qhi[e]) & (ins[:hi] < e)
                              & (val[:hi] > NEGF))
                    v, idx, _ = _partials(val[:hi], passed, rows[:hi],
                                          group)
                    found.append((e, v, idx))
            # fold: after every partial of the chunk
            for e, v, idx in found:
                s = slot[e]
                cand = np.float32(np.float32(v) + weight[e])
                if v > NEGF and cand > dp[s]:
                    dp[s] = cand
                    winner[e] = idx
                if ins[s] > e:
                    val[s] = dp[s]
    return dp, winner


# ---------------------------------------------------------------------------
# the CDQ scan's schedule


def _brute_row_levels(ps1, pe1):
    level = np.zeros(len(ps1), np.int64)
    for j in range(len(ps1)):
        below = level[:j][pe1[:j] < ps1[j]]
        level[j] = 1 + (below.max() if len(below) else 0)
    return level


@pytest.mark.parametrize("name", CDQ_PROBLEMS)
def test_cdq_schedule_is_the_dependency_levels(name):
    problems = _cdq_problems(name)
    n_pad = max(max(len(p[0]) for p in problems), 1)
    _, arrays = chain_cdq.pack(problems, n_pad)
    key, step, levels = arrays[0], arrays[1], arrays[6]
    for b, p in enumerate(problems):
        n = len(p[0])
        mine = levels[levels[:, 0] == b]
        if not n:
            assert not len(mine)
            continue
        # contiguous, in order, covering the problem's rows once
        assert np.array_equal(mine[:, 3], np.arange(len(mine)))
        assert np.array_equal(mine[:, 1], np.r_[0, mine[:-1, 2]])
        assert (mine[:, 2] > mine[:, 1]).all()
        assert mine[-1, 2] == n
        level = np.repeat(mine[:, 3] + 1, mine[:, 2] - mine[:, 1])
        ps1, pe1 = step[b, :n, 0], key[b, :n, 0]
        assert np.array_equal(level, _brute_row_levels(ps1, pe1))
        # no query reads a row of its own or a higher level
        reads = pe1[:, None] < ps1[None, :]
        earlier = np.tri(n, k=-1, dtype=bool).T
        assert (level[:, None] < level[None, :])[reads & earlier].all()
        if name == "chain":
            assert len(mine) == n


def test_cdq_chain_of_n_anchors_is_n_levels_deep():
    for n in (1, 2, 500, 5000):
        _, arrays = chain_cdq.pack([chain_problem(n)], n)
        assert len(arrays[6]) == n


# ---------------------------------------------------------------------------
# the CDQ scan's model


def _cdq_packed(name):
    problems = _cdq_problems(name)
    n_pad = max(max(len(p[0]) for p in problems), 1)
    orders, arrays = chain_cdq.pack(problems, n_pad)
    return problems, orders, arrays


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
@pytest.mark.parametrize("name", CDQ_PROBLEMS)
def test_cdq_level_model_matches_plain(name, chunking):
    _, _, arrays = _cdq_packed(name)
    got = cdq_level_model(*arrays, *CHUNKINGS[chunking])
    want = chain_cdq.cdq_scan_plain(*(torch.from_numpy(a) for a in arrays))
    for a, b in zip(got, want):
        assert np.array_equal(a.view(np.uint8), b.numpy().view(np.uint8))
    if name == "tie_dense":
        assert got[2].any()


@pytest.mark.parametrize("name", CDQ_PROBLEMS)
def test_cdq_level_model_matches_jax(name):
    problems, orders, arrays = _cdq_packed(name)
    got = cdq_level_model(*arrays, *CHUNKINGS["card"])
    for b, p in enumerate(problems):
        n = len(p[0])
        if not n:
            continue
        mine = chain_cdq._unsort(orders[b], n, *(o[b] for o in got))
        want = jax_cdq.chain_cdq_device(*p)
        for x, y in zip(mine, want):
            assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# the event scan's schedule and model


def _random_events(rng, n):
    """A stream over n slots in which each slot is inserted once and
    queried at most once, sometimes after its insert, with weights from a
    few values so that maxima tie (as tests/test_torch_chain_scan.py's)."""
    kind, slot, qhi = [], [], []
    for s in rng.permutation(n):
        late = rng.random() < 0.2
        if not late and rng.random() < 0.8:
            kind.append(0)
            slot.append(s)
            qhi.append(int(rng.integers(0, n + 1)))
        kind.append(1)
        slot.append(s)
        qhi.append(0)
        if late:
            kind.append(0)
            slot.append(s)
            qhi.append(int(rng.integers(0, n + 1)))
    w = (rng.integers(1, 4, len(kind)) * 2.0).astype(np.float32)
    ev = np.stack([kind, slot, qhi, w.view(np.int32)], axis=1).astype(
        np.int32)
    dp0 = np.where(rng.random(n) < 0.9, rng.integers(1, 4, n) * 2.0,
                   NEGF).astype(np.float32)
    return ev, dp0


def _events(name):
    rng = np.random.default_rng(7200 + len(name))
    if name == "stream":
        return _random_events(rng, 300)
    args = {"random": lambda: scan_problem(rng, 300),
            "tie_dense": lambda: scan_problem(rng, 300, tie_dense=True),
            "chain": lambda: chain_events(64),
            "wide": lambda: scan_problem(rng, 1200)}[name]()
    _, _, ev, dp0, _ = chain_scan.build_events(*args[:6])
    return ev, dp0


EVENT_PROBLEMS = ["random", "tie_dense", "stream", "chain", "wide"]


def _brute_event_levels(ev):
    """Per event: a query with qhi > 0 is 1 + the largest level of an
    insert before it; an insert has its slot's query's level when that
    query came first."""
    level = np.zeros(len(ev), np.int64)
    query_level = {}
    inserts = []  # the level of each insert so far
    for e, (kind, s, hi, _) in enumerate(ev):
        if kind == 1:
            inserts.append(query_level.get(int(s), 0))
        elif hi > 0:
            level[e] = 1 + max(inserts, default=0)
            query_level[int(s)] = level[e]
    return level


@pytest.mark.parametrize("name", EVENT_PROBLEMS)
def test_event_schedule_is_the_dependency_levels(name):
    ev, dp0 = _events(name)
    steps, queries = chain_scan.event_steps(ev, len(dp0))
    if name != "wide":
        level = _brute_event_levels(ev)
        assert np.array_equal(queries, np.flatnonzero(level > 0))
        assert np.array_equal(np.repeat(steps[:, 3] + 1,
                                        steps[:, 1] - steps[:, 0]),
                              level[queries])
    # contiguous and monotone runs of queries in stream order, hi their
    # largest bound
    assert np.array_equal(steps[:, 3], np.arange(len(steps)))
    assert np.array_equal(steps[:, 0], np.r_[0, steps[:-1, 1]])
    assert steps[-1, 1] == len(queries) and (np.diff(queries) > 0).all()
    for q0, q1, hi, _ in steps:
        assert hi == min(ev[queries[q0:q1], 2].max(), len(dp0))
    # every value a query may read was written in a lower level: an
    # insert before it stores its slot's query's result when that query
    # came first
    qlevel = np.zeros(len(ev), np.int64)
    qlevel[queries] = np.repeat(steps[:, 3] + 1, steps[:, 1] - steps[:, 0])
    query_of = {int(ev[e, 1]): e for e in np.flatnonzero(ev[:, 0] == 0)}
    for e in queries[::7]:
        for i in np.flatnonzero(ev[:e, 0] == 1):
            q = query_of.get(int(ev[i, 1]))
            if q is not None and q < i:
                assert qlevel[q] < qlevel[e]
    if name == "chain":
        # the first anchor's query has nothing below its bound
        assert len(steps) == len(dp0) - 1 and ev[0, 2] == 0


def test_event_schedule_refuses_what_the_kernel_does_not_take():
    ev = np.array([[0, 0, 1, 0], [1, 0, 0, 0], [1, 0, 0, 0]], np.int32)
    with pytest.raises(ValueError):
        chain_event_levels(ev, 1)  # a slot inserted twice
    with pytest.raises(ValueError):
        chain_event_levels(ev[[0, 0]], 1)  # queried twice
    with pytest.raises(ValueError):
        chain_event_levels(ev[:1], 0)  # a slot out of range


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
@pytest.mark.parametrize("name", EVENT_PROBLEMS)
def test_event_level_model_matches_plain(name, chunking):
    ev, dp0 = _events(name)
    steps, queries = chain_scan.event_steps(ev, len(dp0))
    dp, winner = event_level_model(ev, dp0, steps, queries,
                                   *CHUNKINGS[chunking])
    want_dp, want_win = chain_scan.event_scan_plain(torch.from_numpy(ev),
                                                    torch.from_numpy(dp0))
    assert np.array_equal(dp.view(np.int32), want_dp.numpy().view(np.int32))
    assert np.array_equal(winner, want_win.numpy())
    assert (winner >= 0).any()


@pytest.mark.parametrize("name", EVENT_PROBLEMS)
def test_event_level_model_matches_jax(name):
    ev, dp0 = _events(name)
    steps, queries = chain_scan.event_steps(ev, len(dp0))
    dp, winner = event_level_model(ev, dp0, steps, queries,
                                   *CHUNKINGS["card"])
    kind, slot, qhi, wbits = ev.T
    dp_j, win_j = jax_scan._event_scan(*(jnp.asarray(a) for a in (
        kind, slot, qhi, np.ascontiguousarray(wbits).view(np.float32),
        dp0)))
    assert np.array_equal(dp.view(np.int32),
                          np.asarray(dp_j).view(np.int32))
    assert np.array_equal(winner, np.asarray(win_j))

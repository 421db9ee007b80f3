"""The port's dispatch layer on the CPU against the JAX package.

gotoh_dispatch / gotoh_fetch over a bag shaped like
tests/test_packmulti_device.py (52 jobs in two size classes), here also
mixing truncated parameters, both orientations and swap_pref: every job's
alignment and score must equal centrolign_tpu.ops.gotoh.gotoh_align's
(tolerance: exact, integer DP).
"""

import numpy as np
import pytest
import torch

from centrolign_tpu.ops.align_params import AlignmentParams
from centrolign_tpu.ops.gotoh import gotoh_align as jax_gotoh_align
from centrolign_tpu_torch.ops import gotoh_cuda as gc
from centrolign_tpu_torch.ops.align_params import params_from_arrays

CPU = torch.device("cpu")
# shared memory a block of an H100 can have
MAX_SHARED_BYTES = 232448

# the chain jobs benchdata/pair.fasta dispatches (one launch) and those of
# benchdata/five.fasta + five.nwk (five launches), as (V1, V2)
PAIR_JOBS = [(437, 437), (401, 401), (436, 436), (426, 426), (1167, 141),
             (422, 422), (422, 422), (3296, 218), (1217, 191), (420, 420),
             (2541, 660), (174, 1200), (492, 494), (490, 490), (431, 431),
             (418, 418), (1255, 229), (1000, 1000), (1640, 614), (335, 1363),
             (436, 436), (414, 414), (424, 424), (276, 2328), (421, 421),
             (419, 419), (504, 504), (4356, 3330)]
FIVE_JOBS = [
    [(440, 440), (497, 497), (419, 419), (713, 712), (401, 401), (168, 1197),
     (436, 436), (583, 585), (422, 422), (422, 422), (1428, 1428)],
    [(439, 439), (450, 450), (420, 420), (490, 490), (431, 431), (418, 418),
     (436, 436), (338, 1364), (2318, 266), (436, 436), (414, 414), (424, 424),
     (419, 419), (414, 414)],
    [(440, 440), (401, 401), (169, 1195), (436, 436), (1194, 168), (422, 422),
     (298, 1324), (226, 1252), (412, 412), (420, 420), (558, 558), (118, 2170),
     (490, 490), (431, 431), (418, 418), (436, 436), (1326, 300), (460, 460),
     (436, 436), (414, 414), (424, 424), (419, 419), (417, 417)],
    [(498, 498), (419, 419), (614, 617), (436, 436), (422, 422), (439, 439),
     (419, 419), (461, 461), (420, 420), (490, 490), (431, 431), (418, 418),
     (436, 436), (614, 614), (242, 1268), (436, 436), (414, 414), (424, 424),
     (520, 520), (414, 414)],
    [(419, 419), (401, 401), (436, 436), (422, 422), (877, 877), (412, 412),
     (461, 461), (420, 420), (480, 480), (490, 490), (431, 431), (418, 418),
     (436, 436), (460, 460), (436, 436), (414, 414), (424, 424), (419, 419),
     (520, 520), (414, 414)],
]


def _torch_ref(name):
    """A job-shape record of tests/torch_ref/ (written from chip_smoke's
    phases 15-16: the megabase pair's chain dispatches, ten.fasta's DAG
    flushes)."""
    import json
    import os
    with open(os.path.join(os.path.dirname(__file__), "torch_ref",
                           name)) as f:
        return json.load(f)


# the chain jobs of the megabase pair (tests/torch_ref/mbpair.fasta.gz),
# one list of (V1, V2) a dispatch
MBPAIR_JOBS = [[tuple(s) for s in d]
               for d in _torch_ref("mbpair_jobs.json")["dispatches"]]
# the chain jobs of its 25 bonding stitches with -c (mbpair_cyc.cfg), one
# list a dispatch
MBPAIR_CYC_JOBS = [[tuple(s) for s in d]
                   for bond in _torch_ref("mbpair_cyc_jobs.json")["bonding"]
                   for d in bond]


def _port(jobs):
    """The jobs with the JAX package's parameters turned into the port's."""
    return [(s1, s2, swp, params_from_arrays(
        p.match, p.mismatch, np.asarray(p.gap_open), np.asarray(p.gap_extend)))
        for s1, s2, swp, p in jobs]


def _bag():
    rng = np.random.default_rng(3)
    params = AlignmentParams()

    def mkjob(L1, L2, k):
        s1 = rng.integers(0, 4, L1).astype(np.int32)
        s2 = s1[:min(L1, L2)].copy()
        if L2 > len(s2):
            s2 = np.concatenate(
                [s2, rng.integers(0, 4, L2 - len(s2)).astype(np.int32)])
        idx = rng.integers(0, L2, max(1, L2 // 20))
        s2[idx] = (s2[idx] + 1) % 4
        return (s1, s2, k % 5 == 0, params.truncated(1 + k % params.num_pw))

    return ([mkjob(int(rng.integers(90, 127)), int(rng.integers(90, 127)), k)
             for k in range(40)] +
            [mkjob(int(rng.integers(140, 250)), int(rng.integers(140, 250)), k)
             for k in range(12)])


def _check(jobs, results):
    assert len(results) == len(jobs)
    for (s1, s2, swp, p), (aln, score) in zip(jobs, results):
        aln_j, score_j = jax_gotoh_align(s1, s2, p, swap_pref=swp)
        assert score == score_j
        assert aln.dtype == np.int64
        assert np.array_equal(aln, aln_j)


def test_dispatch_fetch_matches_jax():
    jobs = _bag()
    handles = [gc.gotoh_dispatch(_port(jobs[:40]), CPU),
               gc.gotoh_dispatch(_port(jobs[40:]), CPU)]
    results = [r for h in handles for r in gc.gotoh_fetch(h)]
    _check(jobs, results)


def test_dispatch_splits_launches(monkeypatch):
    jobs = _port(_bag()[:20])
    one = gc.gotoh_align_batched(jobs, CPU)
    # a cap of one job's backpointers per launch: one launch per job
    monkeypatch.setattr(gc, "MAX_LAUNCH_BP_BYTES", 1)
    handle = gc.gotoh_dispatch(jobs, CPU)
    assert len(handle) == len(jobs)
    split = gc.gotoh_fetch(handle)
    for (a1, s1), (a2, s2) in zip(one, split):
        assert s1 == s2 and np.array_equal(a1, a2)


def test_counters_count_jobs_not_cpu_launches():
    gc.reset_counters()
    gc.gotoh_align_batched(_port(_bag()[:3]), CPU)
    # launches count kernel launches only; the CPU runs the plain versions
    assert (gc.DISPATCHED_JOBS, gc.FILL_LAUNCHES, gc.TRACEBACK_LAUNCHES) == (3, 0, 0)
    gc.reset_counters()
    assert gc.DISPATCHED_JOBS == 0


def test_params_table_layout():
    rng = np.random.default_rng(1)
    p3 = AlignmentParams(20, 80, (60, 800, 2500), (30, 5, 1))
    jobs = [(rng.integers(0, 4, 7).astype(np.int32),
             rng.integers(0, 4, 5).astype(np.int32), True, p3.truncated(2)),
            (rng.integers(0, 4, 3).astype(np.int32),
             rng.integers(0, 4, 9).astype(np.int32), False, p3)]
    jobs = _port(jobs)
    tab = gc.params_table(jobs)
    assert tab.dtype == torch.int32 and tab.shape == (2, 16)
    # columns 0..4+2npw as the Pallas packed kernels' params rows
    # (gotoh_pallas.py:753-754), zero-padded
    assert tab[0, :10].tolist() == [7, 5, 20, 80, 60, 800, 30, 5, 0, 0]
    assert tab[1, :10].tolist() == [3, 9, 20, 80, 60, 800, 2500, 30, 5, 1]
    # lane_is_i, swap_pref, npw, sequence offset, bp offset (lo, hi)
    assert tab[0, 10:].tolist() == [0, 1, 2, 0, 0, 0]
    assert tab[1, 10:].tolist() == [1, 0, 3, 12, (7 + 5 + 1) * (5 + 1), 0]
    seqs = gc.pack_seqs(jobs)
    assert seqs.dtype == torch.int32
    assert np.array_equal(seqs.numpy(), np.concatenate(
        [jobs[0][0], jobs[0][1], jobs[1][0], jobs[1][1]]))
    bp_size, plan, cap = gc.launch_sizes(jobs)
    assert (bp_size, cap) == (13 * 6 + 13 * 4, 12)
    # one block per job, the most diagonals first
    assert plan.blocks.tolist() == [[0, 0, 1, 1], [1, 0, 1, 1]]


def test_params_table_splits_int64_offset():
    # a job past 2^32 backpointer entries keeps its offset in two words
    p = AlignmentParams()
    big = np.zeros(70000, np.int32)
    jobs = _port([(big, big, False, p), (big[:3], big[:4], False, p)])
    tab = gc.params_table(jobs).numpy().astype(np.int64)
    off = (tab[1, 14] & 0xFFFFFFFF) | (tab[1, 15] << 32)
    assert off == (2 * 70000 + 1) * 70001
    assert off >= 1 << 32


def test_wrappers_reject_other_devices():
    jobs = _port(_bag()[:1])
    table = gc.params_table(jobs).to("meta")
    with pytest.raises(ValueError):
        gc.gotoh_fill(table, gc.pack_seqs(jobs).to("meta"),
                      *gc.launch_sizes(jobs)[:2])


def _edge_shapes():
    """Short sides at the fill's edges (a strip, a warp's 32 R lanes for
    R = 1, 2, 4, 8, the cluster threshold), both orientations."""
    shorts = [0, 1, 2, 31, 32, 33, 63, 65, 127, 129, 255, 257,
              gc.CLUSTER_MIN_LANES, gc.CLUSTER_MIN_LANES + 1, 4096, 4500]
    return [(s, s + 37) if k % 2 else (s + 91, s)
            for k, s in enumerate(shorts)]


@pytest.mark.parametrize("shapes", [PAIR_JOBS, *FIVE_JOBS, *MBPAIR_JOBS,
                                    *MBPAIR_CYC_JOBS,
                                    _edge_shapes(), [(4356, 3330)],
                                    [(7, 5)] * 200, [(5000, 4000)] * 20],
                         ids=["pair", *(f"five{k}" for k in range(5)),
                              *(f"mbpair{k}" for k in range(len(MBPAIR_JOBS))),
                              *(f"mbpair_cyc{k}"
                                for k in range(len(MBPAIR_CYC_JOBS))),
                              "edges", "one_wide", "many_small",
                              "many_wide"])
@pytest.mark.parametrize("cluster_min_lanes", [gc.CLUSTER_MIN_LANES, 0,
                                               10 ** 9],
                         ids=["default", "split_all", "split_none"])
def test_fill_plan_owns_every_lane_once(shapes, cluster_min_lanes):
    """The launch plan of csrc/gotoh.cu's fill, replayed as the kernel
    reads it: every lane of every job is held by exactly one thread, a
    split job holds a whole cluster of at most 8 blocks in rank order, the
    launch fits the card's clusters and shared memory, and the jobs with
    the most diagonals come first."""
    one_block = max(r * n for r, n in gc.FILL_THREADS.items())
    if max(min(a, b) + 1 for a, b in shapes) > one_block and \
            cluster_min_lanes > one_block:
        # a short side past one block's lanes needs a cluster
        with pytest.raises(ValueError):
            gc.fill_plan(shapes, cluster_min_lanes)
        return
    plan = gc.fill_plan(shapes, cluster_min_lanes)
    C, R = plan.cluster, plan.lanes_per_thread
    assert C in (1, gc.CLUSTER) and C <= 8
    assert len(plan.blocks) % C == 0
    assert 32 <= plan.threads <= gc.FILL_THREADS[R]
    assert plan.smem <= MAX_SHARED_BYTES
    assert plan.stage == min(max(max(a, b) for a, b in shapes),
                             gc.STAGE_LABELS)
    if C > 1 and max(min(a, b) + 1 for a, b in shapes) <= one_block:
        assert len(plan.blocks) // C <= gc.MAX_CLUSTERS
    owned = [np.zeros(min(a, b) + 1, int) for a, b in shapes]
    first_block = {}
    for b, (job, rank, group, warps) in enumerate(plan.blocks.tolist()):
        if job < 0:
            continue
        assert 1 <= warps and 32 * warps <= plan.threads
        assert group in (1, C)
        if group > 1:
            assert b % C == rank
        first_block.setdefault(job, b)
        lo = rank * warps * 32 * R
        for t in range(32 * warps):
            owned[job][lo + t * R:lo + (t + 1) * R] += 1
    assert all((o == 1).all() for o in owned)
    # split jobs first, then the rest, each by diagonals, most first
    order = sorted(first_block, key=first_block.get)
    split = [plan.blocks[first_block[k], 2] > 1 for k in order]
    assert split == sorted(split, reverse=True)
    for part in (True, False):
        diag = [sum(shapes[k]) for k, s_ in zip(order, split) if s_ == part]
        assert diag == sorted(diag, reverse=True)


def test_fill_plan_refuses_a_short_side_past_its_blocks():
    with pytest.raises(ValueError):
        gc.fill_plan([(40000, 40000)])


# the DAG jobs benchdata/five.fasta + five.nwk sends to the DAG tier, as
# (V1, V2, K1, K2, S1, S2, npw)
FIVE_DAG_JOBS = [
    (440, 441, 1, 2, 1, 2, 3), (558, 559, 1, 2, 1, 2, 3),
    (440, 441, 1, 2, 1, 2, 3), (1195, 169, 1, 1, 1, 1, 2),
    (417, 416, 2, 1, 2, 1, 2), (1194, 168, 1, 1, 1, 1, 2),
    (1169, 142, 2, 1, 2, 1, 2), (1252, 226, 1, 1, 1, 1, 2),
    (559, 559, 2, 2, 2, 2, 3), (166, 1189, 2, 1, 4, 1, 2),
    (242, 1268, 1, 1, 1, 1, 2), (419, 420, 1, 2, 1, 2, 2),
]


def _dag(rng, V, K, S):
    """A chain of V nodes with, when K = 2, extra edges of span S: in-degree
    K, longest span S."""
    from centrolign_tpu_torch.graph import BaseGraph
    g = BaseGraph()
    g.add_nodes(rng.integers(0, 4, V))
    src = list(range(V - 1))
    dst = list(range(1, V))
    if K == 2:
        src += list(range(0, V - S, 7))
        dst += list(range(S, V, 7))
    g.add_edges(src, dst)
    return g


def _dag_k(rng, V, K, S):
    """A chain of V nodes with, for in-degree K > 1, edges of the K - 1
    spans S, S - 1, ... into every seventh node from S on: in-degree K,
    longest span S (K <= S)."""
    from centrolign_tpu_torch.graph import BaseGraph
    g = BaseGraph()
    g.add_nodes(rng.integers(0, 4, V))
    src = list(range(V - 1))
    dst = list(range(1, V))
    for span in range(S, S - K + 1, -1):
        src += [i - span for i in range(S, V, 7)]
        dst += list(range(S, V, 7))
    g.add_edges(src, dst)
    return g


def _five_dag_jobs():
    return _shaped_dag_jobs(FIVE_DAG_JOBS, _dag)


def _ten_dag_jobs():
    return _shaped_dag_jobs(
        [tuple(j) for flush in _torch_ref("ten_dag_jobs.json")["flushes"]
         for j in flush], _dag_k)


def _shaped_dag_jobs(shapes, make):
    """DAG jobs of the given (V1, V2, K1, K2, S1, S2, npw), the graphs from
    `make(rng, V, K, S)`."""
    import chip_smoke
    rng = np.random.default_rng(4)
    params = params_from_arrays(20, 80, np.array([60, 800, 2500]),
                                np.array([30, 5, 1]))
    jobs = []
    for V1, V2, K1, K2, S1, S2, npw in shapes:
        job = chip_smoke.dag_job(make(rng, V1, K1, S1),
                                 make(rng, V2, K2, S2), params.truncated(npw))
        assert (job.t1.V, job.t2.V, job.t1.K, job.t2.K, job.t1.S,
                job.t2.S) == (V1, V2, K1, K2, S1, S2)
        jobs.append(job)
    return jobs


def _dag_bag():
    import chip_smoke
    params = params_from_arrays(20, 80, np.array([60, 800, 2500]),
                                np.array([30, 5, 1]))
    return chip_smoke.make_dag_bag(np.random.default_rng(20261016), params)[0]


@pytest.mark.parametrize("jobs, in_scratch",
                         [(_five_dag_jobs, 0), (_dag_bag, None),
                          (_ten_dag_jobs,
                           _torch_ref("ten_dag_jobs.json")["in_scratch"])],
                         ids=["five_fasta", "bag", "ten_fasta"])
def test_dag_fill_layout(jobs, in_scratch):
    """csrc/popoa_dag.cu's fill layout, replayed as the kernel derives it:
    each ring plane is as deep as the longest span it is read at, taken
    from the delta rows the kernel reads (M: both graphs; PM, PMk1, D:
    graph 2; I: graph 1); the state (the other side's records, then the
    rings over the short side's lanes) is whole int4s; the launch's shared
    memory stays within what a block has; a job is in global scratch only
    when its state does not fit, and as many jobs are there as on the card
    (`in_scratch`; None: at least one); the block holds the widest job's
    lanes."""
    from centrolign_tpu_torch.ops import popoa_dag as dag
    from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc
    jobs = jobs()
    table, scratch, smem = pdc.dag_job_table(jobs)
    t = dag.job_fields(table)
    data = pdc.pack_dag_jobs(jobs).numpy()
    room = MAX_SHARED_BYTES - pdc.FILL_STATIC_SMEM
    assert smem <= room
    R, threads = pdc.fill_lanes(jobs)
    assert threads % 32 == 0 and threads <= pdc.FILL_THREADS[R]
    off = 0
    for row, job in zip(t, jobs):
        V1, V2, K1, K2 = (int(x) for x in row[[dag.COL_V1, dag.COL_V2,
                                                dag.COL_K1, dag.COL_K2]])
        g1, g2 = int(row[dag.COL_G1]), int(row[dag.COL_G2])
        S1 = int(data[g1 + dag.G1_DELTA * V1:g1 + (dag.G1_DELTA + K1) * V1]
                 .max())
        S2 = int(data[g2 + dag.G2_DELTA * V2:g2 + (dag.G2_DELTA + K2) * V2]
                 .max())
        assert pdc.ring_depths(job) == (max(S1, S2) + 1, S2 + 1, S1 + 1)
        lane, other = pdc.lane_sides(job)
        assert lane.V == min(V1, V2) <= R * threads
        dm, d2, d1 = pdc.ring_depths(job)
        npw = int(row[dag.COL_NPW])
        state = (4 * other.V + (-(-V1 // 4) * 4 if V1 > V2 else 0)
                 + lane.V * (dm + (2 + npw) * d2 + npw * d1))
        assert pdc._ring_ints(job) == -(-state // 4) * 4
        in_smem = 4 * pdc._ring_ints(job) <= room
        scr = int(row[dag.COL_SCRATCH_LO])
        if in_smem:
            assert scr == -1 and 4 * pdc._ring_ints(job) <= smem
        else:
            assert scr == off and scr % 4 == 0
            off += pdc._ring_ints(job)
    assert off == scratch
    n_scratch = int((t[:, dag.COL_SCRATCH_LO] != -1).sum())
    if in_scratch is None:
        assert n_scratch > 0 and scratch > 0
    else:
        assert n_scratch == in_scratch
    if n_scratch == 0:
        assert scratch == 0
        assert max(4 * pdc._ring_ints(j) for j in jobs) == smem


def _replay_traceback(V1, V2, bp_off, bp_size, walk):
    """csrc/popoa_dag.cu's traceback copier (TracebackCopier) replayed
    beside a walk's positions, one round every `every` steps (1, 7 and 60:
    a copier as fast as the walk, or lagging) and whenever the walker would
    wait: every cell and node the walker reads was issued and published
    before the read, no round overwrites an entry the walk may still read,
    a diagonal's window fits a ring row,
    and every chunk stays inside bp with its spare entries."""
    from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc
    for every in (1, 7, 60):
        cop = pdc.TracebackCopier(V1, V2, bp_off, *walk[0])
        for k, (r1, r2) in enumerate(walk):
            d = r1 + r2
            if k % every == 0 or not cop.ready(r1, r2):
                assert cop.round(d, r1) == []
            assert cop.ready(r1, r2)
            assert cop.read(r1, r2) == ((d, cop.base(d) + r1), r1, r2)
        assert 4 * cop.most_chunks <= pdc.TB_COLS
        assert cop.last_entry < bp_size


def _random_walk(rng, t1, t2, r1, r2):
    """Positions of a walk from (r1, r2) by a traceback's moves (diagonal,
    I, D) through real predecessor slots, the longest span half the time,
    until neither side has a predecessor."""
    def back(t, r):
        ds = [int(x) for x in t.delta[:, r] if x > 0]
        if not ds:
            return 0
        return max(ds) if rng.random() < 0.5 else ds[rng.integers(len(ds))]

    walk = []
    while True:
        walk.append((r1, r2))
        a, b = back(t1, r1), back(t2, r2)
        moves = [m for m, ok in (("M", a and b), ("I", a), ("D", b)) if ok]
        if not moves:
            return walk
        m = moves[0] if rng.random() < 0.6 else moves[rng.integers(len(moves))]
        r1 -= a if m in "MI" else 0
        r2 -= b if m in "MD" else 0


def _walk_positions(rows, r1, r2):
    """The positions a traceback's steps started from, from its rows: a
    pair's coordinate is the position's where the step used that side;
    otherwise the side's next used coordinate, or the exit's."""
    from centrolign_tpu_torch.ops.popoa_dag import GAP
    count = int(rows[0, 0])
    steps = rows[len(rows) - count:][::-1]
    walk = np.empty((count, 2), np.int64)
    nxt = [int(rows[1, 0]), int(rows[1, 1])]
    for k in range(count - 1, -1, -1):
        for s in (0, 1):
            if steps[k, s] != GAP:
                nxt[s] = int(steps[k, s])
        walk[k] = nxt
    assert tuple(walk[0]) == (r1, r2)
    return [tuple(int(x) for x in p) for p in walk]


@pytest.fixture(scope="module")
def dag_bag_layout():
    from centrolign_tpu_torch.ops import popoa_dag as dag
    from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc
    jobs = _dag_bag()
    table, _, _ = pdc.dag_job_table(jobs)
    t = dag.job_fields(table)
    return jobs, t[:, dag.COL_BP_LO], dag.launch_sizes(t)[0]


@pytest.fixture(scope="module")
def small_dag_walks():
    """Jobs at the envelope's extremes (in-degree 4 and span 32, a graph of
    one node, one side much longer), through the plain fill and walk."""
    import chip_smoke
    from centrolign_tpu_torch.ops import popoa_dag as dag
    from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc
    rng = np.random.default_rng(11)
    params = params_from_arrays(20, 80, np.array([60, 800, 2500]),
                                np.array([30, 5, 1]))
    shapes = [(150, 4, 32, 0, 0), (1, 1, 1, 0, 200), (1, 1, 1, 200, 0),
              (20, 2, 4, 0, 400), (40, 4, 32, 300, 0)]
    jobs = [chip_smoke.related_dag_job(rng, params.truncated(1 + k % 3), *s)
            for k, s in enumerate(shapes)]
    table, data, (bp_size, _, _, _, cap, _) = pdc.dag_launch(jobs, CPU)
    bp, sinkm = dag.popoa_dag_fill_plain(table, data)
    rows = dag.popoa_dag_traceback_plain(bp, sinkm, table, data, cap).numpy()
    t = dag.job_fields(table)
    walks = []
    for job, row, r in zip(jobs, t, rows):
        best = int(r[2, 1])
        n2 = len(job.sink_pos2)
        walks.append((job.t1.V, job.t2.V, int(row[dag.COL_BP_LO]),
                      _walk_positions(r, int(job.sink_pos1[best // n2]),
                                      int(job.sink_pos2[best % n2]))))
    assert max(job.t1.K for job in jobs) == 4 == max(job.t2.K for job in jobs)
    assert max(job.t1.S for job in jobs) == 32
    return walks, bp_size


@pytest.mark.parametrize("k", range(20))
def test_dag_traceback_window_bag(dag_bag_layout, k):
    """The copier beside random walks over chip_smoke's DAG bag, each job at
    its offset in the bag's launch (the 2400 x 2400 job wraps both delta
    windows)."""
    jobs, offs, bp_size = dag_bag_layout
    assert len(jobs) == 20
    job = jobs[k]
    rng = np.random.default_rng(k)
    walk = _random_walk(rng, job.t1, job.t2, int(job.sink_pos1[-1]),
                        int(job.sink_pos2[-1]))
    _replay_traceback(job.t1.V, job.t2.V, int(offs[k]), bp_size, walk)


@pytest.mark.parametrize("k", range(5), ids=["K4_S32", "V1_1", "V2_1",
                                              "V2_long", "V1_long"])
def test_dag_traceback_window_plain_walk(small_dag_walks, k):
    """The copier beside the plain walk of jobs at the envelope's
    extremes."""
    walks, bp_size = small_dag_walks
    V1, V2, off, walk = walks[k]
    _replay_traceback(V1, V2, off, bp_size, walk)


@pytest.mark.parametrize("V1, V2, K, S", [(5000, 3, 2, 32), (3, 5000, 4, 32),
                                          (3000, 2500, 4, 32)])
def test_dag_traceback_window_wide(V1, V2, K, S):
    """The copier beside random walks on graphs far longer than a delta
    window, at an offset past 2^32 backpointers (the walker's 32-bit ring
    column), with the walk jumping the longest span half the time; the
    traceback's shared memory fits a block."""
    import chip_smoke
    from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc
    from centrolign_tpu_torch.ops.popoa_dag import BP_SPARE, DagTables
    assert pdc.TB_SMEM_BYTES <= MAX_SHARED_BYTES
    assert pdc.TB_NODE_AHEAD < pdc.TB_NODES and pdc.TB_AHEAD < pdc.TB_RING
    rng = np.random.default_rng(V1 + V2)
    t1, t2 = (DagTables(chip_smoke.dag_graph(rng, V, *((K, S) if V > S
                                                         else (1, 1))), [0])
              for V in (V1, V2))
    off = (1 << 32) + 5
    walk = _random_walk(rng, t1, t2, V1 - 1, V2 - 1)
    _replay_traceback(V1, V2, off, off + V1 * V2 + BP_SPARE, walk)

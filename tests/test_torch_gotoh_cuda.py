"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a card. On a machine with one:

    python -m pytest -m cuda tests/test_torch_gotoh_cuda.py -q

Tolerance: exact (integer DP): backpointers, scores and traceback rows of
csrc/gotoh.cu must be bit-equal to ops/gotoh.py's plain fill and host walk.
"""

import numpy as np
import pytest
import torch

from centrolign_tpu_torch.ops import gotoh as plain
from centrolign_tpu_torch.ops import gotoh_cuda as gc
from centrolign_tpu_torch.ops.align_params import AlignmentParams

pytestmark = pytest.mark.cuda

PARAMS = AlignmentParams(20, 80, (60, 800, 2500), (30, 5, 1))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _jobs(rng, n, lo, hi):
    jobs = []
    for k in range(n):
        s1 = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.int32)
        s2 = np.resize(s1, int(rng.integers(lo, hi))).astype(np.int32)
        s2[rng.integers(0, len(s2), max(1, len(s2) // 8))] = rng.integers(0, 4)
        jobs.append((s1, s2, bool(k % 2), PARAMS.truncated(1 + k % 3)))
    return jobs


def _check_launch(card, jobs, plan=None):
    """One fill and one traceback launch over `jobs` (under `plan`, else the
    dispatch's own), bit-equal to the plain fill and host walk."""
    table = gc.params_table(jobs).to(card)
    seqs = gc.pack_seqs(jobs).to(card)
    bp_size, own_plan, cap = gc.launch_sizes(jobs)
    fills, tbs = gc.FILL_LAUNCHES, gc.TRACEBACK_LAUNCHES
    bp, score = gc.gotoh_fill(table, seqs, bp_size, plan or own_plan)
    rows = gc.gotoh_traceback(bp, score, table, cap)
    torch.cuda.synchronize()
    assert (gc.FILL_LAUNCHES, gc.TRACEBACK_LAUNCHES) == (fills + 1, tbs + 1)
    bp_p, score_p = plain.gotoh_fill_plain(table, seqs)
    assert torch.equal(bp.view(torch.int16), bp_p.view(torch.int16))
    assert torch.equal(score, score_p)
    assert torch.equal(rows, plain.gotoh_traceback_plain(bp, score, table, cap))


def _job(rng, V1, V2, swap_pref, npw):
    s1 = rng.integers(0, 4, V1).astype(np.int32)
    s2 = (np.resize(s1, V2) if V1 else rng.integers(0, 4, V2)).astype(np.int32)
    if V2:
        s2[rng.integers(0, V2, max(1, V2 // 8))] = rng.integers(0, 4)
    return (s1, s2, swap_pref, PARAMS.truncated(npw))


@pytest.mark.parametrize("lo,hi", [(1, 40), (100, 600)])
def test_kernels_match_plain(card, lo, hi):
    _check_launch(card, _jobs(np.random.default_rng(lo), 24, lo, hi))


# the fill's edges: short sides around a thread's strip, a warp's lanes
# (32 R for R = 1, 2, 4 and 8) and one past, and over the cluster threshold
@pytest.mark.parametrize("short", [0, 1, 2, 3, 4, 5, 31, 32, 33, 63, 65, 127,
                                   128, 129, 255, 257, gc.CLUSTER_MIN_LANES + 40])
def test_fill_edges_match_plain(card, short):
    """npw 1-3 x lanes along i or j x swap_pref, in one launch."""
    rng = np.random.default_rng(short)
    jobs = []
    for npw in (1, 2, 3):
        for lane_is_i in (True, False):
            for swap_pref in (False, True):
                long = short + int(rng.integers(0, 90))
                V1, V2 = (short, long) if lane_is_i else (long + 1, short)
                jobs.append(_job(rng, V1, V2, swap_pref, npw))
    _check_launch(card, jobs)


@pytest.mark.parametrize("lanes_per_thread", [1, 2, 4, 8])
def test_fill_at_each_strip_width(card, lanes_per_thread):
    """The same jobs with R forced to each width the kernel has."""
    rng = np.random.default_rng(lanes_per_thread)
    jobs = [_job(rng, 300, 257, False, 3), _job(rng, 96, 130, True, 2),
            _job(rng, 7, 3, True, 1)]
    plan = gc.fill_plan([(len(a), len(b)) for a, b, _, _ in jobs])
    threads = 32 * -(-max(min(len(a), len(b)) + 1 for a, b, _, _ in jobs)
                     // (32 * lanes_per_thread))
    warps = [-(-(min(len(a), len(b)) + 1) // (32 * lanes_per_thread))
             for a, b, _, _ in jobs]
    blocks = plan.blocks.copy()
    blocks[:, 3] = [warps[k] for k in blocks[:, 0]]
    smem = gc.MBAR_BYTES + 4 * ((threads // 32) * gc.RING_ENTRIES
                                * gc.RING_SLOT_INTS + plan.stage)
    _check_launch(card, jobs, gc.FillPlan(blocks, 1, lanes_per_thread,
                                          threads, plan.stage, smem))


@pytest.mark.parametrize("split", [False, True], ids=["one_block", "cluster"])
def test_fill_exact_arithmetic(card, split):
    """Penalties large enough that a job's values may leave +-2^20: the
    kernel's exact path, bit-equal all the same."""
    rng = np.random.default_rng(17)
    big = AlignmentParams(2000, 8000, (6000, 80000, 250000), (3000, 500, 100))
    jobs = [(s1, s2, swp, big.truncated(p.num_pw))
            for s1, s2, swp, p in (_job(rng, 400, 350, False, 3),
                                   _job(rng, 280, 300, True, 2),
                                   _job(rng, 1, 60, True, 1))]
    plan = gc.fill_plan([(len(a), len(b)) for a, b, _, _ in jobs],
                        0 if split else 10 ** 9)
    _check_launch(card, jobs, plan)


def test_cluster_job_among_small_jobs(card):
    """One launch: a job split over a cluster, and small jobs packed one
    block each into clusters, some of them left empty."""
    rng = np.random.default_rng(11)
    big = gc.CLUSTER_MIN_LANES + 300
    jobs = [_job(rng, big + 77, big, True, 3)]
    jobs += [_job(rng, int(rng.integers(1, 250)), int(rng.integers(1, 250)),
                  bool(k % 2), 1 + k % 3) for k in range(10)]
    jobs.append(_job(rng, 700, big + 5, False, 2))
    plan = gc.launch_sizes(jobs)[1]
    assert plan.cluster == gc.CLUSTER
    assert sorted(set(plan.blocks[:, 2].tolist())) == [1, gc.CLUSTER]
    _check_launch(card, jobs)


@pytest.mark.parametrize("cluster_min_lanes", [0, 10 ** 9],
                         ids=["clusters", "one_block_per_job"])
def test_fill_under_either_split(card, cluster_min_lanes):
    """The same jobs, every job split or none: the same bits."""
    rng = np.random.default_rng(5)
    jobs = [_job(rng, 1500, 1301, False, 3), _job(rng, 600, 900, True, 2),
            _job(rng, 40, 7, True, 1)]
    plan = gc.fill_plan([(len(a), len(b)) for a, b, _, _ in jobs],
                        cluster_min_lanes)
    assert plan.cluster == (gc.CLUSTER if cluster_min_lanes == 0 else 1)
    _check_launch(card, jobs, plan)


def test_dispatch_on_card_matches_cpu(card):
    jobs = _jobs(np.random.default_rng(7), 12, 50, 300)
    on_card = gc.gotoh_align_batched(jobs, card)
    on_cpu = gc.gotoh_align_batched(jobs, torch.device("cpu"))
    for (a1, s1), (a2, s2) in zip(on_card, on_cpu):
        assert s1 == s2 and np.array_equal(a1, a2)


def test_wrapper_rejects_wrong_dtype(card):
    jobs = _jobs(np.random.default_rng(3), 2, 5, 20)
    table = gc.params_table(jobs).to(card)
    with pytest.raises(ValueError):
        gc.gotoh_fill(table, gc.pack_seqs(jobs).to(card).long(),
                      *gc.launch_sizes(jobs)[:2])


def _runs(rng, lead, body, tail, npw, swap_pref, lane_is_i):
    """A job whose walk holds a pure gap run of `lead` and one of `tail`:
    seq1 carries `lead` extra leading and `tail` extra trailing bases; the
    lanes index i when lane_is_i, else j."""
    core = rng.integers(0, 4, body).astype(np.int32)
    long = np.concatenate([rng.integers(0, 4, lead), core,
                           rng.integers(0, 4, tail)]).astype(np.int32)
    s1, s2 = (core, long) if lane_is_i else (long, core)
    return (s1, s2, swap_pref, PARAMS.truncated(npw))


# the traceback keeps the rows of the 96 diagonals below its walk, 97
# lanes each, in a ring of 128 rows
TRACEBACK_CASES = {
    # walks through the ring many times over, both orientations, npw 1-3
    "long_walks": lambda rng: [_job(rng, 2000, 1900, False, 3),
                               _job(rng, 1500, 2100, True, 2),
                               _job(rng, 3000, 700, True, 1)],
    # short sides below a ring row's lanes
    "narrow": lambda rng: [_job(rng, s, s + 300, bool(s % 2), 1 + s % 3)
                           for s in (1, 2, 7, 31, 63)]
    + [_job(rng, s + 250, s, bool(s % 2), 1 + s % 3) for s in (3, 33, 64)],
    # long pure I and pure D runs: the walk along one lane, or down the
    # lanes one a diagonal
    "gap_runs": lambda rng: [
        _runs(rng, lead, 300, tail, 1 + k % 3, bool(k % 2), lii)
        for k, (lead, tail, lii) in enumerate(
            [(500, 0, True), (500, 0, False), (0, 400, True),
             (0, 400, False), (130, 129, True), (64, 65, False)])],
}


@pytest.mark.parametrize("case", sorted(TRACEBACK_CASES))
def test_traceback_ring_matches_host_walk(card, case):
    """The traceback kernel's walk from its row ring, bit-equal to the host
    walk."""
    _check_launch(card, TRACEBACK_CASES[case](np.random.default_rng(
        len(case))))

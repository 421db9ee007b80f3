"""The port's DAG x DAG CUDA kernels against their plain versions, on the
card.

Marked `cuda`: each test skips without a card. On a machine with one:

    python -m pytest -m cuda tests/test_torch_popoa_dag_cuda.py -q

Tolerance: exact (integer DP): the packed backpointers, the sink M and the
traceback rows of csrc/popoa_dag.cu must be bit-equal to ops/popoa_dag.py's
plain fill and host walk, on chip_smoke.py's bag (in-degree up to 4, span
up to 32, npw 1-3, several sources and sinks, every exit of the walk, a
job with no interior alignment, state in shared memory and in global
scratch, five.fasta's shapes), and on jobs chosen for the fill's layout:
the lanes on graph 1 or graph 2, a short side of one warp or of several,
five.fasta's shapes, and in-degree 4 / span 32 in global scratch (the
2400 x 2400 job's walk wraps the traceback's delta windows); and on jobs
chosen for the traceback: each exit kind, a walk lost on a broken bp,
tied sink pairs, in-degree 1, 2 and 4 with span 1 to 32, graphs longer
than the shared memory's delta words, and more jobs than SMs.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from centrolign_tpu_torch.ops import popoa_dag as plain
from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc
from centrolign_tpu_torch.ops.align_params import AlignmentParams

pytestmark = pytest.mark.cuda

PARAMS = AlignmentParams(20, 80, (60, 800, 2500), (30, 5, 1))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _check_launch(card, jobs, smem_limit=pdc.SMEM_LIMIT):
    """One fill and one traceback launch over `jobs`, bit-equal to the plain
    fill and host walk. Returns the traceback rows."""
    table, scratch, smem = pdc.dag_job_table(jobs, smem_limit)
    bp_size, sm_size, cap = plain.launch_sizes(plain.job_fields(table))
    table = table.to(card)
    data = pdc.pack_dag_jobs(jobs).to(card)
    fills, tbs = pdc.FILL_LAUNCHES, pdc.TRACEBACK_LAUNCHES
    bp, sinkm = pdc.popoa_dag_fill(table, data, bp_size, sm_size, scratch,
                                   smem, pdc.fill_lanes(jobs))
    rows = pdc.popoa_dag_traceback(bp, sinkm, table, data, cap)
    torch.cuda.synchronize()
    assert (pdc.FILL_LAUNCHES, pdc.TRACEBACK_LAUNCHES) == (fills + 1, tbs + 1)
    bp_p, sinkm_p = plain.popoa_dag_fill_plain(table, data)
    assert torch.equal(bp, bp_p)
    assert torch.equal(sinkm, sinkm_p)
    rows_p = plain.popoa_dag_traceback_plain(bp, sinkm, table, data, cap)
    assert torch.equal(rows, rows_p)
    return rows


def test_kernels_match_plain_on_the_bag(card):
    jobs, _ = chip_smoke.make_dag_bag(np.random.default_rng(5), PARAMS)
    rows = _check_launch(card, jobs)
    exits = set(rows[:, 0, 1].tolist())
    assert {1, 2, 3, 4} <= exits


# (V, K, S, lead1, lead2): graph 1 has V + lead1 nodes, graph 2 V + lead2;
# the fill's lanes run along the shorter graph
LAYOUT_CASES = {
    "lanes_on_graph1": [(300, 2, 8, 0, 90), (200, 4, 32, 0, 1)],
    "lanes_on_graph2": [(300, 2, 8, 90, 0), (200, 4, 32, 1, 0)],
    "one_warp": [(20, 2, 4, 0, 300), (31, 3, 8, 250, 0), (1, 1, 1, 40, 0)],
    "several_warps": [(33, 2, 4, 0, 200), (130, 4, 32, 70, 0)],
    "five_fasta": [(440, 2, 2, 0, 1), (558, 2, 2, 0, 1), (169, 1, 1, 1026, 0),
                   (416, 2, 2, 1, 0), (142, 2, 2, 1027, 0),
                   (226, 1, 1, 1026, 0), (166, 2, 4, 0, 1023),
                   (242, 1, 1, 0, 1026)],
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_fill_layout_matches_plain(card, case):
    """Jobs chosen for where the fill's lanes run and how many warps hold
    them, npw 1-3, in one launch."""
    rng = np.random.default_rng(len(case))
    jobs = [chip_smoke.related_dag_job(rng, PARAMS.truncated(1 + k % 3), *c)
            for k, c in enumerate(LAYOUT_CASES[case])]
    _check_launch(card, jobs)


@pytest.mark.parametrize("V", [700, 2400])
def test_fill_in_global_scratch(card, V):
    """In-degree 4 and span 32: state too large for shared memory (and, at
    V = 700, the same job forced there by a zero limit)."""
    rng = np.random.default_rng(V)
    job = chip_smoke.related_dag_job(rng, PARAMS, V, 4, 32, 0, 0)
    assert max(job.t1.K, job.t2.K) == 4
    assert max(job.t1.S, job.t2.S) == 32
    _check_launch(card, [job], smem_limit=0 if V == 700 else pdc.SMEM_LIMIT)


def test_batch_on_card_matches_cpu(card):
    jobs, _ = chip_smoke.make_dag_bag(np.random.default_rng(6), PARAMS)
    jobs = [j for j in jobs if j.t1.V < 1000]
    on_card = plain.popoa_dag_batch(jobs, card)
    on_cpu = plain.popoa_dag_batch(jobs, torch.device("cpu"))
    for a, b in zip(on_card, on_cpu):
        assert (a is None) == (b is None)
        if a is not None:
            assert a[1] == b[1] and np.array_equal(a[0], b[0])


def test_single_entry_matches_plain(card):
    from centrolign_tpu_torch.ops.gotoh_cuda import gotoh_align_device
    rng = np.random.default_rng(8)
    for L1, L2 in ((40, 70), (4200, 4150)):
        s1 = rng.integers(0, 4, L1).astype(np.int32)
        s2 = np.resize(s1, L2).astype(np.int32)
        s2[rng.integers(0, L2, L2 // 9)] = rng.integers(0, 4)
        a, sa = gotoh_align_device(s1, s2, PARAMS, device=card)
        b, sb = gotoh_align_device(s1, s2, PARAMS, device=torch.device("cpu"))
        assert sa == sb and np.array_equal(a, b)


def test_device_memory_is_logged_after_a_launch(card):
    from centrolign_tpu_torch.utils.memory import device_memory_usage
    jobs, _ = chip_smoke.make_dag_bag(np.random.default_rng(9), PARAMS)
    plain.popoa_dag_batch(jobs[:3], card)
    assert device_memory_usage() == torch.cuda.max_memory_allocated() > 0


def _check_traceback(card, jobs, bp=None, sinkm=None):
    """The traceback kernel over `jobs` (on the card fill's bp and sink M,
    or on the `bp` / `sinkm` given) bit-equal to the host walk. Returns
    the rows."""
    table, data, (bp_size, sm_size, scratch, smem, cap, lanes) = \
        pdc.dag_launch(jobs, card)
    if bp is None:
        bp, sinkm_k = pdc.popoa_dag_fill(table, data, bp_size, sm_size,
                                         scratch, smem, lanes)
        sinkm = sinkm_k if sinkm is None else sinkm
    tbs = pdc.TRACEBACK_LAUNCHES
    rows = pdc.popoa_dag_traceback(bp, sinkm, table, data, cap)
    torch.cuda.synchronize()
    assert pdc.TRACEBACK_LAUNCHES == tbs + 1
    assert torch.equal(rows, plain.popoa_dag_traceback_plain(
        bp, sinkm, table, data, cap))
    return rows


# (V, K, S, lead1, lead2) of related jobs that leave through each exit
EXIT_CASES = {1: (120, 2, 8, 0, 60), 2: (120, 2, 8, 60, 0),
              3: (120, 2, 8, 0, 0)}


@pytest.mark.parametrize("kind", [1, 2, 3, 4],
                         ids=["row", "column", "corner", "no_alignment"])
def test_traceback_exit_kinds(card, kind):
    rng = np.random.default_rng(kind)
    if kind == 4:
        jobs, what = chip_smoke.make_dag_bag(rng, PARAMS)
        jobs = [j for j, w in zip(jobs, what) if "no interior" in w]
    else:
        jobs = [chip_smoke.related_dag_job(rng, PARAMS, *EXIT_CASES[kind])
                for _ in range(4)]
    rows = _check_traceback(card, jobs)
    assert kind in set(rows[:, 0, 1].tolist())


def test_traceback_lost_on_a_broken_bp(card):
    """Every cell says "I piece 0, extend from slot 1": the walk stalls on
    the first node whose slot 1 has no predecessor and never exits."""
    rng = np.random.default_rng(21)
    jobs = [chip_smoke.related_dag_job(rng, PARAMS, 150, 2, 8, 0, 0)
            for _ in range(3)]
    table, data, (bp_size, sm_size, scratch, smem, cap, lanes) = \
        pdc.dag_launch(jobs, card)
    _, sinkm = pdc.popoa_dag_fill(table, data, bp_size, sm_size, scratch,
                                  smem, lanes)
    bp = torch.full((bp_size,), 1 + (1 << 8), dtype=torch.int32,
                    device=card)
    rows = _check_traceback(card, jobs, bp, sinkm)
    assert set(rows[:, 0, 1].tolist()) == {5}


def test_traceback_tied_sink_pairs(card):
    """Nine sinks on each side (81 pairs, more than the block's threads)
    whose M take two values: the first best pair, s1-major, must win."""
    rng = np.random.default_rng(22)
    jobs = [chip_smoke.related_dag_job(rng, PARAMS, 200, 2, 8, 0, 0,
                                       n_src=1, n_sink=n)
            for n in (3, 9, 9)]
    assert all(len(j.sink_pos1) >= 3 and len(j.sink_pos2) >= 3
               for j in jobs)
    table, data, (bp_size, sm_size, scratch, smem, cap, lanes) = \
        pdc.dag_launch(jobs, card)
    bp, sinkm = pdc.popoa_dag_fill(table, data, bp_size, sm_size, scratch,
                                   smem, lanes)
    tied = torch.from_numpy(rng.choice([-7, 40], sm_size).astype(np.int32))
    rows = _check_traceback(card, jobs, bp, tied.to(card))
    assert (rows[:, 2, 0] == 40).all()


@pytest.mark.parametrize("K, S", [(1, 1), (2, 2), (2, 32), (4, 4), (4, 32)])
def test_traceback_in_degree_and_span(card, K, S):
    rng = np.random.default_rng(K * 100 + S)
    jobs = [chip_smoke.related_dag_job(rng, PARAMS.truncated(1 + k % 3), 250,
                                       K, S, *lead)
            for k, lead in enumerate([(0, 0), (40, 0), (0, 40)])]
    assert max(max(j.t1.K, j.t2.K) for j in jobs) == K
    assert max(max(j.t1.S, j.t2.S) for j in jobs) == S
    _check_traceback(card, jobs)


def _chain(rng, V, skip):
    """A chain of V nodes with an edge of span `skip` every fifth node."""
    from centrolign_tpu_torch.graph import BaseGraph
    g = BaseGraph()
    g.add_nodes(rng.integers(0, 4, V))
    g.add_edges(list(range(V - 1)) + list(range(0, V - skip, 5)),
                list(range(1, V)) + list(range(skip, V, 5)))
    return g


def test_traceback_past_the_shared_delta_words(card):
    """Graphs of 60,000 nodes, whose delta words (V1 + V2 of them) exceed
    a block's shared memory, beside 40-node graphs, both ways round. The
    plain fill of so many diagonals is too slow, so the kernel's bp is
    walked by both."""
    rng = np.random.default_rng(23)
    jobs = [chip_smoke.dag_job(_chain(rng, a, 8), _chain(rng, b, 8), PARAMS)
            for a, b in ((60000, 40), (40, 60000))]
    assert all(4 * (j.t1.V + j.t2.V) > pdc.SMEM_LIMIT for j in jobs)
    _check_traceback(card, jobs)


def test_traceback_more_jobs_than_sms(card):
    rng = np.random.default_rng(24)
    jobs = [chip_smoke.related_dag_job(
        rng, PARAMS.truncated(1 + k % 3), int(rng.integers(20, 60)),
        1 + k % 4, [1, 2, 8, 4][k % 4], *[(0, 0), (10, 0), (0, 10)][k % 3])
        for k in range(300)]
    rows = _check_launch(card, jobs)
    assert len(rows) == 300

"""The port's DAG x DAG PO-POA against the JAX package.

The port's plain fill and traceback (ops/popoa_dag.py, through the
dispatch layer on CPU tensors) must give the alignment and the score of
the JAX package's popoa_dag_device / popoa_dag_batch (jax on the CPU) and
of ops/popoa_ref.popoa, and the packed backpointer of every in-matrix cell
must equal the JAX fill's (_fill_scan). Tolerance: exact, integer DP.

Graphs come from tests/util.py's generators and are copied into the
port's BaseGraph with the same node ids and edge order (the adjacency
order decides ties).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centrolign_tpu.graph import BaseGraph as JaxGraph
from centrolign_tpu.ops import popoa_dag as jax_dag
from centrolign_tpu.ops.align_params import AlignmentParams
from centrolign_tpu.ops.popoa_ref import popoa
from centrolign_tpu_torch import metrics
from centrolign_tpu_torch.extractor import SubGraphInfo
from centrolign_tpu_torch.graph import BaseGraph
from centrolign_tpu_torch.ops import popoa_dag as torch_dag
from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc
from centrolign_tpu_torch.ops.align_params import params_from_arrays
from centrolign_tpu_torch.stitcher import Stitcher

from util import graph_sinks, graph_sources, random_chain, random_dag

PARAMS = [
    AlignmentParams(20, 80, (60, 800, 2500), (30, 5, 1)),
    AlignmentParams(1, 1, (1,), (1,)),
    AlignmentParams(2, 3, (4, 1), (2, 5)),
]
CPU = torch.device("cpu")


def _port_params(p):
    return params_from_arrays(p.match, p.mismatch, np.asarray(p.gap_open),
                              np.asarray(p.gap_extend))


def _port_graph(g):
    """The port's BaseGraph with g's node ids, labels and edge order."""
    out = BaseGraph()
    out.add_nodes(g.labels)
    out.add_edges(*g.edges())
    return out


def _check_cases(cases, min_ran):
    """Every case the port admits goes through one port batch (one plain
    fill and traceback) and must equal popoa_ref and the JAX kernel."""
    jobs, want = [], []
    for g1, g2, s1, s2, k1, k2, params in cases:
        job = torch_dag._DagJob(_port_graph(g1), _port_graph(g2), s1, s2,
                                k1, k2, _port_params(params))
        if not job.eligible:
            continue
        job.prepare()
        jobs.append(job)
        ref = popoa(g1, g2, s1, s2, k1, k2, params)
        with jax.default_device(jax.devices("cpu")[0]):
            dev = jax_dag.popoa_dag_device(g1, g2, s1, s2, k1, k2, params)
        assert dev is not None
        assert dev[1] == ref[1] and np.array_equal(dev[0], ref[0])
        want.append(ref)
    assert len(jobs) >= min_ran, f"only {len(jobs)} eligible draws"
    got = torch_dag.popoa_dag_batch(jobs, CPU)
    for (aln, score), g in zip(want, got):
        assert g is not None
        assert g[1] == score
        assert g[0].dtype == np.int64
        assert np.array_equal(g[0], aln)


@pytest.mark.parametrize("params", PARAMS,
                         ids=lambda p: f"{p.match}-{p.mismatch}-npw{p.num_pw}")
def test_random_dags(params):
    rng = np.random.default_rng(7000 + params.num_pw)
    cases = []
    for _ in range(12):
        g1 = random_dag(rng, int(rng.integers(4, 30)))
        g2 = random_dag(rng, int(rng.integers(4, 30)))
        cases.append((g1, g2, graph_sources(g1), graph_sources(g2),
                      graph_sinks(g1), graph_sinks(g2), params))
    _check_cases(cases, 4)


@pytest.mark.parametrize("params", PARAMS,
                         ids=lambda p: f"{p.match}-{p.mismatch}-npw{p.num_pw}")
def test_chains(params):
    rng = np.random.default_rng(81 + params.num_pw)
    cases = []
    for _ in range(3):
        g1 = random_chain(rng, int(rng.integers(5, 80)))
        g2 = random_chain(rng, int(rng.integers(5, 80)))
        cases.append((g1, g2, graph_sources(g1), graph_sources(g2),
                      graph_sinks(g1), graph_sinks(g2), params))
    _check_cases(cases, 3)


def test_subset_sources_sinks():
    # sources/sinks that are strict subsets of the graph's degree-0 nodes,
    # like stitcher extractions produce
    rng = np.random.default_rng(4242)
    cases = []
    for _ in range(10):
        g1 = random_dag(rng, int(rng.integers(6, 25)))
        g2 = random_dag(rng, int(rng.integers(6, 25)))
        s1, s2 = graph_sources(g1), graph_sources(g2)
        k1, k2 = graph_sinks(g1), graph_sinks(g2)
        cases.append((g1, g2, s1[:max(1, len(s1) - 1)], s2, k1,
                      k2[:max(1, len(k2) - 1)], PARAMS[0]))
    _check_cases(cases, 3)


@pytest.mark.parametrize("params", PARAMS,
                         ids=lambda p: f"{p.match}-{p.mismatch}-npw{p.num_pw}")
def test_identical_graphs_tie_heavy(params):
    # identical low-entropy graphs maximize score ties: the tie-rule
    # encoding must still match the oracle exactly
    rng = np.random.default_rng(99 + params.num_pw)
    cases = []
    for _ in range(4):
        g = random_dag(rng, 20)
        for v, lab in enumerate(rng.integers(0, 2, g.node_size)):
            g.relabel(v, int(lab))
        s, k = graph_sources(g), graph_sinks(g)
        cases.append((g, g, s, s, k, k, params))
    _check_cases(cases, 4)


@pytest.mark.parametrize("params", PARAMS,
                         ids=lambda p: f"{p.match}-{p.mismatch}-npw{p.num_pw}")
def test_fill_backpointers_match_jax_fill(params):
    """Every in-matrix packed backpointer and the M at every sink pair equal
    the JAX fill's, cell for cell."""
    rng = np.random.default_rng(515 + params.num_pw)
    ran = 0
    for _ in range(6):
        g1 = random_dag(rng, int(rng.integers(5, 40)), 0.3)
        g2 = random_dag(rng, int(rng.integers(5, 40)), 0.3)
        s1, s2 = graph_sources(g1), graph_sources(g2)
        k1, k2 = graph_sinks(g1), graph_sinks(g2)
        job = torch_dag._DagJob(_port_graph(g1), _port_graph(g2), s1, s2,
                                k1, k2, _port_params(params))
        if not job.eligible:
            continue
        ran += 1
        job.prepare()
        table, _, _ = pdc.dag_job_table([job])
        bp, sinkm = torch_dag.popoa_dag_fill_plain(table, pdc.pack_dag_jobs(
            [job]))
        jj = jax_dag._DagJob(g1, g2, s1, s2, k1, k2, params)
        jj.prepare()
        W, D, _, K1, K2, S1, S2, R, npw = jj.bucket[:9]
        a = [jnp.asarray(x) for x in jj.arrays]
        with jax.default_device(jax.devices("cpu")[0]):
            jbp, jM = jax_dag._fill_scan(
                *a[:10], jnp.int32(jj.t1.V), jnp.int32(jj.t2.V),
                jnp.int32(params.match), jnp.int32(params.mismatch),
                jnp.asarray(params.gap_open, jnp.int32),
                jnp.asarray(params.gap_extend, jnp.int32),
                W=W, D=D, K1=K1, K2=K2, S1=S1, S2=S2, npw=npw, R=R)
        jbp, jM = np.asarray(jbp), np.asarray(jM)
        V1, V2 = job.t1.V, job.t2.V
        r1, r2 = np.divmod(np.arange(V1 * V2), V2)
        idx = torch_dag.cell_index(V1, V2, r1, r2)
        assert np.array_equal(np.sort(idx), np.arange(V1 * V2))
        assert np.array_equal(bp.numpy()[idx], jbp[r1 + r2, r1])
        p1 = np.repeat(job.sink_pos1, len(job.sink_pos2))
        p2 = np.tile(job.sink_pos2, len(job.sink_pos1))
        assert np.array_equal(sinkm.numpy(), jM[p1 + p2, p1])
    assert ran >= 3


def _fan(width, length=6):
    """A source, `width` parallel nodes, then a node with `width`
    predecessors and a short tail: in-degree `width`."""
    g = BaseGraph()
    g.add_nodes(np.arange(width + length + 1) % 4)
    hub = width + 1
    for v in range(1, width + 1):
        g.add_edge(0, v)
        g.add_edge(v, hub)
    for v in range(hub, hub + length - 1):
        g.add_edge(v, v + 1)
    return g


def _jax_graph(g):
    out = JaxGraph()
    out.add_nodes(g.labels)
    out.add_edges(*g.edges())
    return out


@pytest.mark.parametrize("width", [5, 6])
def test_fan_beyond_envelope_goes_to_host_po(width):
    """In-degree 5 or more is outside the port's envelope (the base-5
    predecessor digits cannot hold slot 5): the port declines the job, and
    the stitcher's alignment of the gap is then popoa_ref's."""
    g1, g2 = _fan(width), _fan(width)
    g2.relabel(3, (int(g2.labels[3]) + 1) % 4)
    src, snk = [0], [g1.node_size - 1]
    pj = PARAMS[0]
    params = _port_params(pj)
    job = torch_dag._DagJob(g1, g2, src, src, snk, snk, params)
    assert job.t1.K == width and not job.eligible
    assert torch_dag.popoa_dag_device(g1, g2, src, src, snk, snk, params,
                                      CPU) is None

    metrics.reset()
    st = Stitcher(device=CPU)
    st.device_dag, st.device_min_cells = True, 1
    ex1 = SubGraphInfo(g1, list(range(g1.node_size)), src, snk)
    ex2 = SubGraphInfo(g2, list(range(g2.node_size)), src, snk)
    pending = st._po_poa(ex1, ex2, params)
    assert pending.kind == "host"
    assert metrics.counters["po_dagfb"][0] == 1
    aln = pending.finish(pending.job())
    want, _ = popoa(_jax_graph(g1), _jax_graph(g2), src, src, snk, snk, pj)
    assert np.array_equal(aln, want)


def test_fan_inside_envelope():
    # in-degree 4 is inside the envelope and exact
    g1, g2 = _fan(4), _fan(4)
    g2.relabel(2, (int(g2.labels[2]) + 2) % 4)
    src, snk = [0], [g1.node_size - 1]
    _check_cases([(_jax_graph(g1), _jax_graph(g2), src, src, snk, snk,
                   PARAMS[0])], 1)


def test_no_interior_alignment_returns_none():
    """A graph-1 source and sink in different components: no sink pair is
    reached, the traceback reports it, and the stitcher realigns the gap
    on the host (the JAX package's rule)."""
    rng = np.random.default_rng(3)
    g1 = random_chain(rng, 30)
    g1.remove_edge(14, 15)
    g2 = random_dag(rng, 20)
    args = (_port_graph(g1), _port_graph(g2), [0], graph_sources(g2), [29],
            graph_sinks(g2))
    params = _port_params(PARAMS[0])
    with jax.default_device(jax.devices("cpu")[0]):
        assert jax_dag.popoa_dag_device(g1, g2, *args[2:], PARAMS[0]) is None
    assert torch_dag.popoa_dag_device(*args, params, CPU) is None
    job = torch_dag._DagJob(*args, params)
    job.prepare()
    rows = pdc.popoa_dag_align_jobs([job], CPU)[0]
    assert rows[0, 1] == torch_dag._EXIT_NO_ALIGNMENT
    assert rows[2, 0] <= torch_dag._NEG_HALF


def _jobs(seed, n):
    rng = np.random.default_rng(seed)
    jobs = []
    while len(jobs) < n:
        g1 = _port_graph(random_dag(rng, int(rng.integers(4, 30))))
        g2 = _port_graph(random_dag(rng, int(rng.integers(4, 30))))
        job = torch_dag._DagJob(
            g1, g2, graph_sources(g1), graph_sources(g2), graph_sinks(g1),
            graph_sinks(g2), _port_params(PARAMS[len(jobs) % 3]))
        if job.eligible:
            job.prepare()
            jobs.append(job)
    return jobs


def test_table_layout():
    jobs = _jobs(11, 3)
    tab, scratch, smem = pdc.dag_job_table(jobs, smem_limit=1 << 30)
    assert tab.dtype == torch.int32 and tab.shape == (3, torch_dag.N_COLS)
    t = torch_dag.job_fields(tab)
    data = pdc.pack_dag_jobs(jobs).numpy()
    off = 0
    for row, job in zip(t, jobs):
        V1, V2 = job.t1.V, job.t2.V
        K1, K2 = job.t1.delta.shape[0], job.t2.delta.shape[0]
        assert list(row[:6]) == [V1, V2, K1, K2, job.ring, job.params.num_pw]
        assert row[torch_dag.COL_G1] == off
        g1 = data[off:off + (6 + K1) * V1].reshape(6 + K1, V1)
        assert np.array_equal(g1[torch_dag.G1_LAB], job.t1.labels)
        assert np.array_equal(g1[torch_dag.G1_BCOLM], job.bcol_M)
        assert np.array_equal(g1[torch_dag.G1_DELTA:], job.t1.delta)
        off += (6 + K1) * V1
        assert row[torch_dag.COL_G2] == off
        g2 = data[off:off + (4 + K2) * V2].reshape(4 + K2, V2)
        assert np.array_equal(g2[torch_dag.G2_BROWM], job.brow_M)
        sinks2 = np.flatnonzero(g2[torch_dag.G2_SINK] >= 0)
        assert np.array_equal(np.sort(sinks2), np.sort(job.sink_pos2))
        off += (4 + K2) * V2
        n1, n2 = len(job.sink_pos1), len(job.sink_pos2)
        assert np.array_equal(data[off:off + n1], job.sink_pos1)
        off += n1 + n2
        assert row[torch_dag.COL_SCRATCH_LO] == -1   # in shared memory
    assert off == len(data) and scratch == 0
    assert smem == max(4 * pdc._ring_ints(j) for j in jobs)
    assert list(t[:, torch_dag.COL_BP_LO]) == [
        0, jobs[0].cells, jobs[0].cells + jobs[1].cells]


def test_scratch_placement_does_not_change_results():
    jobs = _jobs(12, 4)
    shared, scratch, _ = pdc.dag_job_table(jobs)
    spilled, n_scratch, smem = pdc.dag_job_table(jobs, smem_limit=0)
    assert n_scratch == sum(pdc._ring_ints(j) for j in jobs) and smem == 0
    offs = torch_dag.job_fields(spilled)[:, torch_dag.COL_SCRATCH_LO]
    assert list(offs) == list(np.cumsum([0] + [pdc._ring_ints(j)
                                               for j in jobs[:-1]]))
    data = pdc.pack_dag_jobs(jobs)
    a = torch_dag.popoa_dag_fill_plain(shared, data)
    b = torch_dag.popoa_dag_fill_plain(spilled, data)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_diag_offset_enumerates_cells():
    for V1, V2 in [(1, 1), (1, 7), (7, 1), (5, 9), (9, 5), (6, 6)]:
        seen = []
        for d in range(V1 + V2 - 1):
            lo, hi = max(0, d - V2 + 1), min(d, V1 - 1)
            assert torch_dag.diag_offset(V1, V2, d) == len(seen)
            seen += [torch_dag.cell_index(V1, V2, r1, d - r1)
                     for r1 in range(lo, hi + 1)]
        assert seen == list(range(V1 * V2))


def test_one_batch_counts_jobs_not_cpu_launches():
    pdc.reset_counters()
    jobs = _jobs(13, 5)
    got = torch_dag.popoa_dag_batch(jobs, CPU)
    assert len(got) == 5 and all(g is not None for g in got)
    assert (pdc.DISPATCHED_JOBS, pdc.FILL_LAUNCHES,
            pdc.TRACEBACK_LAUNCHES) == (5, 0, 0)


def test_wrappers_reject_other_devices():
    jobs = _jobs(14, 1)
    table, scratch, smem = pdc.dag_job_table(jobs)
    data = pdc.pack_dag_jobs(jobs)
    bp_size, sm_size, cap = torch_dag.launch_sizes(
        torch_dag.job_fields(table))
    with pytest.raises(ValueError):
        pdc.popoa_dag_fill(table.to("meta"), data.to("meta"), bp_size,
                           sm_size, scratch, smem)
    bp, sinkm = pdc.popoa_dag_fill(table, data, bp_size, sm_size, scratch,
                                   smem)
    with pytest.raises(ValueError):
        pdc.popoa_dag_traceback(bp, sinkm, table, data, cap - 1)


def test_gap_penalty_guard():
    jobs = _jobs(15, 1)
    jobs[0].params = params_from_arrays(1, 1, [1 << 28], [1])
    with pytest.raises(ValueError):
        pdc.dag_job_table(jobs)


def _chain_graph(rng, V):
    g = BaseGraph()
    ids = g.add_nodes(rng.integers(0, 4, V))
    g.add_edges(ids[:-1], ids[1:])
    return g


def test_eligible_only_what_a_launch_accepts():
    """A job is eligible only if fill_lanes and dag_job_table take it
    alone: a short side of MAX_LANES is, one lane more is not (a 67 M-cell
    gap, never filled here), nor gap penalties of 2^28, nor sink pairs
    past 2^31 entries; the stitcher then aligns it on host `po`."""
    from centrolign_tpu_torch.ops.align_params import AlignmentParams as P
    rng = np.random.default_rng(2028)
    params = _port_params(PARAMS[0])
    wide = pdc.MAX_LANES

    def job(V1, V2, p=params, sinks1=None, sinks2=None):
        g1, g2 = _chain_graph(rng, V1), _chain_graph(rng, V2)
        return torch_dag._DagJob(g1, g2, [0], [0], sinks1 or [V1 - 1],
                                 sinks2 or [V2 - 1], p)

    fits = job(wide + 7, wide)
    assert wide == 8192 and fits.eligible
    assert pdc.fill_lanes([fits]) == (8, 1024)
    too_wide = job(wide + 1, wide + 3)
    assert not too_wide.eligible
    with pytest.raises(ValueError, match="at most 8192 lanes"):
        pdc.fill_lanes([too_wide])

    steep = job(40, 50, P(2, 3, (1 << 28, 5), (1, 1)))
    assert steep.t1.eligible and steep.t2.eligible and not steep.eligible
    steep.prepare()
    with pytest.raises(ValueError, match="2\\^28"):
        pdc.dag_job_table([steep])
    assert job(40, 50, P(2, 3, ((1 << 28) - 2, 5), (1, 1))).eligible

    # 262,145 x 8,192 sink pairs: more sink-M entries than 2^31
    V1 = (1 << 31) // wide + 1
    many = job(V1, wide, sinks1=list(range(V1)), sinks2=list(range(wide)))
    assert many.t1.eligible and many.t2.eligible and not many.eligible
    assert pdc.launchable(job(V1 - 2, wide, sinks1=list(range(V1 - 2)),
                              sinks2=list(range(wide))))


def test_launch_groups_stay_under_a_launchs_entries():
    """A flush of jobs that each fit a launch is cut, in order, into
    launches that each stay below dag_job_table's 2^31 data and sink-M
    entries: four jobs of 30,000 x 30,000 sink pairs take two launches,
    small jobs one (no fill: launch_groups reads only the sizes)."""
    from types import SimpleNamespace as NS

    def sized(V, n1, n2):
        t = NS(V=V, delta=np.zeros((2, V), np.int32))
        return NS(t1=t, t2=t, sink_pos1=np.arange(n1),
                  sink_pos2=np.arange(n2))

    big = [sized(40_000, 30_000, 30_000) for _ in range(4)]
    groups = pdc.launch_groups(big)
    assert [len(g) for g in groups] == [2, 2]
    assert [j for g in groups for j in g] == big
    for g in groups:
        entries = [pdc._launch_entries(j, len(j.sink_pos1),
                                       len(j.sink_pos2)) for j in g]
        assert all(sum(col) < 1 << 31 for col in zip(*entries))
    small = [sized(100, 3, 3) for _ in range(5)]
    assert pdc.launch_groups(small) == [small]
    assert pdc.launch_groups([]) == []
    assert pdc.popoa_dag_align_jobs([], CPU) == []

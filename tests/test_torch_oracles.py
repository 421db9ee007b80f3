"""The port's two test oracles against the JAX package's.

ops/popoa_ref.py (the numpy PO-POA oracle: popoa_fill, popoa_traceback,
popoa) must give the JAX package's M, I and D matrices, alignment and
score on the same seeded graphs (random DAGs and chains, and fans of
in-degree 4-7, beyond the DAG kernel's envelope, whose gaps the stitcher
sends to popoa_ref), and agree with the port's native popoa.cpp; determinize.py (determinize, translate_tableau, rewalk_paths)
must build the JAX package's graph, tableau and paths from the inputs of
tests/test_gesa.py's determinize tests. Tolerance: exact (integer DP and
graph construction).
"""

import numpy as np
import pytest

from centrolign_tpu import determinize as jax_det
from centrolign_tpu.graph import BaseGraph as JaxGraph
from centrolign_tpu.modify_graph import add_sentinels
from centrolign_tpu.ops import popoa_ref as jax_ref
from centrolign_tpu.ops.align_params import AlignmentParams
from centrolign_tpu_torch import determinize as torch_det
from centrolign_tpu_torch import native
from centrolign_tpu_torch.graph import BaseGraph
from centrolign_tpu_torch.modify_graph import SentinelTableau
from centrolign_tpu_torch.ops import popoa_ref as torch_ref
from centrolign_tpu_torch.ops.align_params import params_from_arrays

from util import graph_sinks, graph_sources, random_chain, random_dag

PARAMS = [
    AlignmentParams(20, 80, (60, 800, 2500), (30, 5, 1)),
    AlignmentParams(1, 1, (1,), (1,)),
    AlignmentParams(2, 3, (4, 1), (2, 5)),
]


def _port_graph(g):
    """The port's BaseGraph with g's node ids, labels, edge order and
    paths."""
    out = BaseGraph()
    out.add_nodes(g.labels)
    out.add_edges(*g.edges())
    for pid in range(g.path_size):
        out.extend_path_array(out.add_path(g.path_name(pid)), g.path(pid))
    return out


def _port_params(p):
    return params_from_arrays(p.match, p.mismatch, np.asarray(p.gap_open),
                              np.asarray(p.gap_extend))


def _fan(rng, width):
    """A source, `width` parallel nodes, a node with `width` predecessors
    and a short tail, seeded labels."""
    g = JaxGraph()
    length = int(rng.integers(2, 8))
    g.add_nodes(rng.integers(0, 4, width + length + 1))
    hub = width + 1
    for v in range(1, width + 1):
        g.add_edge(0, v)
        g.add_edge(v, hub)
    for v in range(hub, hub + length - 1):
        g.add_edge(v, v + 1)
    return g


def _popoa_case(params, trial, kind):
    """Two seeded graphs of `kind`, with several sources and sinks on the
    DAGs of odd trials; fans of in-degree 4 + trial."""
    rng = np.random.default_rng(500 * trial + 7 * params.num_pw
                                + ("chain", "dag", "fan").index(kind))
    if kind == "fan":
        g1, g2 = _fan(rng, 4 + trial), _fan(rng, 4 + trial)
        return g1, g2, [graph_sources(g1), graph_sources(g2),
                        graph_sinks(g1), graph_sinks(g2)]
    make = random_dag if kind == "dag" else random_chain
    g1 = make(rng, int(rng.integers(1, 40)))
    g2 = make(rng, int(rng.integers(1, 40)))
    ends = [graph_sources(g1), graph_sources(g2), graph_sinks(g1),
            graph_sinks(g2)]
    if kind == "dag" and trial % 2:
        ends[0] = np.union1d(ends[0], rng.integers(0, g1.node_size, 2))
        ends[3] = np.union1d(ends[3], rng.integers(0, g2.node_size, 2))
    return g1, g2, ends


@pytest.mark.parametrize("kind", ["dag", "chain", "fan"])
@pytest.mark.parametrize("trial", range(4))
@pytest.mark.parametrize("params", PARAMS,
                         ids=lambda p: f"{p.match}-{p.mismatch}-npw{p.num_pw}")
def test_popoa_ref_matches_jax_and_native(params, trial, kind):
    g1, g2, (s1, s2, k1, k2) = _popoa_case(params, trial, kind)
    p1, p2, pp = _port_graph(g1), _port_graph(g2), _port_params(params)

    want = jax_ref.popoa_fill(g1, g2, s1, s2, params)
    got = torch_ref.popoa_fill(p1, p2, s1, s2, pp)
    for name, a, b in zip("MID", got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), name

    aln_j, score_j = jax_ref.popoa_traceback(g1, g2, s1, s2, k1, k2, params,
                                             *want)
    aln_t, score_t = torch_ref.popoa_traceback(p1, p2, s1, s2, k1, k2, pp,
                                               *got)
    assert score_t == score_j and np.array_equal(aln_t, aln_j)

    aln, score = torch_ref.popoa(p1, p2, s1, s2, k1, k2, pp)
    assert score == score_j and np.array_equal(aln, aln_j)
    aln_n, score_n = native.popoa_align(p1, p2, s1, s2, k1, k2, pp)
    assert score_n == score and np.array_equal(aln_n, aln)


def _gesa_dags():
    """tests/test_gesa.py::test_gesa_on_dags's graphs, sentinels added."""
    rng = np.random.default_rng(77)
    out = []
    for _ in range(6):
        g1 = random_dag(rng, int(rng.integers(6, 18)))
        g2 = random_dag(rng, int(rng.integers(6, 18)))
        out += [(g1, add_sentinels(g1, 5, 6)), (g2, add_sentinels(g2, 7, 8))]
    return out


def _rewalk_graphs():
    """tests/test_gesa.py::test_determinize_and_rewalk's graphs: sentinels
    added and two random source-to-sink walks as paths."""
    rng = np.random.default_rng(3)
    out = []
    for trial in range(5):
        g = random_dag(rng, int(rng.integers(8, 25)))
        t = add_sentinels(g, 5, 6)
        for p in range(2):
            walk = [t.src_id]
            while g.next_size(walk[-1]):
                nxt = g.next(walk[-1])
                walk.append(int(nxt[rng.integers(0, len(nxt))]))
            pid = g.add_path(f"rw{trial}_{p}")
            for v in walk[1:-1]:
                g.extend_path(pid, v)
        out.append((g, t))
    return out


@pytest.mark.parametrize("case", [("dags", k) for k in range(12)]
                         + [("rewalk", k) for k in range(5)],
                         ids=lambda c: f"{c[0]}{c[1]}")
def test_determinize_matches_jax(case):
    kind, k = case
    g, t = (_gesa_dags() if kind == "dags" else _rewalk_graphs())[k]
    gp = _port_graph(g)
    tp = SentinelTableau(src_id=t.src_id, snk_id=t.snk_id,
                         src_sentinel=t.src_sentinel,
                         snk_sentinel=t.snk_sentinel)

    det_j = jax_det.determinize(g)
    det_t = torch_det.determinize(gp)
    assert np.array_equal(det_t.labels, det_j.labels)
    for a, b in zip(det_t.edges(), det_j.edges()):
        assert np.array_equal(a, b)

    t2_j = jax_det.translate_tableau(det_j, t)
    t2_t = torch_det.translate_tableau(det_t, tp)
    for field in ("src_id", "snk_id", "src_sentinel", "snk_sentinel"):
        assert getattr(t2_t, field) == getattr(t2_j, field), field

    jax_det.rewalk_paths(det_j, t2_j, g)
    torch_det.rewalk_paths(det_t, t2_t, gp)
    assert det_t.path_size == det_j.path_size == g.path_size
    for pid in range(det_j.path_size):
        assert det_t.path_name(pid) == det_j.path_name(pid)
        assert np.array_equal(det_t.path(pid), det_j.path(pid))

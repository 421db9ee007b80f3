"""The port's free-gap sparse chaining event scan (ops/chain_scan.py)
against the JAX package's (centrolign_tpu.ops.chain_scan, on the CPU) and
the native parity engine, on tests/test_chain_scan.py's chain-graph
workloads.

Tolerance: exact. The plain event scan gives the JAX scan's dp bit for bit
and its winners; sparse_chain_scan gives the JAX function's chain and
score; the port anchorer with CENTROLIGN_TPU_DEVICE_CHAIN=1 and a CPU
device builds the same chain as the JAX anchorer's native engine.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centrolign_tpu.anchorer import Anchorer as JaxAnchorer
from centrolign_tpu.anchorer import ChainAlgorithm as JaxAlgorithm
from centrolign_tpu.match_finder import find_matches as jax_find_matches
from centrolign_tpu.ops import chain_scan as jax_scan
from centrolign_tpu.path_merge import ChainMerge as JaxChainMerge
from centrolign_tpu.score_function import ScoreFunction as JaxScore
from centrolign_tpu_torch import anchorer, match_finder, modify_graph
from centrolign_tpu_torch.graph import BaseGraph
from centrolign_tpu_torch.ops import chain_scan, chain_scan_cuda
from centrolign_tpu_torch.path_merge import ChainMerge
from centrolign_tpu_torch.score_function import ScoreFunction

from test_chain_scan import _chain_graph_from_seq, _mutate

CPU = torch.device("cpu")
NEGF = np.finfo(np.float32).min


def _sequences(rng, n=400, selfmatch=False):
    """tests/test_chain_scan.py::_workload's sequences."""
    base = "".join("ACGT"[rng.integers(4)] for _ in range(n))
    seq1 = base + _mutate(rng, base)
    seq2 = seq1 if selfmatch else (_mutate(rng, base) + base)
    return seq1, seq2


def _jax_chain(seq1, seq2, monkeypatch):
    monkeypatch.delenv("CENTROLIGN_TPU_DEVICE_CHAIN", raising=False)
    g1, t1 = _chain_graph_from_seq(seq1, "a", 5, 6)
    g2, t2 = _chain_graph_from_seq(seq2, "b", 7, 8)
    sf = JaxScore()
    matches = jax_find_matches(g1, g2, t1, t2, 3000, sf)
    return JaxAnchorer(score_function=sf)._anchor_chain_global(
        matches, g1, g2, t1, t2, JaxChainMerge(g1, t1), JaxChainMerge(g2, t2),
        JaxAlgorithm.Sparse, 1.0, None)


def _port_chain(seq1, seq2, device):
    g1 = modify_graph.make_base_graph("a", seq1)
    g2 = modify_graph.make_base_graph("b", seq2)
    t1 = modify_graph.add_sentinels(g1, 5, 6)
    t2 = modify_graph.add_sentinels(g2, 7, 8)
    sf = ScoreFunction()
    matches = match_finder.find_matches(g1, g2, t1, t2, 3000, sf)
    anc = anchorer.Anchorer(score_function=sf, device=device)
    return anc._anchor_chain_global(
        matches, g1, g2, t1, t2, ChainMerge(g1, t1), ChainMerge(g2, t2),
        anchorer.ChainAlgorithm.Sparse, 1.0, None)


def _same_chain(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.walk1, y.walk1)
        assert np.array_equal(x.walk2, y.walk2)
        assert x.count1 == y.count1 and x.count2 == y.count2


def _random_events(rng, n, E):
    """A valid event stream over n anchors: each slot queried at most once
    before its insert, weights from a few values so that maxima tie."""
    kind, slot, qhi = [], [], []
    inserted = []
    for s in rng.permutation(n):
        if rng.random() < 0.8:
            kind.append(0)
            slot.append(s)
            qhi.append(int(rng.integers(0, n + 1)))
        kind.append(1)
        slot.append(s)
        qhi.append(0)
        inserted.append(s)
    kind, slot, qhi = (np.array(a, np.int32)[:E] for a in (kind, slot, qhi))
    w = (rng.integers(1, 4, len(kind)) * 2.0).astype(np.float32)
    dp0 = np.where(rng.random(n) < 0.9,
                   (rng.integers(1, 4, n) * 2.0), NEGF).astype(np.float32)
    return kind, slot, qhi, w, dp0


@pytest.mark.parametrize("seed", range(4))
def test_event_scan_plain_matches_jax(seed):
    rng = np.random.default_rng(5100 + seed)
    n = int(rng.integers(1, 300))
    kind, slot, qhi, w, dp0 = _random_events(rng, n, 2 * n)
    dp_j, win_j = jax_scan._event_scan(*(jnp.asarray(a) for a in (
        kind, slot, qhi, w, dp0)))
    ev = np.stack([kind, slot, qhi, w.view(np.int32)], axis=1)
    dp, win = chain_scan.event_scan_plain(torch.from_numpy(ev),
                                          torch.from_numpy(dp0))
    assert np.array_equal(np.asarray(dp_j), dp.numpy())
    assert np.array_equal(np.asarray(win_j), win.numpy())
    assert (win.numpy() >= 0).any()


@pytest.mark.parametrize("tie_dense", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_sparse_chain_scan_matches_jax(seed, tie_dense):
    rng = np.random.default_rng(5200 + seed)
    n = int(rng.integers(20, 400))
    grid = 24 if tie_dense else 1
    s1 = rng.integers(1, 5000 // grid, n) * grid
    s2 = s1 + (rng.choice([-4, 0, 4], n) if tie_dense
               else rng.integers(-40, 40, n))
    s2 = np.maximum(s2, 0)
    ln = np.full(n, 16) if tie_dense else rng.integers(4, 40, n)
    w = np.full(n, 16.0) if tie_dense else rng.integers(1, 5, n) * 4.0
    src = rng.random(n) < 0.95
    snk = rng.random(n) < 0.95
    args = (s1, s1 + ln - 1, s2, s2 + ln - 1, w, src, snk)
    want = jax_scan.sparse_chain_scan(*args)
    chain_scan_cuda.reset_counters()
    got = chain_scan.sparse_chain_scan(*args, CPU)
    assert got == want and len(got[0]) > 1
    assert (chain_scan_cuda.PLAIN_PROBLEMS, chain_scan_cuda.PLAIN_ANCHORS,
            chain_scan_cuda.LAUNCHES) == (1, n, 0)


def test_sparse_chain_scan_empty():
    e = np.empty(0, np.int64)
    assert chain_scan.sparse_chain_scan(e, e, e, e, np.empty(0), e, e,
                                        CPU) == ([], 0.0)


@pytest.mark.parametrize("selfmatch", [False, True])
@pytest.mark.parametrize("trial", range(3))
def test_port_anchorer_device_chain_matches_native(monkeypatch, trial,
                                                   selfmatch):
    rng = np.random.default_rng(trial * 11 + selfmatch)
    seq1, seq2 = _sequences(rng, selfmatch=selfmatch)
    want = _jax_chain(seq1, seq2, monkeypatch)
    if not want:
        pytest.skip("no matches in this trial")
    native = _port_chain(seq1, seq2, CPU)
    monkeypatch.setenv("CENTROLIGN_TPU_DEVICE_CHAIN", "1")
    chain_scan_cuda.reset_counters()
    assert chain_scan_cuda.PLAIN_PROBLEMS == 0
    device = _port_chain(seq1, seq2, CPU)
    assert chain_scan_cuda.PLAIN_PROBLEMS == 1 and chain_scan_cuda.LAUNCHES == 0
    _same_chain(native, want)
    _same_chain(device, want)


def test_device_chain_needs_a_device_and_chain_graphs(monkeypatch):
    """Without a device the switch leaves the native engine in place; a
    graph that is not a single chain is declined (None), as in the JAX
    package."""
    monkeypatch.setenv("CENTROLIGN_TPU_DEVICE_CHAIN", "1")
    rng = np.random.default_rng(0)
    seq1, seq2 = _sequences(rng)
    chain_scan_cuda.reset_counters()
    _port_chain(seq1, seq2, None)
    assert chain_scan_cuda.PLAIN_PROBLEMS == 0

    g = BaseGraph()
    ids = g.add_nodes(np.array([0, 1, 2, 3]))
    g.add_edges(ids[[0, 0, 1, 2]], ids[[1, 2, 3, 3]])
    chain = modify_graph.make_base_graph("c", "ACGT")
    anc = anchorer.Anchorer(device=CPU)
    assert anc._chain_sparse_scan_device(g, chain, [], 0, np.empty(0),
                                         None, None, None, None,
                                         None) is None
    assert chain_scan_cuda.PLAIN_PROBLEMS == 0

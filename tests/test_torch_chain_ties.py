"""The port's jax-free chain_ties copy against the JAX package's module.

Tolerance: exact. The heap-rank helpers must agree on every input up to
n = 300, AffineTieResolver must pick the same predecessor on every tied
traceback step that the tie-dense fixtures of tests/test_chain_ties.py
produce, and the port's own anchorer, which reaches the port's resolver,
must build the JAX package's chain on those fixtures.
"""

import numpy as np
import pytest

from centrolign_tpu import chain_ties as jax_ties
from centrolign_tpu.ops import chain_scan
from centrolign_tpu_torch import chain_ties as torch_ties

from test_chain_ties import _run_chain, _setup_graphs, _tie_dense_matches

def test_heap_helpers_match():
    for n in range(301):
        for lo in (0, 13):
            assert (torch_ties._heap_rank(lo, lo + n)
                    == chain_scan._heap_rank(lo, lo + n))
        for x in range(n):
            assert (torch_ties._subtree_interval(x, n)
                    == chain_scan._subtree_interval(x, n))


@pytest.mark.parametrize("trial", range(6))
def test_resolver_matches_on_tie_cases(monkeypatch, trial):
    rng = np.random.default_rng(9100 + trial)
    graphs = _setup_graphs(rng, 260, 260)
    matches = _tie_dense_matches(rng, 256, n_pos=24, dup=3)
    calls = []
    init, resolve = jax_ties.AffineTieResolver.__init__, \
        jax_ties.AffineTieResolver.resolve

    def recording_init(self, *args):
        self.recorded_args = args
        init(self, *args)

    def recording_resolve(self, anchor, struct, stored):
        got = resolve(self, anchor, struct, stored)
        calls.append((self.recorded_args, anchor, struct, stored, got))
        return got

    monkeypatch.setattr(jax_ties.AffineTieResolver, "__init__", recording_init)
    monkeypatch.setattr(jax_ties.AffineTieResolver, "resolve", recording_resolve)
    _run_chain(monkeypatch, matches, graphs, cdq=True)
    assert calls, "the fixture produced no tied traceback step"
    ports = {}
    for args, anchor, struct, stored, want in calls:
        port = ports.setdefault(id(args), torch_ties.AffineTieResolver(*args))
        assert port.resolve(anchor, struct, stored) == want


def _port_chain(monkeypatch, matches, rng_seed):
    """The port's anchorer (CDQ engine, ties through the port's
    chain_ties) on the graphs of _setup_graphs(seed)."""
    from centrolign_tpu_torch import anchorer, match_finder, modify_graph
    from centrolign_tpu_torch.path_merge import PathMerge
    from centrolign_tpu_torch.score_function import ScoreFunction

    rng = np.random.default_rng(rng_seed)
    seqs = ["".join("ACGT"[i] for i in rng.integers(0, 4, 260))
            for _ in range(2)]
    g1 = modify_graph.make_base_graph("a", seqs[0])
    g2 = modify_graph.make_base_graph("b", seqs[1])
    t1 = modify_graph.add_sentinels(g1, 5, 6)
    t2 = modify_graph.add_sentinels(g2, 7, 8)
    ms = [match_finder.MatchSet(
        walks1=m.walks1.copy(), walks2=m.walks2.copy(), count1=m.count1,
        count2=m.count2, full_length=m.full_length) for m in matches]
    monkeypatch.setenv("CENTROLIGN_TPU_CHAIN_CDQ", "1")
    anc = anchorer.Anchorer(
        score_function=ScoreFunction(),
        chaining_algorithm=anchorer.ChainAlgorithm.SparseAffine,
        autocalibrate_gap_penalties=False,
        split_matches_at_branchpoints=False, do_fill_in_anchoring=False)
    chain = anc.anchor_chain(ms, g1, g2, t1, t2, PathMerge(g1, t1),
                             PathMerge(g2, t2))
    return [(tuple(a.walk1.tolist()), tuple(a.walk2.tolist()),
             a.score, a.gap_before, a.gap_after,
             a.gap_score_before, a.gap_score_after) for a in chain]


def test_port_anchorer_resolves_ties_like_jax(monkeypatch):
    rng = np.random.default_rng(9100)
    graphs = _setup_graphs(rng, 260, 260)
    matches = _tie_dense_matches(rng, 256, n_pos=24, dup=3)
    want = _run_chain(monkeypatch, matches, graphs, cdq=True)
    calls = []
    resolve = torch_ties.AffineTieResolver.resolve

    def counted(self, *args):
        calls.append(args)
        return resolve(self, *args)

    monkeypatch.setattr(torch_ties.AffineTieResolver, "resolve", counted)
    assert _port_chain(monkeypatch, matches, 9100) == want
    assert calls, "the port's anchorer never reached its tie resolver"

"""Masked (-c) SparseAffine chaining on the one-family CDQ engine against
the tree engine, on the port alone.

Anchorer._chain_affine takes a masked chain x chain input to the CDQ
engine with the masked (set, walk1, walk2) triples left out of its input.
Every masked chaining here is redone by native.chain_affine_parity with
the same mask (the tree sweep, the oracle: what tree_engine_only below
runs), with CHAIN_DP_DUMP set. Tolerance: exact. The chain's rows (match
set, walk indices, gaps) and scores (anchor weight, gap scores) equal; the
dp value of every anchor the mask leaves bit-equal to the tree sweep's,
its backpointer equal wherever the CDQ's winning channel had one achiever;
a masked anchor never gets a value in the sweep. Inputs: random chain x
chain inputs under random masks, with and without the sources and sinks;
the self-matches of a tandem sequence under Core.generate_diagonal_mask
and then Core.update_mask, as -c's bonding rounds chain them; exact tandem
copies, on which the tie resolver engages under the mask; a mask over
every anchor (the empty chain). A masked input that is not chain x chain
and a masked chaining whose tied step goes unresolved take the tree
engine, and are counted under chain.masked_tree.
"""

import contextlib
import os

import numpy as np
import pytest

from centrolign_tpu_torch import anchorer, chain_ties, core, metrics, native
from centrolign_tpu_torch.execution import Subproblem
from centrolign_tpu_torch.match_finder import MatchSet
from centrolign_tpu_torch.modify_graph import add_sentinels, make_base_graph
from centrolign_tpu_torch.path_merge import PathMerge
from centrolign_tpu_torch.score_function import ScoreFunction
from centrolign_tpu_torch.utils.encoding import encode_seq

from conftest import random_sequence

MININF = np.finfo(np.float32).min


@contextlib.contextmanager
def tree_engine_only():
    """Inside, the port's SparseAffine chainings all take the tree engine
    (native.chain_affine_parity): both CDQ engines answer as they do for an
    input out of their reach (the one-family engine: not chain x chain; the
    graph engine: None), so Anchorer._chain_affine falls through to the
    tree engine and counts it as for such an input."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(anchorer.Anchorer, "_chain_affine_cdq",
                   lambda self, *args, **kw: anchorer._NOT_CHAINS)
        mp.setattr(anchorer.Anchorer, "_chain_affine_graph_cdq",
                   lambda self, *args, **kw: None)
        yield


def _read_dump(path):
    with open(path, "rb") as f:
        n = int(np.fromfile(f, dtype=np.int64, count=1)[0])
        dp = np.fromfile(f, dtype=np.float32, count=n)
        bp = np.fromfile(f, dtype=np.uint64, count=n).astype(np.int64)
    return dp, bp


class _Oracle:
    """Wraps Anchorer._chain_affine: each masked call's result is held
    against the tree engine's on the same input and mask, and the CDQ value
    pass's dp and backpointers (when it ran) against the tree sweep's."""

    def __init__(self, tmp_path):
        self.dump = str(tmp_path / "tree.dpdump")
        self.checked = []  # (anchors, masked anchors, chain rows)
        self.resolves = 0
        self._values = []

    def install(self, mp):
        oracle = self
        orig = anchorer.Anchorer._chain_affine
        orig_values = anchorer.Anchorer._cdq_values
        orig_resolve = chain_ties.AffineTieResolver.resolve

        def values(anc, *args):
            got = orig_values(anc, *args)
            oracle._values.append(got)
            return got

        def counted(res, *args):
            oracle.resolves += 1
            return orig_resolve(res, *args)

        def wrapped(anc, *args):
            oracle._values.clear()
            got = orig(anc, *args)
            if args[10]:
                oracle.check(anc, args, got)
            return got

        mp.setattr(anchorer.Anchorer, "_chain_affine", wrapped)
        mp.setattr(anchorer.Anchorer, "_cdq_values", values)
        mp.setattr(chain_ties.AffineTieResolver, "resolve", counted)

    def check(self, anc, args, got):
        (matches, g1, g2, xm1, xm2, so1, so2, si1, si2, scale, masked,
         num_sets, num_anchors, max_size, weights) = args
        os.environ["CHAIN_DP_DUMP"] = self.dump
        try:
            rows, fvals = native.chain_affine_parity(
                g1, g2, matches, num_sets, weights, xm1, xm2,
                anc.gap_open, anc.gap_extend, scale, so1, so2, si1, si2,
                num_anchors, max_size, masked)
        finally:
            del os.environ["CHAIN_DP_DUMP"]
        assert np.array_equal(got[0], rows)
        assert np.array_equal(got[1], fvals)
        dp_t, bp_t = _read_dump(self.dump)
        # MatchBank id order: set-major, then walk1, then walk2
        keep = np.array([(s, i, j) not in masked
                         for s in range(num_sets)
                         for i in range(len(matches[s].walks1))
                         for j in range(len(matches[s].walks2))], dtype=bool)
        assert len(dp_t) == len(keep)
        assert (dp_t[~keep] == MININF).all() and (bp_t[~keep] == -1).all()
        if self._values:
            (dp, bp, tie, *_), = self._values
            ids = np.flatnonzero(keep)
            assert np.array_equal(dp.view(np.uint32),
                                  dp_t[ids].view(np.uint32))
            bp_full = np.where(bp >= 0, ids[np.maximum(bp, 0)], -1)
            untied = tie == 0
            assert np.array_equal(bp_full[untied], bp_t[ids][untied])
        self.checked.append((len(keep), int((~keep).sum()), len(rows)))


@pytest.fixture(autouse=True)
def _host_path(monkeypatch):
    for k in list(os.environ):
        if k.startswith("CENTROLIGN_") or k == "CHAIN_DP_DUMP":
            monkeypatch.delenv(k)
    monkeypatch.setenv("CENTROLIGN_TORCH_DEVICE", "none")
    metrics.reset()


def _anchorer(global_anchoring=True):
    return anchorer.Anchorer(
        score_function=ScoreFunction(),
        chaining_algorithm=anchorer.ChainAlgorithm.SparseAffine,
        global_anchoring=global_anchoring,
        autocalibrate_gap_penalties=False,
        split_matches_at_branchpoints=False, do_fill_in_anchoring=False)


def _graphs(g1, g2):
    t1 = add_sentinels(g1, 5, 6)
    t2 = add_sentinels(g2, 7, 8)
    return g1, g2, t1, t2, PathMerge(g1, t1), PathMerge(g2, t2)


def _random_matches(rng, n1, n2, n_sets, near=0.5):
    """n_sets match sets of 1-4 walks a side on two chains of n1 and n2
    nodes, walks 4-19 nodes long; about `near` of the sets near the
    diagonal, so that the chains are long."""
    matches = []
    for _ in range(n_sets):
        L = int(rng.integers(4, 20))
        c1, c2 = (int(c) for c in rng.integers(1, 5, size=2))
        st1 = rng.integers(0, n1 - L, size=c1)
        if rng.random() < near:
            st2 = np.clip(st1[:1] * n2 // n1 + rng.integers(-6, 7, size=c2),
                          0, n2 - L)
        else:
            st2 = rng.integers(0, n2 - L, size=c2)
        matches.append(MatchSet(
            walks1=(st1[:, None] + np.arange(L)).astype(np.int64),
            walks2=(st2[:, None] + np.arange(L)).astype(np.int64),
            count1=c1, count2=c2, full_length=L))
    return matches


def _random_mask(rng, matches, share):
    return {(s, i, j) for s, m in enumerate(matches)
            for i in range(len(m.walks1)) for j in range(len(m.walks2))
            if rng.random() < share}


def _copy(matches):
    return [MatchSet(walks1=m.walks1.copy(), walks2=m.walks2.copy(),
                     count1=m.count1, count2=m.count2,
                     full_length=m.full_length) for m in matches]


def _chain(anc, matches, graphs, mask):
    g1, g2, t1, t2, xm1, xm2 = graphs
    chain = anc.anchor_chain(matches, g1, g2, t1, t2, xm1, xm2,
                             masked_matches=mask)
    return [(a.match_set, a.idx1, a.idx2, a.score, a.gap_before,
             a.gap_after, a.gap_score_before, a.gap_score_after)
            for a in chain]


def _tree_chain(anc, matches, graphs, mask):
    """The same chaining on the tree engine."""
    with tree_engine_only():
        return _chain(anc, _copy(matches), graphs, set(mask))


def _tags():
    """The masked chainings' counters: (count, anchors) by tag."""
    return {t: (c[0], c[1]) for t, c in metrics.counters.items()
            if t.startswith("chain.masked")}


# -- random chain x chain inputs under random masks ------------------------

@pytest.mark.parametrize("ends", ["global", "local"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_chain_matches_tree_engine(ends, seed, tmp_path,
                                          monkeypatch):
    rng = np.random.default_rng(7300 + seed)
    n1, n2 = 320 + 40 * seed, 300
    graphs = _graphs(make_base_graph("a", random_sequence(rng, n1)),
                     make_base_graph("b", random_sequence(rng, n2)))
    matches = _random_matches(rng, n1, n2, 60)
    mask = _random_mask(rng, matches, 0.3)
    want = _tree_chain(_anchorer(ends == "global"), matches, graphs, mask)
    metrics.reset()
    oracle = _Oracle(tmp_path)
    oracle.install(monkeypatch)
    got = _chain(_anchorer(ends == "global"), matches, graphs, mask)
    assert got == want
    assert len(got) > 1
    ((n, n_masked, rows),) = oracle.checked
    assert 0 < n_masked < n and rows == len(got)
    tags = _tags()
    assert tags["chain.masked_cdq"] == tags["chain.masked"] == (1, n)
    assert set(tags) == {"chain.masked", "chain.masked_cdq"}


# -- -c's masks on the self-matches of a tandem sequence ------------------

def _leaf(seq):
    sub = Subproblem()
    sub.graph = make_base_graph("seq1", seq)
    sub.tableau = add_sentinels(sub.graph, 5, 6)
    sub.name = "seq1"
    return sub


def _exact_tandem(rng):
    """Four exact copies of a 300 bp unit between random 200 bp flanks: a
    tied step on the traceback path of both bonding rounds' chainings."""
    unit = random_sequence(rng, 300)
    return random_sequence(rng, 200) + unit * 4 + random_sequence(rng, 200)


def _bonding_rounds(seq, rounds, monkeypatch, tmp_path=None):
    """-c's bonding rounds on one leaf as core.leaf_bond_alignments runs
    them (the diagonal mask, then the mask updated by each round's chain),
    without the bonds; with tmp_path each masked chaining is checked by an
    _Oracle. Returns (each round's chain, the oracle)."""
    sub = _leaf(seq)
    anc = anchorer.Anchorer(score_function=ScoreFunction())
    scale, matches, _ = core.leaf_intrinsic_scale(sub, 3000, ScoreFunction(),
                                                  anc)
    oracle = None
    if tmp_path is not None:
        oracle = _Oracle(tmp_path)
        oracle.install(monkeypatch)
    pm = PathMerge(sub.graph, sub.tableau)
    mask = core.Core.generate_diagonal_mask(matches)
    chains = []
    for _ in range(rounds):
        chain = anc.anchor_chain(matches, sub.graph, sub.graph, sub.tableau,
                                 sub.tableau, pm, pm, masked_matches=mask,
                                 override_scale=scale)
        chains.append([(a.match_set, a.idx1, a.idx2, a.gap_before,
                        a.gap_after, a.score) for a in chain])
        core.Core.update_mask(matches, chain, mask, True)
    return chains, oracle


@pytest.mark.parametrize("case", ["tandem", "exact_tandem"])
def test_bonding_masks_match_tree_engine(case, tmp_path, monkeypatch):
    from test_torch_cyclize import _tandem_fasta
    if case == "tandem":
        fasta = _tandem_fasta(tmp_path / "in.fa", 1000, seed=5)
        with open(fasta) as f:
            seq = f.read().split("\n")[1]
    else:
        seq = _exact_tandem(np.random.default_rng(7400))
    with tree_engine_only():
        want, _ = _bonding_rounds(seq, 2, monkeypatch)
    metrics.reset()
    got, oracle = _bonding_rounds(seq, 2, monkeypatch, tmp_path)
    assert got == want
    assert all(len(c) > 1 for c in got)
    # the diagonal mask, then the diagonal and the first round's chain
    assert len(oracle.checked) == 2
    assert all(0 < n_masked < n for n, n_masked, _ in oracle.checked)
    assert oracle.checked[1][1] > oracle.checked[0][1]
    tags = _tags()
    assert tags["chain.masked_cdq"] == tags["chain.masked"]
    assert tags["chain.masked"][0] == 2
    assert "chain.masked_tree" not in tags
    if case == "exact_tandem":
        assert oracle.resolves > 0, "no tied step reached the resolver"


def test_mask_over_every_anchor_gives_the_empty_chain(tmp_path, monkeypatch):
    rng = np.random.default_rng(7500)
    graphs = _graphs(make_base_graph("a", random_sequence(rng, 200)),
                     make_base_graph("b", random_sequence(rng, 200)))
    matches = _random_matches(rng, 200, 200, 20)
    mask = _random_mask(rng, matches, 1.0)
    assert _tree_chain(_anchorer(), matches, graphs, mask) == []
    metrics.reset()
    oracle = _Oracle(tmp_path)
    oracle.install(monkeypatch)
    assert _chain(_anchorer(), matches, graphs, mask) == []
    ((n, n_masked, rows),) = oracle.checked
    assert n == n_masked > 0 and rows == 0
    assert set(_tags()) == {"chain.masked", "chain.masked_cdq"}


# -- what the CDQ engine cannot answer keeps the tree engine ---------------

def _bubble_graph(rng, n):
    """A chain of n nodes with its path, and a second path around a
    substituted block of 6 nodes in its middle: not a single chain."""
    g = make_base_graph("a", random_sequence(rng, n))
    k = n // 2
    alt = g.add_nodes(encode_seq(random_sequence(rng, 6)))
    g.add_edges(np.r_[k - 1, alt[:-1], alt[-1]], np.r_[alt, k + 6])
    pid = g.add_path("b")
    g.extend_path_array(pid, np.r_[np.arange(k), alt, np.arange(k + 6, n)])
    return g


@pytest.mark.parametrize("case", ["unresolved", "not_chains"])
def test_out_of_reach_takes_the_tree_engine(case, tmp_path, monkeypatch):
    rng = np.random.default_rng(7600)
    if case == "not_chains":
        g1 = _bubble_graph(rng, 300)
        graphs = _graphs(g1, make_base_graph("c", random_sequence(rng, 300)))
        matches = _random_matches(rng, 300, 300, 60)
        mask = _random_mask(rng, matches, 0.3)
        want = _tree_chain(_anchorer(), matches, graphs, mask)
        metrics.reset()
        oracle = _Oracle(tmp_path)
        oracle.install(monkeypatch)
        got = _chain(_anchorer(), matches, graphs, mask)
        assert got == want and len(got) > 1
        # neither CDQ engine ran: the graph engine takes no mask
        assert oracle._values == []
        assert len(oracle.checked) == 1
    else:
        seq = _exact_tandem(np.random.default_rng(7400))
        with tree_engine_only():
            want, _ = _bonding_rounds(seq, 2, monkeypatch)
        monkeypatch.setattr(chain_ties.AffineTieResolver, "resolve",
                            lambda self, *args: None)
        metrics.reset()
        got, _ = _bonding_rounds(seq, 2, monkeypatch)
        assert got == want
    tags = _tags()
    assert tags["chain.masked_tree"] == tags["chain.masked"]
    assert tags["chain.masked"][0] >= 1
    assert set(tags) == {"chain.masked", "chain.masked_tree"}

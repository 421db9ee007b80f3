"""The graph x graph CDQ engine of SparseAffine chaining against the tree
engine, on the port alone.

Every chaining that reaches Anchorer._chain_affine_graph_cdq (the inputs
that are not chain x chain) is redone by the tree engine,
native.chain_affine_parity, the oracle (what
test_torch_chain_masked_cdq.tree_engine_only runs), with CHAIN_DP_DUMP
set. Tolerance: exact. The dp value of every anchor bit-equal to the tree
sweep's, its backpointer equal wherever the CDQ's winning channel had one
achiever, and the chain's rows (match set, walk indices, gaps) and scores
(anchor weight, gap scores) equal; the same again with the sources and
sinks left out (local chaining). Inputs:
five.fasta's root merge, small progressive MSAs of simulated 2 + 2, 3 + 2
and 3 + 3 cohorts (2-4 chains a side), and exact tandem copies, which put
tied steps on the traceback path (the tie resolver must engage). An
unresolved tie must hand the chaining to the tree engine and count it as
chain.tree_fallback; five.fasta's GFA stays byte-equal to the reference
with every chaining on a CDQ engine.
"""

import contextlib
import io
import os

import numpy as np
import pytest

from centrolign_tpu_torch import anchorer, chain_ties, cli, metrics, native

from conftest import mutate_sequence, random_sequence
from test_torch_chain_masked_cdq import tree_engine_only

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIVE = [os.path.join(REPO, "benchdata", "five.fasta"),
        os.path.join(REPO, "benchdata", "five.nwk")]


def _read_dump(path):
    with open(path, "rb") as f:
        n = int(np.fromfile(f, dtype=np.int64, count=1)[0])
        dp = np.fromfile(f, dtype=np.float32, count=n)
        bp = np.fromfile(f, dtype=np.uint64, count=n).astype(np.int64)
    return dp, bp


class _Oracle:
    """Wraps Anchorer._chain_affine_graph_cdq: each call's result is held
    against the tree engine's on the same input, with and without the
    sources and sinks; with `roots_only`, only the calls whose graphs
    both hold more than one path, and only with their sources and sinks
    (five.fasta: its root merge)."""

    def __init__(self, tmp_path, roots_only=False):
        self.dump = str(tmp_path / "tree.dpdump")
        self.roots_only = roots_only
        self.local = not roots_only
        self.checked = []
        self.resolves = 0
        self._orig = anchorer.Anchorer._chain_affine_graph_cdq

    def install(self, mp):
        oracle = self
        orig_resolve = chain_ties.GraphTieResolver.resolve

        def counted(res, *args):
            oracle.resolves += 1
            return orig_resolve(res, *args)

        def wrapped(anc, *args):
            got = oracle._orig(anc, *args)
            n = sum(len(m.walks1) * len(m.walks2) for m in args[0][:args[10]])
            root = args[1].path_size > 1 and args[2].path_size > 1
            if isinstance(got, tuple) and (root or not oracle.roots_only):
                oracle.check(anc, args, got, n)
            return got

        mp.setattr(anchorer.Anchorer, "_chain_affine_graph_cdq", wrapped)
        mp.setattr(chain_ties.GraphTieResolver, "resolve", counted)

    def tree(self, anc, args, with_ends):
        (matches, g1, g2, xm1, xm2, so1, so2, si1, si2, scale, num_sets,
         num_anchors, max_size, weights) = args
        if not with_ends:
            so1 = so2 = si1 = si2 = None
        os.environ["CHAIN_DP_DUMP"] = self.dump
        try:
            rows, fvals = native.chain_affine_parity(
                g1, g2, matches, num_sets, weights, xm1, xm2,
                anc.gap_open, anc.gap_extend, scale, so1, so2, si1, si2,
                num_anchors, max_size)
        finally:
            del os.environ["CHAIN_DP_DUMP"]
        return rows, fvals, _read_dump(self.dump)

    def check(self, anc, args, got, n):
        for with_ends in (True, False) if self.local else (True,):
            call = list(args)
            if not with_ends:
                call[5:9] = [None] * 4
                got = self._orig(anc, *call)
                if not isinstance(got, tuple):
                    continue
            rows, fvals, (dp_t, bp_t) = self.tree(anc, args, with_ends)
            eng = native.AffineGraphCDQ(
                call[1], call[2], call[0], call[10], call[13], call[3],
                call[4], anc.gap_open, anc.gap_extend, call[9], *call[5:9],
                call[11], call[12])
            (dp, bp, tie, *_), _opt = eng.values()
            assert len(dp) == len(dp_t) == n
            assert np.array_equal(dp.view(np.uint32), dp_t.view(np.uint32))
            untied = tie == 0
            assert np.array_equal(bp[untied], bp_t[untied])
            assert np.array_equal(got[0], rows)
            assert np.array_equal(got[1], fvals)
            self.checked.append((n, with_ends, len(rows)))


def _run_cli(argv):
    out = io.StringIO()
    metrics.reset()
    with contextlib.redirect_stdout(out):
        assert cli.main(argv) == 0
    return out.getvalue(), dict(metrics.counters)


def _cohorts(path, seed, sizes, length=2500, tandem=False):
    """A FASTA of len(sizes) cohorts (sizes[k] leaves each) descended from
    one random sequence, and a guide tree that merges each cohort's leaves
    left to right and then the cohorts. With `tandem`, the shared ancestor
    is exact copies of one 150 bp unit between random flanks, and the
    leaves mutate only the flanks, so the copies stay exact."""
    rng = np.random.default_rng(seed)
    if tandem:
        unit = random_sequence(rng, 150)
        flank = [random_sequence(rng, 400) for _ in range(2)]
    else:
        root = random_sequence(rng, length)
    records, subtrees = [], []
    for c, size in enumerate(sizes):
        names = []
        if tandem:
            anc_flanks = [mutate_sequence(rng, f, 0.03, 0.01) for f in flank]
        else:
            anc = mutate_sequence(rng, root, sub_rate=0.03, indel_rate=0.01)
        for k in range(size):
            name = f"c{c}s{k}"
            if tandem:
                fl = [mutate_sequence(rng, f, 0.02, 0.005) for f in anc_flanks]
                seq = fl[0] + unit * int(rng.integers(6, 9)) + fl[1]
            else:
                seq = mutate_sequence(rng, anc, sub_rate=0.02,
                                      indel_rate=0.01)
            records.append(f">{name}\n{seq}\n")
            names.append(name)
        tree = names[0]
        for name in names[1:]:
            tree = f"({tree},{name})"
        subtrees.append(tree)
    tree = subtrees[0]
    for sub in subtrees[1:]:
        tree = f"({tree},{sub})"
    path.write_text("".join(records))
    nwk = path.with_suffix(".nwk")
    nwk.write_text(tree + ";\n")
    # a budget of anchors keeps the tree engine to seconds
    return ["-v", "0", "-a", "20000", "-T", str(nwk), str(path)]


@pytest.fixture(autouse=True)
def _host_path(monkeypatch):
    for k in list(os.environ):
        if k.startswith("CENTROLIGN_") or k == "CHAIN_DP_DUMP":
            monkeypatch.delenv(k)
    monkeypatch.setenv("CENTROLIGN_TORCH_DEVICE", "none")


@pytest.fixture(scope="module")
def five(tmp_path_factory):
    """five.fasta through the port's CLI, its root merge held against the
    tree engine: (GFA, counters, oracle)."""
    oracle = _Oracle(tmp_path_factory.mktemp("five"), roots_only=True)
    with pytest.MonkeyPatch.context() as mp:
        for k in list(os.environ):
            if k.startswith("CENTROLIGN_") or k == "CHAIN_DP_DUMP":
                mp.delenv(k)
        mp.setenv("CENTROLIGN_TORCH_DEVICE", "none")
        oracle.install(mp)
        gfa, counters = _run_cli(["-v", "0", "-T", FIVE[1], FIVE[0]])
    return gfa, counters, oracle


CASES = ["five_root", "cohorts_2x2_a", "cohorts_2x2_b", "cohorts_3x2",
         "cohorts_3x3", "tandem"]


@pytest.mark.parametrize("case", CASES)
def test_graph_engine_matches_tree_engine(case, five, tmp_path, monkeypatch):
    if case == "five_root":
        oracle = five[2]
        assert len(oracle.checked) == 1
        assert oracle.checked[0][0] > 160000
        return
    sizes, seed, tandem = {
        "cohorts_2x2_a": ((2, 2), 31, False),
        "cohorts_2x2_b": ((2, 2), 32, False),
        "cohorts_3x2": ((3, 2), 33, False),
        "cohorts_3x3": ((3, 3), 34, False),
        "tandem": ((2, 2), 35, True),
    }[case]
    oracle = _Oracle(tmp_path)
    oracle.install(monkeypatch)
    _run_cli(_cohorts(tmp_path / "in.fasta", seed, sizes, tandem=tandem))
    # a chain x graph merge per extra leaf of a cohort, and the root
    assert len(oracle.checked) >= 2 * (1 + sum(s - 2 for s in sizes))
    assert all(rows > 1 for _, _, rows in oracle.checked)
    if tandem:
        assert oracle.resolves > 0, "no tied step reached the resolver"


def test_unresolved_tie_falls_back_to_the_tree_engine(tmp_path, monkeypatch):
    argv = _cohorts(tmp_path / "in.fasta", 35, (2, 2), tandem=True)
    with tree_engine_only():
        want, counters = _run_cli(argv)
    assert "chain.cdq" not in counters and counters["chain.tree"][1] > 0
    monkeypatch.setattr(chain_ties.GraphTieResolver, "resolve",
                        lambda self, *args: None)
    got, counters = _run_cli(argv)
    assert got == want
    assert counters["chain.tree_fallback"][1] > 0
    assert "chain.tree" not in counters
    # the leaf merges stay on the chain x chain engine
    assert counters["chain.cdq"][0] == 2


def test_five_fasta_gfa_with_every_chaining_on_cdq(five):
    gfa, counters, oracle = five
    with open(os.path.join(REPO, "benchdata", "ref_five.gfa")) as f:
        assert gfa == f.read()
    assert "chain.tree" not in counters
    assert "chain.tree_fallback" not in counters
    # four merges, the root's anchors among chain.cdq's
    assert counters["chain.cdq"][0] == 4
    assert counters["chain.cdq"][1] >= oracle.checked[0][0]

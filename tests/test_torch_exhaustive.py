"""Exhaustive chaining (-g 0) of the port against the JAX package.

The port's Anchorer with ChainAlgorithm.Exhaustive and the JAX package's
chain the same seeded inputs, built from the same walk arrays in each
package's own graphs and match sets. Tolerance: exact. The chains' rows
(match set, walk indices), anchor scores, gaps and gap scores are equal.
Inputs: random match sets on two chains (chain x chain) and on a chain
with a bubble against a chain (bubble x chain), below 256 anchors (the
Python DP) and above it (the native sweeps: chain_dp_seq on chain x chain,
chain_dp_general on bubble x chain), with global anchoring on and off,
and with fill-in anchoring on, which Exhaustive runs through the Python
fill-in. One case runs both CLIs with -g 0 on a seeded ~3 kbp pair and
compares the CIGAR byte for byte.
"""

import numpy as np
import pytest

import centrolign_tpu.anchorer as jax_anchorer
import centrolign_tpu.match_finder as jax_match_finder
import centrolign_tpu.modify_graph as jax_modify_graph
import centrolign_tpu.path_merge as jax_path_merge
import centrolign_tpu.score_function as jax_score_function
import centrolign_tpu.utils.encoding as jax_encoding
from centrolign_tpu_torch import anchorer, match_finder, modify_graph
from centrolign_tpu_torch import path_merge, score_function
from centrolign_tpu_torch.utils import encoding

from conftest import mutate_sequence, random_sequence
from test_torch_chain_masked_cdq import _random_matches

PORT = (anchorer, match_finder, modify_graph, path_merge, score_function,
        encoding)
JAX = (jax_anchorer, jax_match_finder, jax_modify_graph, jax_path_merge,
       jax_score_function, jax_encoding)


def _spec(seed, bubble, n_sets):
    """The sequences, the bubble and the walks of one input, drawn from
    `seed`: (seq1, seq2, alt or None, the port's match sets)."""
    rng = np.random.default_rng(seed)
    seq1, seq2 = random_sequence(rng, 400), random_sequence(rng, 400)
    alt = random_sequence(rng, 6) if bubble else None
    return seq1, seq2, alt, _random_matches(rng, 400, 400, n_sets)


def _chain(pkg, spec, global_anchoring, fill_in):
    """One package's Exhaustive chain of `spec`, as comparable rows; the
    bubble is the one of test_torch_chain_masked_cdq._bubble_graph."""
    anc_mod, mf, mg, pm, sf, enc = pkg
    seq1, seq2, alt, sets = spec
    g1 = mg.make_base_graph("a", seq1)
    if alt is not None:
        # a second path around a substituted block of 6 nodes in the
        # middle of graph1: not a single chain
        n, k = len(seq1), len(seq1) // 2
        nodes = g1.add_nodes(enc.encode_seq(alt))
        g1.add_edges(np.r_[k - 1, nodes[:-1], nodes[-1]],
                     np.r_[nodes, k + 6])
        pid = g1.add_path("b")
        g1.extend_path_array(
            pid, np.r_[np.arange(k), nodes, np.arange(k + 6, n)])
    g2 = mg.make_base_graph("c", seq2)
    t1, t2 = mg.add_sentinels(g1, 5, 6), mg.add_sentinels(g2, 7, 8)
    matches = [mf.MatchSet(walks1=m.walks1.copy(), walks2=m.walks2.copy(),
                           count1=m.count1, count2=m.count2,
                           full_length=m.full_length) for m in sets]
    anc = anc_mod.Anchorer(
        score_function=sf.ScoreFunction(),
        chaining_algorithm=anc_mod.ChainAlgorithm.Exhaustive,
        global_anchoring=global_anchoring, do_fill_in_anchoring=fill_in,
        split_matches_at_branchpoints=False)
    chain = anc.anchor_chain(matches, g1, g2, t1, t2, pm.PathMerge(g1, t1),
                             pm.PathMerge(g2, t2))
    return [(a.match_set, a.idx1, a.idx2, a.score, a.gap_before,
             a.gap_after, a.gap_score_before, a.gap_score_after,
             tuple(a.walk1.tolist()), tuple(a.walk2.tolist()))
            for a in chain]


CASES = {
    # name: (seed, bubble, match sets, global anchoring, fill-in)
    "chains_small_global": (8100, False, 20, True, False),
    "chains_small_local": (8101, False, 20, False, False),
    "chains_large_global": (8102, False, 150, True, False),
    "chains_large_local": (8103, False, 150, False, False),
    "bubble_small_global": (8104, True, 20, True, False),
    "bubble_small_local": (8105, True, 20, False, False),
    "bubble_large_global": (8106, True, 150, True, False),
    "bubble_large_local": (8107, True, 150, False, False),
    "chains_large_fill_in": (8108, False, 150, True, True),
    "bubble_small_fill_in": (8109, True, 20, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_exhaustive_chain_matches_jax(case, monkeypatch):
    from centrolign_tpu_torch import native

    seed, bubble, n_sets, global_anchoring, fill_in = CASES[case]
    spec = _spec(seed, bubble, n_sets)
    n = sum(len(m.walks1) * len(m.walks2) for m in spec[3])
    assert (n >= 256) == (n_sets == 150), n
    want = _chain(JAX, spec, global_anchoring, fill_in)
    sweeps = []
    for name in ("chain_dp_seq", "chain_dp_general"):
        def counted(*args, _name=name, _orig=getattr(native, name)):
            sweeps.append(_name)
            return _orig(*args)
        monkeypatch.setattr(native, name, counted)
    got = _chain(PORT, spec, global_anchoring, fill_in)
    assert got == want
    assert len(got) > 1
    # the top-level chaining's engine: the Python DP below 256 anchors
    if n < 256:
        assert sweeps == [] or fill_in
    else:
        assert sweeps[0] == ("chain_dp_general" if bubble
                             else "chain_dp_seq")


def test_exhaustive_cli_matches_jax_cli(tmp_path):
    from test_torch_cli import _run_jax_cli, _run_port

    rng = np.random.default_rng(8200)
    a = random_sequence(rng, 3000)
    b = mutate_sequence(rng, a, sub_rate=0.02, indel_rate=0.01)
    fasta = tmp_path / "pair.fasta"
    fasta.write_text(f">a\n{a}\n>b\n{b}\n")
    argv = ["-v", "0", "-g", "0", str(fasta)]
    ref = _run_jax_cli(argv)
    assert ref.returncode == 0, ref.stderr
    r, stats = _run_port(argv, CENTROLIGN_TORCH_DEVICE="none")
    assert r.returncode == 0, r.stderr
    assert r.stdout == ref.stdout and r.stdout
    assert stats["foreign"] == []

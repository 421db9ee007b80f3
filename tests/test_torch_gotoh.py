"""The port's plain Gotoh fill and alignment against the JAX package.

Tolerance: exact. The DP is int32 throughout, so backpointers (on every
in-matrix cell), scores and alignments must be bit-equal to
centrolign_tpu.ops.gotoh._gotoh_scan (the JAX package's oracle for its
Pallas fills), to its gotoh_align, and to the popoa oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centrolign_tpu.ops import gotoh as jax_gotoh
from centrolign_tpu.ops.align_params import AlignmentParams
from centrolign_tpu.ops.popoa_ref import popoa
from centrolign_tpu_torch.ops import gotoh as torch_gotoh
from centrolign_tpu_torch.ops.align_params import params_from_arrays
from centrolign_tpu_torch.ops.gotoh_cuda import (gotoh_align_device,
                                                 pack_seqs, params_table)

from util import graph_sinks, graph_sources, random_chain

PARAMS = [
    AlignmentParams(20, 80, (60, 800, 2500), (30, 5, 1)),
    AlignmentParams(1, 1, (2,), (1,)),
    AlignmentParams(5, 9, (6, 20), (3, 1)),
]
# every truncation the stitcher can hand the kernel: npw 1..3
TRUNCATED = [p.truncated(k) for p in PARAMS for k in range(1, p.num_pw + 1)]


def _port(p):
    """The JAX package's parameters as the port's."""
    return params_from_arrays(p.match, p.mismatch, np.asarray(p.gap_open),
                              np.asarray(p.gap_extend))


def _jax_fill(s1, s2, params, swap_pref):
    """(bp (V1+V2+1, W) of the JAX scan, score, lane_is_i)."""
    V1, V2 = len(s1), len(s2)
    lane_is_i = V1 <= V2
    W = (V1 if lane_is_i else V2) + 1
    nd = jax_gotoh._bucket(V1 + V2 + 1, 256)
    a, b = jax_gotoh._build_skew_inputs(s1, s2, lane_is_i,
                                        jax_gotoh._bucket(W, 128), nd)
    bp, M = jax_gotoh._gotoh_scan(
        jnp.asarray(a), jnp.asarray(b), jnp.int32(V1), jnp.int32(V2),
        params.match, params.mismatch,
        jnp.asarray(params.gap_open, jnp.int32),
        jnp.asarray(params.gap_extend, jnp.int32),
        nd, lane_is_i, params.num_pw, swap_pref)
    bp = np.asarray(bp)[:V1 + V2 + 1, :W].astype(np.int64)
    return bp, int(np.asarray(M)[V1 + V2, W - 1]), lane_is_i


def _in_matrix(V1, V2, lane_is_i, W):
    d, lane = np.indices((V1 + V2 + 1, W))
    i, j = (lane, d - lane) if lane_is_i else (d - lane, lane)
    return (i >= 0) & (i <= V1) & (j >= 0) & (j <= V2)


@pytest.mark.parametrize("params", TRUNCATED,
                         ids=lambda p: f"{p.match}-{p.mismatch}-npw{p.num_pw}")
@pytest.mark.parametrize("lane_is_i", [True, False], ids=["lanes_i", "lanes_j"])
@pytest.mark.parametrize("swap_pref", [False, True], ids=["pref_I", "pref_D"])
def test_fill_matches_jax_scan(params, lane_is_i, swap_pref):
    rng = np.random.default_rng(params.num_pw * 7 + 3 * lane_is_i + swap_pref
                                + params.match)
    short = int(rng.integers(20, 70))
    long = short + int(rng.integers(0, 40))
    V1, V2 = (short, long) if lane_is_i else (long + 1, short)
    s1 = rng.integers(0, 4, V1).astype(np.int32)
    s2 = s1[:V2].copy() if V2 <= V1 else np.concatenate(
        [s1, rng.integers(0, 4, V2 - V1)]).astype(np.int32)
    s2[rng.integers(0, V2, max(1, V2 // 6))] = rng.integers(0, 4)
    _check_plain_fill(s1, s2, params, swap_pref, lane_is_i)


def _check_plain_fill(s1, s2, params, swap_pref, lane_is_i):
    """The plain fill's backpointers and score against the JAX scan's."""
    V1, V2 = len(s1), len(s2)
    bp_j, score_j, lii = _jax_fill(s1, s2, params, swap_pref)
    assert lii == lane_is_i

    job = (s1, s2, swap_pref, _port(params))
    bp_t, score_t = torch_gotoh.gotoh_fill_plain(params_table([job]),
                                                 pack_seqs([job]))
    bp_t = bp_t.view(torch.int16).numpy().astype(np.int64).reshape(bp_j.shape)
    inside = _in_matrix(V1, V2, lane_is_i, bp_j.shape[1])
    assert np.array_equal(bp_t[inside], bp_j[inside])
    assert not bp_t[~inside].any()
    assert int(score_t[0]) == score_j


# short sides at the CUDA fill's edges: a thread's strip of R lanes and a
# warp's 32 R lanes (R = 1, 2, 4) and one either side; the plain fill is
# the yardstick the kernel is held to there
@pytest.mark.parametrize("short", [1, 2, 31, 32, 33, 63, 65, 127, 129])
@pytest.mark.parametrize("lane_is_i", [True, False], ids=["lanes_i", "lanes_j"])
@pytest.mark.parametrize("swap_pref", [False, True], ids=["pref_I", "pref_D"])
def test_fill_edge_widths_match_jax_scan(short, lane_is_i, swap_pref):
    params = PARAMS[0].truncated(1 + short % 3)
    rng = np.random.default_rng(short * 4 + 2 * lane_is_i + swap_pref)
    long = short + int(rng.integers(0, 40))
    V1, V2 = (short, long) if lane_is_i else (long + 1, short)
    s1 = rng.integers(0, 4, V1).astype(np.int32)
    s2 = np.resize(s1, V2).astype(np.int32)
    s2[rng.integers(0, V2, max(1, V2 // 6))] = rng.integers(0, 4)
    _check_plain_fill(s1, s2, params, swap_pref, lane_is_i)


@pytest.mark.parametrize("params", PARAMS,
                         ids=lambda p: f"{p.match}-{p.mismatch}-npw{p.num_pw}")
@pytest.mark.parametrize("trial", range(4))
def test_align_matches_jax_and_popoa(params, trial):
    rng = np.random.default_rng(trial * 31 + len(params.gap_open))
    g1 = random_chain(rng, int(rng.integers(1, 90)))
    g2 = random_chain(rng, int(rng.integers(1, 90)))
    aln_o, score_o = popoa(
        g1, g2, graph_sources(g1), graph_sources(g2),
        graph_sinks(g1), graph_sinks(g2), params)
    for swap_pref in (False, True):
        aln_t, score_t = torch_gotoh.gotoh_align(
            g1.labels, g2.labels, _port(params), swap_pref=swap_pref)
        aln_j, score_j = jax_gotoh.gotoh_align(g1.labels, g2.labels, params,
                                               swap_pref=swap_pref)
        assert score_t == score_j == score_o
        assert aln_t.dtype == aln_j.dtype
        assert np.array_equal(aln_t, aln_j)
        if not swap_pref:
            assert np.array_equal(aln_t, aln_o)


def test_align_low_entropy():
    rng = np.random.default_rng(5)
    params = AlignmentParams()
    unit = rng.integers(0, 4, size=15)
    s1 = np.tile(unit, 12)[: 170]
    s2 = np.tile(unit, 12)[3: 150].copy()
    s2[::17] = (s2[::17] + 1) % 4
    from centrolign_tpu.graph import BaseGraph

    def chain(seq):
        g = BaseGraph()
        ids = g.add_nodes(seq)
        g.add_edges(ids[:-1], ids[1:])
        g.extend_path_array(g.add_path("p"), ids)
        return g

    g1, g2 = chain(s1), chain(s2)
    aln_o, score_o = popoa(
        g1, g2, graph_sources(g1), graph_sources(g2),
        graph_sinks(g1), graph_sinks(g2), params)
    aln_t, score_t = torch_gotoh.gotoh_align(s1, s2, _port(params))
    aln_j, score_j = jax_gotoh.gotoh_align(s1, s2, params)
    assert score_t == score_j == score_o
    assert np.array_equal(aln_t, aln_o)
    assert np.array_equal(aln_t, aln_j)


def test_align_empty_side():
    params = AlignmentParams()
    s = np.array([0, 1, 2, 3], np.int32)
    for s1, s2 in ((s, s[:0]), (s[:0], s)):
        aln_t, score_t = torch_gotoh.gotoh_align(s1, s2, _port(params))
        aln_j, score_j = jax_gotoh.gotoh_align(s1, s2, params)
        assert score_t == score_j
        assert np.array_equal(aln_t, aln_j)


@pytest.mark.parametrize("params", PARAMS,
                         ids=lambda p: f"{p.match}-{p.mismatch}-npw{p.num_pw}")
@pytest.mark.parametrize("shape", [(57, 80), (90, 31), (1, 40), (0, 9)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_align_device_on_cpu_matches_jax(params, shape):
    """The single-problem entry (K4's counterpart) on CPU tensors runs the
    plain versions; its result must equal the JAX package's gotoh_align."""
    rng = np.random.default_rng(shape[0] * 101 + shape[1] + params.num_pw)
    s1 = rng.integers(0, 4, shape[0]).astype(np.int32)
    s2 = np.resize(s1, shape[1]).astype(np.int32) if shape[0] else \
        rng.integers(0, 4, shape[1]).astype(np.int32)
    if len(s2):
        s2[rng.integers(0, len(s2), max(1, len(s2) // 7))] = rng.integers(0, 4)
    for swap_pref in (False, True):
        aln_t, score_t = gotoh_align_device(s1, s2, _port(params), swap_pref,
                                            device=torch.device("cpu"))
        aln_j, score_j = jax_gotoh.gotoh_align(s1, s2, params,
                                               swap_pref=swap_pref)
        assert score_t == score_j
        assert aln_t.dtype == np.int64
        assert np.array_equal(aln_t, aln_j)


def test_align_device_follows_the_environment(monkeypatch):
    s = np.array([0, 1, 2, 3, 3], np.int32)
    monkeypatch.setenv("CENTROLIGN_TORCH_DEVICE", "cpu")
    aln, score = gotoh_align_device(s, s, _port(PARAMS[0]))
    assert score == 5 * PARAMS[0].match and len(aln) == 5
    monkeypatch.setenv("CENTROLIGN_TORCH_DEVICE", "none")
    with pytest.raises(ValueError):
        gotoh_align_device(s, s, _port(PARAMS[0]))

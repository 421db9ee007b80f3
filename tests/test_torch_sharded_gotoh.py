"""The port's lane-sharded Gotoh (parallel/sharded_gotoh.py over the plain
chunk fill of ops/sharded_gotoh.py, on CPU shards) against the JAX
package's (centrolign_tpu/parallel/sharded_gotoh.py on the virtual 8-device
CPU mesh of tests/conftest.py) and the port's single-device gotoh_align,
and the stitcher's sequence-parallel tier against the JAX CLI's.

Tolerance: exact (integer DP): scores, uint16 backpointers (every lane,
padding included) and alignments equal.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centrolign_tpu.ops.align_params import AlignmentParams as JaxParams
from centrolign_tpu.ops.gotoh import _build_skew_inputs as jax_skew
from centrolign_tpu.parallel import sharded_gotoh as jax_sh
from centrolign_tpu_torch.ops import sharded_gotoh_cuda
from centrolign_tpu_torch.ops.align_params import AlignmentParams
from centrolign_tpu_torch.ops.gotoh import gotoh_align
from centrolign_tpu_torch.parallel import sharded_gotoh as sh
from centrolign_tpu_torch.utils.encoding import encode_seq

from conftest import mutate_sequence, random_sequence
from test_torch_cli import REPO, _env, _run_jax_cli, _run_port, _write_pair

CPU = torch.device("cpu")
GAPS = ((60, 800, 2500), (30, 5, 1))


def _params(npw):
    go, ge = GAPS[0][:npw], GAPS[1][:npw]
    return JaxParams(20, 80, go, ge), AlignmentParams(20, 80, go, ge)


def _pair(rng, n1, n2):
    s1 = random_sequence(rng, n1) if n1 else ""
    s2 = (mutate_sequence(rng, s1, sub_rate=0.1, indel_rate=0.05)[:n2]
          if n1 >= n2 else s1 + random_sequence(rng, n2 - n1))
    return encode_seq(s1).astype(np.int32), encode_seq(s2).astype(np.int32)


def _jax_fill_bp(s1, s2, jp, lanes, swap):
    """The JAX package's _sharded_fill_bp on `lanes` virtual CPU devices."""
    mesh = jax_sh.make_alignment_mesh(lanes, gap_axis=1,
                                      devices=jax.devices("cpu"))
    V1, V2 = len(s1), len(s2)
    lane_is_i = V1 <= V2
    W = max(128 * lanes, -(-((V1 if lane_is_i else V2) + 1)
                           // (128 * lanes)) * 128 * lanes)
    nd = V1 + V2 + 1
    a, b = jax_skew(s1, s2, lane_is_i, W, nd + 128)
    score, bp = jax_sh._sharded_fill_bp(
        jnp.asarray(a[None]), jnp.asarray(b[None]),
        jnp.asarray([V1], np.int32), jnp.asarray([V2], np.int32),
        jnp.int32(jp.match), jnp.int32(jp.mismatch),
        jnp.asarray(jp.gap_open, jnp.int32),
        jnp.asarray(jp.gap_extend, jnp.int32), mesh=mesh, num_diags=nd,
        lane_is_i=lane_is_i, npw=jp.num_pw, Wl_total=W, swap_pref=swap)
    return (a, b, lane_is_i, W, nd, int(np.asarray(score)[0]),
            np.asarray(bp)[:, 0, :])


CASES = [  # (V1, V2, lanes, npw, swap_pref)
    (0, 0, 1, 3, False), (0, 5, 2, 1, True), (4, 0, 3, 2, False),
    (1, 1, 8, 3, True), (4, 4, 4, 2, False), (1, 5, 5, 1, False),
    (40, 47, 1, 3, False), (47, 40, 2, 3, True), (130, 300, 3, 2, False),
    (300, 130, 4, 1, True), (255, 257, 5, 3, True), (290, 211, 6, 2, False),
    (177, 290, 7, 1, True), (260, 240, 8, 3, False),
]


@pytest.mark.parametrize("V1,V2,lanes,npw,swap", CASES)
def test_sharded_fill_bp_matches_jax(V1, V2, lanes, npw, swap):
    rng = np.random.default_rng(V1 * 1000 + V2 + lanes)
    s1, s2 = _pair(rng, V1, V2)
    jp, pp = _params(npw)
    a, b, lane_is_i, W, nd, jscore, jbp = _jax_fill_bp(s1, s2, jp, lanes,
                                                       swap)
    score, bp = sh._fill(a[None], b[None], np.array([V1], np.int32),
                         np.array([V2], np.int32), pp, [[CPU] * lanes], nd,
                         lane_is_i, swap, emit_bp=True)
    assert int(score[0]) == jscore
    assert np.array_equal(bp[:, 0, :], jbp)
    aln, sc = sh.sharded_gotoh_align(s1, s2, pp, [CPU] * lanes,
                                     swap_pref=swap)
    jaln, jsc = jax_sh.sharded_gotoh_align(
        s1, s2, jp, jax_sh.make_alignment_mesh(lanes, gap_axis=1,
                                               devices=jax.devices("cpu")),
        swap_pref=swap)
    galn, gsc = gotoh_align(s1, s2, pp, swap_pref=swap)
    assert sc == jsc == gsc == jscore
    assert np.array_equal(aln, jaln) and np.array_equal(aln, galn)


@pytest.mark.parametrize("gap_axis,lanes", [(1, 8), (2, 4), (4, 2), (2, 1)])
def test_sharded_scores_match_jax(gap_axis, lanes):
    rng = np.random.default_rng(gap_axis * 10 + lanes)
    jp, pp = _params(3)
    B = 2 * gap_axis
    seqs1, seqs2 = [], []
    for _ in range(B):
        s1 = random_sequence(rng, int(rng.integers(40, 300)))
        s2 = mutate_sequence(rng, s1, sub_rate=0.1, indel_rate=0.05)
        seqs1.append(encode_seq(s1).astype(np.int32))
        seqs2.append(encode_seq(s2).astype(np.int32))
    jmesh = jax_sh.make_alignment_mesh(gap_axis * lanes, gap_axis=gap_axis,
                                       devices=jax.devices("cpu"))
    want = jax_sh.sharded_gotoh_scores(seqs1, seqs2, jp, jmesh)
    mesh = sh.make_alignment_mesh(gap_axis * lanes, gap_axis=gap_axis,
                                  devices=[CPU] * (gap_axis * lanes))
    got = sh.sharded_gotoh_scores(seqs1, seqs2, pp, mesh)
    assert got.tolist() == want.tolist()
    assert got.tolist() == [gotoh_align(a, b, pp)[1]
                            for a, b in zip(seqs1, seqs2)]


def test_sharded_scores_empty_and_tiny():
    """tests/test_parallel.py:40-47's pairs."""
    jp, pp = _params(3)
    seqs1 = [encode_seq("ACGT"), encode_seq("A")]
    seqs2 = [encode_seq("ACGT"), encode_seq("TTTTT")]
    want = jax_sh.sharded_gotoh_scores(
        seqs1, seqs2, jp, jax_sh.make_alignment_mesh(
            8, gap_axis=2, devices=jax.devices("cpu")))
    got = sh.sharded_gotoh_scores(
        seqs1, seqs2, pp, sh.make_alignment_mesh(8, gap_axis=2,
                                                 devices=[CPU] * 8))
    assert got.tolist() == want.tolist()


def test_batch_must_divide_gap_axis():
    _jp, pp = _params(1)
    seqs = [encode_seq("ACGT")] * 3
    with pytest.raises(ValueError):
        sh.sharded_gotoh_scores(seqs, seqs, pp, [[CPU], [CPU]])


def test_counters_and_halo_copies_on_cpu():
    """On CPU shards every chunk runs the plain version: no launches, and
    the problems count as the plain version's; the shards share one
    device, so no halo is copied."""
    rng = np.random.default_rng(5)
    s1, s2 = _pair(rng, 300, 280)
    _jp, pp = _params(3)
    sharded_gotoh_cuda.reset_counters()
    sh.sharded_gotoh_align(s1, s2, pp, [CPU] * 2)
    assert sharded_gotoh_cuda.LAUNCHES == 0
    assert sharded_gotoh_cuda.HALO_COPIES == 0
    assert sharded_gotoh_cuda.PROBLEMS == 0
    assert sharded_gotoh_cuda.PLAIN_PROBLEMS == 2


def test_make_alignment_mesh_cuts_like_jax():
    devs = [CPU] * 8
    assert [len(r) for r in sh.make_alignment_mesh(8, devices=devs)] == [4, 4]
    assert [len(r) for r in sh.make_alignment_mesh(
        6, gap_axis=3, devices=devs)] == [2, 2, 2]
    assert [len(r) for r in sh.make_alignment_mesh(3, devices=devs)] == [3]


def test_shard_tier_cigar_matches_jax_cli(tmp_path):
    """The stitcher's sequence-parallel tier on 4 CPU shards, its
    threshold lowered so that the small pair's gaps take it: the CIGAR is
    the JAX CLI's with its tier on the 8 virtual CPU devices."""
    pair = _write_pair(tmp_path / "pair1.fasta", 1)
    argv = ["-v", "0", "-u", pair]
    r = subprocess.run(
        [sys.executable, "-m", "centrolign_tpu.cli", *argv],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=_env(JAX_PLATFORMS="cpu", CENTROLIGN_TPU_USE_DEVICE="force",
                 CENTROLIGN_TPU_SHARD_MIN_CELLS="10000",
                 CENTROLIGN_TPU_INSTRUMENT="1",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stderr.count("posh") > 0
    port, stats = _run_port(argv, CENTROLIGN_TORCH_DEVICE="cpu",
                            CENTROLIGN_TORCH_SHARD_DEVICES="cpu,cpu,cpu,cpu",
                            CENTROLIGN_TPU_SHARD_MIN_CELLS="10000")
    assert port.returncode == 0, port.stderr
    assert port.stdout == r.stdout
    assert stats["posh"] == r.stderr.count("posh") > 0
    assert stats["foreign"] == []
    ref = _run_jax_cli(argv)
    assert ref.stdout == port.stdout


def test_shard_tier_engages_only_over_listed_devices(tmp_path):
    """Without CENTROLIGN_TORCH_SHARD_DEVICES the tier stays off, whatever
    its threshold: the same gaps go to the single-device tier, with the
    same CIGAR."""
    pair = _write_pair(tmp_path / "pair1.fasta", 1)
    argv = ["-v", "0", "-u", pair]
    port, stats = _run_port(argv, CENTROLIGN_TORCH_DEVICE="cpu",
                            CENTROLIGN_TORCH_DEVICE_MIN_CELLS="10000",
                            CENTROLIGN_TPU_SHARD_MIN_CELLS="10000")
    assert port.returncode == 0, port.stderr
    assert stats["posh"] == 0 and stats["jobs"] > 0
    ref = _run_jax_cli(argv)
    assert port.stdout == ref.stdout

"""The port's lane-sharded Gotoh (parallel/sharded_gotoh.py over the plain
chunk fill of ops/sharded_gotoh.py, on CPU shards) against the JAX
package's (centrolign_tpu/parallel/sharded_gotoh.py on the virtual 8-device
CPU mesh of tests/conftest.py) and the port's single-device gotoh_align,
and the stitcher's sequence-parallel tier against the JAX CLI's; the
shards' stream and event schedule (chunk_schedule) by brute force, and the
cut of a shard into blocks and the kernel's launch shape at their edges.

Tolerance: exact (integer DP): scores, uint16 backpointers (every lane,
padding included) and alignments equal.
"""

import itertools

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
from centrolign_tpu_torch.ops.sharded_gotoh import block_count, block_starts
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
    # at HALO = 128: one chunk of exactly H diagonals (H = Wl = 128), H + 1
    # (a last chunk of one diagonal), shards cut into 3 and 5 blocks, nd
    # not a multiple of H
    (60, 67, 1, 3, True), (68, 60, 1, 2, False), (300, 280, 1, 3, True),
    (700, 520, 1, 2, True), (600, 700, 2, 1, False),
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
    device, so no halo is copied, and there is no stream to wait on."""
    rng = np.random.default_rng(5)
    s1, s2 = _pair(rng, 300, 280)
    _jp, pp = _params(3)
    sharded_gotoh_cuda.reset_counters()
    sh.sharded_gotoh_align(s1, s2, pp, [CPU] * 2)
    assert sharded_gotoh_cuda.LAUNCHES == 0
    assert sharded_gotoh_cuda.HALO_COPIES == 0
    assert sharded_gotoh_cuda.EVENT_WAITS == 0
    assert sharded_gotoh_cuda.PROBLEMS == 0
    assert sharded_gotoh_cuda.PLAIN_PROBLEMS == 2


@pytest.mark.parametrize("halo,block_lanes", [(32, 64), (48, 100), (16, 40)])
def test_fill_does_not_depend_on_the_cut(monkeypatch, halo, block_lanes):
    """Smaller chunks and blocks than the module's (4-10 blocks a shard,
    unequal widths, nd not a multiple of H) give the same backpointers
    and score as the module's constants, and the alignment of
    gotoh_align."""
    rng = np.random.default_rng(halo + block_lanes)
    s1, s2 = _pair(rng, 410, 380)
    _jp, pp = _params(3)
    V1, V2 = len(s1), len(s2)
    W = sh._bucket(V2 + 1, 128 * 1)
    nd = V1 + V2 + 1
    a, b = sh._build_skew_inputs(s1, s2, False, W, nd + 128)
    args = (a[None], b[None], np.array([V1], np.int32),
            np.array([V2], np.int32), pp, [[CPU]], nd, False, False, True)
    want = sh._fill(*args)
    monkeypatch.setattr(sh, "HALO", halo)
    monkeypatch.setattr(sh, "BLOCK_LANES", block_lanes)
    assert block_count(W, halo, block_lanes) >= 4
    got = sh._fill(*args)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    aln, score = sh.sharded_gotoh_align(s1, s2, pp, [CPU] * 2)
    galn, gscore = gotoh_align(s1, s2, pp)
    assert score == gscore and np.array_equal(aln, galn)


@pytest.mark.parametrize("Wl,H,block_lanes,want", [
    (128, 128, 256, 1), (256, 128, 256, 1), (257, 128, 256, 2),
    (384, 128, 256, 2), (640, 128, 256, 3), (1792, 128, 256, 7),
    (4608, 128, 256, 18), (300, 128, 160, 2), (255, 128, 128, 1),
    (100, 100, 256, 1), (7, 7, 256, 1), (1792, 128, 128, 14),
    (4608, 128, 128, 36), (300, 128, 128, 2), (383, 128, 128, 2),
    (384, 128, 128, 3)])
def test_block_count_at_its_edges(Wl, H, block_lanes, want):
    """Blocks of at most block_lanes lanes, fewer where a block would own
    fewer than H; the starts cut Wl exactly."""
    n = block_count(Wl, H, block_lanes)
    assert n == want
    starts = block_starts(Wl, n)
    widths = np.diff(starts)
    assert starts[0] == 0 and starts[-1] == Wl
    assert widths.min() >= H and widths.max() - widths.min() <= 1
    assert n == 1 or widths.max() <= max(block_lanes, 2 * H - 1)


@pytest.mark.parametrize("E,want", [
    (1, (1, 32)), (128, (1, 128)), (129, (2, 96)), (256, (2, 128)),
    (257, (4, 96)), (384, (4, 96)), (512, (4, 128)), (513, (8, 96)),
    (1024, (8, 128)), (1025, (8, 160)), (2048, (8, 256))])
def test_launch_shape_at_its_edges(E, want):
    R, threads = sharded_gotoh_cuda.launch_shape(E)
    assert (R, threads) == want
    assert threads * R >= E and threads % 32 == 0
    assert threads <= sharded_gotoh_cuda.MAX_THREADS


def test_launch_shape_refuses_too_many_lanes():
    with pytest.raises(ValueError):
        sharded_gotoh_cuda.launch_shape(2049)


def test_module_cut_fits_a_launch():
    """At the module's HALO and BLOCK_LANES, every shard width up to 5,000
    lanes is cut into blocks that own at least H lanes each and at most
    max(BLOCK_LANES, 2 H - 1), and the widest block's extended lanes fit
    one launch."""
    for Wl in range(1, 5001):
        H = min(sh.HALO, Wl)
        n = block_count(Wl, H, sh.BLOCK_LANES)
        widths = np.diff(block_starts(Wl, n))
        assert widths.min() >= H
        assert widths.max() <= max(sh.BLOCK_LANES, 2 * H - 1)
        R, threads = sharded_gotoh_cuda.launch_shape(H + int(widths.max()))
        assert threads * R >= H + widths.max()


def _replay(ops, peer):
    """Vector clocks over chunk_schedule's ops: each shard's stream and the
    caller's; returns, per op index, the clock when it ran, and per shard
    the op index of each fill and copy."""
    clock = {"caller": {"caller": 0}}
    events, at, fills, copies = {}, {}, {}, {}

    def merge(a, b):
        return {k: max(a.get(k, -1), b.get(k, -1)) for k in set(a) | set(b)}

    for i, op in enumerate(ops):
        kind, k = op[0], op[1]
        if kind == "start":
            assert k not in clock
            clock[k] = merge({}, clock["caller"])
        elif kind == "wait":
            clock[k] = merge(clock[k], events[(op[2], op[3])])
        elif kind == "join":
            clock["caller"] = merge(clock["caller"], clock[k])
            continue
        clock[k] = merge(clock[k], {k: i})
        at[i] = dict(clock[k])
        if kind == "record":
            assert (k, op[2]) not in events, "an event recorded twice"
            events[(k, op[2])] = dict(clock[k])
        elif kind == "fill":
            assert (k, op[2]) not in fills, "a halo slot written twice"
            fills[(k, op[2])] = i
        elif kind == "copy":
            assert k in peer and (k, op[2]) not in copies
            copies[(k, op[2])] = i
    return clock, at, fills, copies


@pytest.mark.parametrize("gap_n,lane_n,chunks", list(itertools.product(
    (1, 2), (1, 2, 3, 4), (1, 2, 5))))
def test_chunk_schedule_orders_every_halo_read(gap_n, lane_n, chunks):
    """By brute force over every placement of shards on devices (peer
    copies or not, the second gap row's the opposite of the first's):
    each shard fills each chunk once, in order on its
    stream; every halo it reads (its left neighbour's slot c - 1, or the
    copy of it) was written before, by happens-before over streams and
    events, and so was the copy; no slot or event is written twice; every
    wait is on an event recorded after its chunk; the caller's stream ends
    after every fill; and the ops in list order are a valid serial order
    (the CPU's)."""
    for flags in itertools.product((False, True), repeat=lane_n):
        peer = {(g, s) for g in range(gap_n) for s in range(1, lane_n)
                if flags[s] != (g == 1)}
        ops = sh.chunk_schedule(gap_n, lane_n, chunks, peer)
        clock, at, fills, copies = _replay(ops, peer)
        keys = [(g, s) for g in range(gap_n) for s in range(lane_n)]
        assert set(fills) == {(k, c) for k in keys for c in range(chunks)}
        for (k, c), i in fills.items():
            g, s = k
            if c:
                assert at[i][k] > fills[(k, c - 1)] > -1
            if not (s and c):
                continue
            left = fills[((g, s - 1), c - 1)]
            if k in peer:
                j = copies[(k, c - 1)]
                assert at[j].get((g, s - 1), -1) >= left
                assert j < i and at[i][k] >= j
            else:
                assert (k, c - 1) not in copies
                assert at[i].get((g, s - 1), -1) >= left
            assert left < i
        for i, op in enumerate(ops):
            if op[0] == "wait":
                assert fills[(op[2], op[3])] < i
        for k in keys:
            assert clock["caller"][k] >= fills[(k, chunks - 1)]
        assert sum(op[0] == "wait" for op in ops) == \
            gap_n * (lane_n - 1) * (chunks - 1)


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

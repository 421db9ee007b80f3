"""The lane-sharded Gotoh kernel (csrc/sharded_gotoh.cu) against its plain
version (ops/sharded_gotoh.py::chunk_fill_plain) on the card: 1-4 shards
on one card, and across cards when there are two or more; npw 1-3, both
lane orientations, swap_pref both, tiny pairs, shards narrower than a
chunk's halo, a batch over two gap rows, the chunk's edges (one chunk of
exactly H diagonals, H + 1, H = the shard's lanes), the one-shard 4,500 x
4,500 fill (36 blocks a launch), two shards whose streams run side by
side, and a launch that is refused. The alignment also equals the
single-problem entry's (ops/gotoh_cuda.py::gotoh_align_device).

Marked `cuda`: each test skips without a card. On a machine with one:

    python -m pytest -m cuda tests/test_torch_sharded_gotoh_cuda.py -q

Tolerance: exact (integer DP): scores and uint16 backpointers bit-equal.
"""

import numpy as np
import pytest
import torch

from centrolign_tpu_torch.ops import sharded_gotoh as shops

from centrolign_tpu_torch.ops import gotoh_cuda, sharded_gotoh_cuda
from centrolign_tpu_torch.ops.align_params import AlignmentParams
from centrolign_tpu_torch.ops.gotoh import _build_skew_inputs
from centrolign_tpu_torch.ops.sharded_gotoh import chunk_fill_plain
from centrolign_tpu_torch.parallel import sharded_gotoh as sh

pytestmark = pytest.mark.cuda

GAPS = ((60, 800, 2500), (30, 5, 1))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _params(npw):
    return AlignmentParams(20, 80, GAPS[0][:npw], GAPS[1][:npw])


def _pair(rng, n1, n2):
    s1 = rng.integers(0, 4, n1).astype(np.int32)
    s2 = np.resize(s1, n2).astype(np.int32) if n1 else \
        rng.integers(0, 4, n2).astype(np.int32)
    if n2:
        s2[rng.integers(0, n2, max(1, n2 // 10))] = rng.integers(0, 4)
    return s1, s2


def _args(s1, s2, params, devices, swap):
    V1, V2 = len(s1), len(s2)
    lane_is_i = V1 <= V2
    W = sh._bucket((V1 if lane_is_i else V2) + 1, 128 * len(devices))
    nd = V1 + V2 + 1
    a, b = _build_skew_inputs(s1, s2, lane_is_i, W, nd + 128)
    return (a[None], b[None], np.array([V1], np.int32),
            np.array([V2], np.int32), params, [devices], nd, lane_is_i, swap,
            True)


def _both(s1, s2, params, devices, swap):
    args = _args(s1, s2, params, devices, swap)
    sharded_gotoh_cuda.reset_counters()
    got = sh.gather(sh.fill_shards(*args))
    torch.cuda.synchronize()
    launches = sharded_gotoh_cuda.LAUNCHES
    want = sh.gather(sh.fill_shards(*args, chunk=chunk_fill_plain))
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    return launches


CASES = [  # (V1, V2, npw, swap_pref)
    (0, 0, 3, False), (0, 7, 1, True), (5, 0, 2, False), (1, 1, 3, True),
    (3, 200, 2, False), (200, 3, 3, True), (700, 640, 1, True),
    (640, 700, 3, False), (1500, 1300, 2, True), (1300, 1500, 3, True),
]


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
@pytest.mark.parametrize("V1,V2,npw,swap", CASES)
def test_kernel_matches_plain_on_one_card(card, shards, V1, V2, npw, swap):
    rng = np.random.default_rng(V1 * 7 + V2 + shards)
    s1, s2 = _pair(rng, V1, V2)
    launches = _both(s1, s2, _params(npw), [card] * shards, swap)
    assert launches >= shards


def test_alignment_equals_single_entry(card):
    rng = np.random.default_rng(11)
    s1, s2 = _pair(rng, 2100, 1900)
    params = _params(3)
    for shards in (1, 2, 3, 4):
        aln, score = sh.sharded_gotoh_align(s1, s2, params, [card] * shards)
        want, want_score = gotoh_cuda.gotoh_align_device(s1, s2, params,
                                                          device=card)
        assert score == want_score
        assert np.array_equal(aln, want)


def test_scores_over_gap_rows(card):
    rng = np.random.default_rng(3)
    params = _params(3)
    seqs = [_pair(rng, int(rng.integers(50, 900)), int(rng.integers(50, 900)))
            for _ in range(6)]
    got = sh.sharded_gotoh_scores([p[0] for p in seqs], [p[1] for p in seqs],
                                  params, [[card] * 2, [card] * 2])
    want = [gotoh_cuda.gotoh_align_device(a, b, params, device=card)[1]
            for a, b in seqs]
    assert got.tolist() == want


def test_across_cards(card):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    rng = np.random.default_rng(5)
    s1, s2 = _pair(rng, 1500, 1700)
    devices = [torch.device("cuda", k) for k in range(n)]
    sharded_gotoh_cuda.reset_counters()
    _both(s1, s2, _params(3), devices, False)
    assert sharded_gotoh_cuda.HALO_COPIES > 0


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("V1,V2,npw,swap", [
    (60, 67, 3, False),    # one chunk of exactly H = Wl = 128 diagonals
    (68, 60, 2, True),     # H + 1: a last chunk of one diagonal
    (40, 47, 1, True),     # fewer diagonals than H
    (127, 128, 3, False),  # two chunks of exactly H
    (300, 280, 2, False),  # a shard of 384 lanes in 3 blocks
    (700, 520, 3, True)])  # 640 lanes in 5 blocks, nd % H != 0
def test_chunk_edges(card, shards, V1, V2, npw, swap):
    rng = np.random.default_rng(V1 + 3 * V2 + shards)
    s1, s2 = _pair(rng, V1, V2)
    launches = _both(s1, s2, _params(npw), [card] * shards, swap)
    Wl = sh._bucket(min(V1, V2) + 1, 128 * shards) // shards
    assert launches == shards * -(-(V1 + V2 + 1) // min(sh.HALO, Wl))


def test_one_shard_4500(card):
    """The 4,500 x 4,500 pair on one shard: 4,608 lanes in 36 blocks of
    one launch, wider than one block could hold."""
    rng = np.random.default_rng(45)
    s1, s2 = _pair(rng, 4500, 4500)
    assert shops.block_count(4608, sh.HALO, sh.BLOCK_LANES) == 36
    launches = _both(s1, s2, _params(3), [card], False)
    assert launches == -(-9001 // sh.HALO)


def test_two_shards_run_side_by_side(card):
    """Two shards of one card on their own streams run side by side: each
    shard's chunk takes as long as a chunk of the same gap on one shard
    (the blocks are as wide), so one after another the two shards would
    take twice the one-shard fill's time; side by side they take less
    than 1.5 times it (CUDA events around each fill). Both are bit-equal
    to the plain version."""
    rng = np.random.default_rng(12)
    s1, s2 = _pair(rng, 3000, 2600)
    ms = {}
    for shards in (1, 2):
        args = _args(s1, s2, _params(3), [card] * shards, False)
        sh.fill_shards(*args)  # the library built and loaded
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(3):
            rows = sh.fill_shards(*args)
        e1.record()
        torch.cuda.synchronize()
        ms[shards] = e0.elapsed_time(e1) / 3
        got = sh.gather(rows)
        want = sh.gather(sh.fill_shards(*args, chunk=chunk_fill_plain))
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])
    assert ms[2] < 1.5 * ms[1], ms


def test_refused_launch_raises(card, monkeypatch):
    """A launch shape the kernel refuses (fewer lanes than a block needs)
    raises from the library's schedule; nothing falls back."""
    rng = np.random.default_rng(2)
    s1, s2 = _pair(rng, 300, 280)
    args = _args(s1, s2, _params(3), [card], False)
    monkeypatch.setattr(sharded_gotoh_cuda, "launch_shape",
                        lambda E: (1, 32))
    with pytest.raises(RuntimeError):
        sh.fill_shards(*args)
    torch.cuda.synchronize()

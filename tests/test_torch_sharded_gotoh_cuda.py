"""The lane-sharded Gotoh kernel (csrc/sharded_gotoh.cu) against its plain
version (ops/sharded_gotoh.py::chunk_fill_plain) on the card: 1-4 shards
on one card, and across cards when there are two or more; npw 1-3, both
lane orientations, swap_pref both, tiny pairs, shards narrower than a
chunk's halo and a batch over two gap rows. The alignment also equals the
single-problem entry's (ops/gotoh_cuda.py::gotoh_align_device).

Marked `cuda`: each test skips without a card. On a machine with one:

    python -m pytest -m cuda tests/test_torch_sharded_gotoh_cuda.py -q

Tolerance: exact (integer DP): scores and uint16 backpointers bit-equal.
"""

import numpy as np
import pytest
import torch

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


def _both(s1, s2, params, devices, swap):
    V1, V2 = len(s1), len(s2)
    lane_is_i = V1 <= V2
    W = sh._bucket((V1 if lane_is_i else V2) + 1, 128 * len(devices))
    nd = V1 + V2 + 1
    a, b = _build_skew_inputs(s1, s2, lane_is_i, W, nd + 128)
    args = (a[None], b[None], np.array([V1], np.int32),
            np.array([V2], np.int32), params, [devices], nd, lane_is_i, swap,
            True)
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

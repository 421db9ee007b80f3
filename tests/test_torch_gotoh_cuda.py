"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without a card. On a machine with one:

    python -m pytest -m cuda tests/test_torch_gotoh_cuda.py -q

Tolerance: exact (integer DP): backpointers, scores and traceback rows of
csrc/gotoh.cu must be bit-equal to ops/gotoh.py's plain fill and host walk.
"""

import numpy as np
import pytest
import torch

from centrolign_tpu_torch.ops import gotoh as plain
from centrolign_tpu_torch.ops import gotoh_cuda as gc
from centrolign_tpu_torch.ops.align_params import AlignmentParams

pytestmark = pytest.mark.cuda

PARAMS = AlignmentParams(20, 80, (60, 800, 2500), (30, 5, 1))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _jobs(rng, n, lo, hi):
    jobs = []
    for k in range(n):
        s1 = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.int32)
        s2 = np.resize(s1, int(rng.integers(lo, hi))).astype(np.int32)
        s2[rng.integers(0, len(s2), max(1, len(s2) // 8))] = rng.integers(0, 4)
        jobs.append((s1, s2, bool(k % 2), PARAMS.truncated(1 + k % 3)))
    return jobs


@pytest.mark.parametrize("lo,hi", [(1, 40), (100, 600)])
def test_kernels_match_plain(card, lo, hi):
    jobs = _jobs(np.random.default_rng(lo), 24, lo, hi)
    table = gc.params_table(jobs).to(card)
    seqs = gc.pack_seqs(jobs).to(card)
    bp_size, max_w, cap = gc.launch_sizes(jobs)
    fills, tbs = gc.FILL_LAUNCHES, gc.TRACEBACK_LAUNCHES
    bp, score = gc.gotoh_fill(table, seqs, bp_size, max_w)
    rows = gc.gotoh_traceback(bp, score, table, cap)
    torch.cuda.synchronize()
    assert (gc.FILL_LAUNCHES, gc.TRACEBACK_LAUNCHES) == (fills + 1, tbs + 1)
    bp_p, score_p = plain.gotoh_fill_plain(table, seqs)
    assert torch.equal(bp.view(torch.int16), bp_p.view(torch.int16))
    assert torch.equal(score, score_p)
    assert torch.equal(rows, plain.gotoh_traceback_plain(bp, score, table, cap))


def test_dispatch_on_card_matches_cpu(card):
    jobs = _jobs(np.random.default_rng(7), 12, 50, 300)
    on_card = gc.gotoh_align_batched(jobs, card)
    on_cpu = gc.gotoh_align_batched(jobs, torch.device("cpu"))
    for (a1, s1), (a2, s2) in zip(on_card, on_cpu):
        assert s1 == s2 and np.array_equal(a1, a2)


def test_wrapper_rejects_wrong_dtype(card):
    jobs = _jobs(np.random.default_rng(3), 2, 5, 20)
    table = gc.params_table(jobs).to(card)
    with pytest.raises(ValueError):
        gc.gotoh_fill(table, gc.pack_seqs(jobs).to(card).long(),
                      *gc.launch_sizes(jobs)[:2])

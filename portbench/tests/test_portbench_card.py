"""On a card only (marked `cuda`, each test skips without one): the Gotoh
kernels against the plain reference, and the roofline arithmetic against
their CUDA-event time (work.timed, chip_smoke's timer frozen)."""

import numpy as np
import pytest

from portbench import work
from portbench.reference import gotoh

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def test_kernels_match_the_reference_and_stay_under_their_roofline(card):
    from centrolign_tpu_torch.ops import gotoh_cuda
    from centrolign_tpu_torch.ops.align_params import AlignmentParams
    rng = np.random.default_rng(8)
    jobs = []
    for V1, V2, npw in ((3000, 3400, 3), (700, 650, 2), (141, 900, 1)):
        s1 = rng.integers(0, 4, V1).astype(np.int32)
        s2 = np.resize(s1, V2).astype(np.int32)
        s2[::13] = (s2[::13] + 1) % 4
        jobs.append((s1, s2, bool(npw % 2),
                     AlignmentParams().truncated(npw)))
    got, ms = work.timed(lambda: gotoh_cuda.gotoh_align_batched(jobs, card),
                         5)
    for (s1, s2, swap, p), (aln, score) in zip(jobs, got):
        ref, ref_score = gotoh.align((s1, s2, swap, p.match, p.mismatch,
                                      p.gap_open, p.gap_extend))
        assert np.array_equal(aln, ref) and score == ref_score
    shapes = [(len(s1), len(s2), p.num_pw, len(aln))
              for (s1, s2, _, p), (aln, _) in zip(jobs, got)]
    share = 100 * work.least_seconds(shapes) / (ms / 1e3)
    assert 0 < share <= 100

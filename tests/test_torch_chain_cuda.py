"""The device-chaining kernels (csrc/chain_cdq.cu, csrc/chain_scan.cu)
against their plain versions, on the card: both run one step per
dependency level in one cooperative launch, so the cases cover chains as
deep as they are long, levels wider than a block's threads and than a
chunk of partials, batches of unequal depths, rows staged in several
pieces, and anchors that end before they start.

Marked `cuda`: each test skips without a card. On a machine with one:

    python -m pytest -m cuda tests/test_torch_chain_cuda.py -q

Tolerance: exact. The CDQ scan's dp, bp, tie, struct and stored and the
event scan's dp and winners must be bit-equal to the plain versions of
ops/chain_cdq.py and ops/chain_scan.py on the same inputs; through the
entries, dp/tie/struct/stored equal the native engine's and chains are the
CPU's.
"""

import numpy as np
import pytest
import torch

from centrolign_tpu_torch.native import chain_affine_cdq
from centrolign_tpu_torch.ops import chain_cdq, chain_cdq_cuda, chain_scan
from centrolign_tpu_torch.ops import chain_scan_cuda

# chip_smoke's bag generators
from chip_smoke import (cdq_problem, chain_events, chain_problem,
                        scan_problem, two_level_problem)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _cdq_both(problems, card, full=False):
    _, arrays = chain_cdq.pack(problems, max(len(p[0]) for p in problems))
    if full:
        arrays[5][:] = 0
    t = [torch.from_numpy(a).to(card) for a in arrays]
    got = chain_cdq_cuda.cdq_scan(*t, anchors=sum(len(p[0])
                                                  for p in problems))
    torch.cuda.synchronize()
    want = chain_cdq.cdq_scan_plain(*t)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    return got


@pytest.mark.parametrize("n", [1, 8, 31, 1023, 1024, 1025, 2100])
def test_cdq_scan_matches_plain(card, n):
    _cdq_both([cdq_problem(np.random.default_rng(n), n)], card)


def test_cdq_scan_tie_dense_and_batch(card):
    rng = np.random.default_rng(7)
    probs = [cdq_problem(rng, 0), cdq_problem(rng, 300, tie_dense=True),
             cdq_problem(rng, 1), cdq_problem(rng, 500, tie_dense=True),
             cdq_problem(rng, 1200)]
    chain_cdq_cuda.reset_counters()
    got = _cdq_both(probs, card)
    assert (chain_cdq_cuda.LAUNCHES, chain_cdq_cuda.PROBLEMS,
            chain_cdq_cuda.ANCHORS) == (1, 5, 2001)
    assert chain_cdq_cuda.PLAIN_PROBLEMS == 0
    assert (got[2].cpu() != 0).any()


def test_cdq_scan_bent_anchors_scan_every_row(card):
    rng = np.random.default_rng(8)
    bent = cdq_problem(rng, 700, bent=True)
    assert not chain_cdq.pack([bent], 700)[1][5][0]
    _cdq_both([bent], card)


def test_cdq_scan_prefix_equals_full(card):
    prob = [cdq_problem(np.random.default_rng(9), 1500)]
    a = _cdq_both(prob, card)
    b = _cdq_both(prob, card, full=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_cdq_scan_chain_as_deep_as_it_is_long(card):
    chain_cdq_cuda.reset_counters()
    _cdq_both([chain_problem(3000)], card)
    assert chain_cdq_cuda.LAUNCHES == 1


@pytest.mark.parametrize("n", [2500, 5000])
def test_cdq_scan_level_wider_than_a_block(card, n):
    # two levels of n / 2 queries: more than the block's 1,024 threads, and
    # at n 5,000 more than a chunk of PART_QUERIES partials
    prob = two_level_problem(np.random.default_rng(n), n)
    levels = chain_cdq.pack([prob], n)[1][6]
    assert (levels[:, 2] - levels[:, 1]).max() == n // 2
    _cdq_both([prob], card)


def test_cdq_scan_batch_of_unequal_depths(card):
    rng = np.random.default_rng(12)
    probs = [chain_problem(700), cdq_problem(rng, 1500), cdq_problem(rng, 0),
             two_level_problem(rng, 2400), cdq_problem(rng, 900, bent=True)]
    chain_cdq_cuda.reset_counters()
    _cdq_both(probs, card)
    assert (chain_cdq_cuda.LAUNCHES, chain_cdq_cuda.PROBLEMS) == (1, 5)


@pytest.mark.parametrize("full", [False, True])
def test_cdq_scan_rows_staged_in_pieces(card, monkeypatch, full):
    # a block's rows over several stagings of STAGE_ROWS
    monkeypatch.setattr(chain_cdq_cuda, "STAGE_ROWS", 5)
    _cdq_both([cdq_problem(np.random.default_rng(13), 3000)], card, full)


def test_chain_cdq_device_matches_native(card):
    rng = np.random.default_rng(10)
    probs = [cdq_problem(rng, int(rng.integers(5, 900))) for _ in range(4)]
    for prob, got in zip(probs, chain_cdq.chain_cdq_device_batch(probs,
                                                                 card)):
        want = chain_affine_cdq(*prob)
        for k in (0, 2, 3, 4, 5):
            assert np.array_equal(want[k], got[k])
        untied = want[2] == 0
        assert np.array_equal(want[1][untied], got[1][untied])


def _event_both(args, card):
    n = len(args[4])
    _, _, ev, dp0, levels = chain_scan.build_events(*args[:6])
    ev, dp0 = torch.from_numpy(ev).to(card), torch.from_numpy(dp0).to(card)
    levels = tuple(torch.from_numpy(a).to(card) for a in levels)
    chain_scan_cuda.reset_counters()
    got = chain_scan_cuda.event_scan(ev, dp0, levels, anchors=n)
    torch.cuda.synchronize()
    assert (chain_scan_cuda.LAUNCHES, chain_scan_cuda.PROBLEMS,
            chain_scan_cuda.ANCHORS) == (1, 1, n)
    want = chain_scan.event_scan_plain(ev, dp0)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


# sizes around the block's 1,024 threads and past 32,768 slots (the old
# one-block kernel's shared-memory table)
@pytest.mark.parametrize("n,tie_dense", [
    (1, False), (8, False), (300, True), (1100, False), (5000, True),
    (32768, False), (32769, False), (40000, False)])
def test_event_scan_matches_plain(card, n, tie_dense):
    _event_both(scan_problem(np.random.default_rng(n), n, tie_dense), card)


def test_event_scan_chain_as_deep_as_it_is_long(card):
    _event_both(chain_events(3000), card)


def test_event_scan_slots_staged_in_pieces(card, monkeypatch):
    monkeypatch.setattr(chain_scan_cuda, "STAGE_ROWS", 6)
    _event_both(scan_problem(np.random.default_rng(14), 6000), card)


def test_sparse_chain_scan_on_card_matches_cpu(card):
    rng = np.random.default_rng(11)
    for n in (50, 2000):
        args = scan_problem(rng, n, tie_dense=n == 50)
        assert (chain_scan.sparse_chain_scan(*args, card)
                == chain_scan.sparse_chain_scan(*args, torch.device("cpu")))


def test_wrappers_refuse_what_the_kernels_do_not_take(card, monkeypatch):
    args = scan_problem(np.random.default_rng(1), 40)
    _, _, ev_np, dp0_np, levels_np = chain_scan.build_events(*args[:6])
    ev, dp0 = torch.from_numpy(ev_np).to(card), torch.from_numpy(dp0_np).to(
        card)
    levels = tuple(torch.from_numpy(a).to(card) for a in levels_np)
    with pytest.raises(ValueError):
        chain_scan_cuda.event_scan(ev.long(), dp0, levels, 40)
    with pytest.raises(ValueError):
        chain_scan_cuda.event_scan(ev, dp0, (levels[0].long(), levels[1]),
                                   40)
    _, arrays = chain_cdq.pack([cdq_problem(np.random.default_rng(1), 40)],
                               40)
    t = [torch.from_numpy(a).to(card) for a in arrays]
    bad = list(t)
    bad[3] = bad[3].float()
    with pytest.raises(ValueError):
        chain_cdq_cuda.cdq_scan(*bad, anchors=40)
    bad = list(t)
    bad[6] = bad[6][:, :3].contiguous()
    with pytest.raises(ValueError):
        chain_cdq_cuda.cdq_scan(*bad, anchors=40)
    # a launch whose blocks cannot be resident (more shared memory than an
    # SM has) is refused, not run
    monkeypatch.setattr(chain_cdq_cuda, "STAGE_ROWS", 5000)
    with pytest.raises(RuntimeError):
        chain_cdq_cuda.cdq_scan(*t, anchors=40)
    monkeypatch.setattr(chain_scan_cuda, "STAGE_ROWS", 30000)
    with pytest.raises(RuntimeError):
        chain_scan_cuda.event_scan(ev, dp0, levels, 40)

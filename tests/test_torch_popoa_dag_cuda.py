"""The port's DAG x DAG CUDA kernels against their plain versions, on the
card.

Marked `cuda`: each test skips without a card. On a machine with one:

    python -m pytest -m cuda tests/test_torch_popoa_dag_cuda.py -q

Tolerance: exact (integer DP): the packed backpointers, the sink M and the
traceback rows of csrc/popoa_dag.cu must be bit-equal to ops/popoa_dag.py's
plain fill and host walk, on chip_smoke.py's bag (in-degree up to 4, span
up to 32, npw 1-3, several sources and sinks, every exit of the walk, a
job with no interior alignment, state in shared memory and in global
scratch, the largest five.fasta shape).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from centrolign_tpu_torch.ops import popoa_dag as plain
from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc
from centrolign_tpu_torch.ops.align_params import AlignmentParams

pytestmark = pytest.mark.cuda

PARAMS = AlignmentParams(20, 80, (60, 800, 2500), (30, 5, 1))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def test_kernels_match_plain_on_the_bag(card):
    jobs, _ = chip_smoke.make_dag_bag(np.random.default_rng(5), PARAMS)
    table, data, (bp_size, sm_size, scratch, smem, cap) = pdc.dag_launch(
        jobs, card)
    fills, tbs = pdc.FILL_LAUNCHES, pdc.TRACEBACK_LAUNCHES
    bp, sinkm = pdc.popoa_dag_fill(table, data, bp_size, sm_size, scratch,
                                   smem)
    rows = pdc.popoa_dag_traceback(bp, sinkm, table, data, cap)
    torch.cuda.synchronize()
    assert (pdc.FILL_LAUNCHES, pdc.TRACEBACK_LAUNCHES) == (fills + 1, tbs + 1)
    bp_p, sinkm_p = plain.popoa_dag_fill_plain(table, data)
    assert torch.equal(bp, bp_p)
    assert torch.equal(sinkm, sinkm_p)
    rows_p = plain.popoa_dag_traceback_plain(bp, sinkm, table, data, cap)
    assert torch.equal(rows, rows_p)
    exits = set(rows[:, 0, 1].tolist())
    assert {1, 2, 3, 4} <= exits


def test_batch_on_card_matches_cpu(card):
    jobs, _ = chip_smoke.make_dag_bag(np.random.default_rng(6), PARAMS)
    jobs = [j for j in jobs if j.t1.V < 1000]
    on_card = plain.popoa_dag_batch(jobs, card)
    on_cpu = plain.popoa_dag_batch(jobs, torch.device("cpu"))
    for a, b in zip(on_card, on_cpu):
        assert (a is None) == (b is None)
        if a is not None:
            assert a[1] == b[1] and np.array_equal(a[0], b[0])


def test_single_entry_matches_plain(card):
    from centrolign_tpu_torch.ops.gotoh_cuda import gotoh_align_device
    rng = np.random.default_rng(8)
    for L1, L2 in ((40, 70), (4200, 4150)):
        s1 = rng.integers(0, 4, L1).astype(np.int32)
        s2 = np.resize(s1, L2).astype(np.int32)
        s2[rng.integers(0, L2, L2 // 9)] = rng.integers(0, 4)
        a, sa = gotoh_align_device(s1, s2, PARAMS, device=card)
        b, sb = gotoh_align_device(s1, s2, PARAMS, device=torch.device("cpu"))
        assert sa == sb and np.array_equal(a, b)


def test_device_memory_is_logged_after_a_launch(card):
    from centrolign_tpu_torch.utils.memory import device_memory_usage
    jobs, _ = chip_smoke.make_dag_bag(np.random.default_rng(9), PARAMS)
    plain.popoa_dag_batch(jobs[:3], card)
    assert device_memory_usage() == torch.cuda.max_memory_allocated() > 0

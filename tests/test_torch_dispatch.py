"""The port's dispatch layer on the CPU against the JAX package.

gotoh_dispatch / gotoh_fetch over a bag shaped like
tests/test_packmulti_device.py (52 jobs in two size classes), here also
mixing truncated parameters, both orientations and swap_pref: every job's
alignment and score must equal centrolign_tpu.ops.gotoh.gotoh_align's
(tolerance: exact, integer DP).
"""

import numpy as np
import pytest
import torch

from centrolign_tpu.ops.align_params import AlignmentParams
from centrolign_tpu.ops.gotoh import gotoh_align as jax_gotoh_align
from centrolign_tpu_torch.ops import gotoh_cuda as gc
from centrolign_tpu_torch.ops.align_params import params_from_arrays

CPU = torch.device("cpu")


def _port(jobs):
    """The jobs with the JAX package's parameters turned into the port's."""
    return [(s1, s2, swp, params_from_arrays(
        p.match, p.mismatch, np.asarray(p.gap_open), np.asarray(p.gap_extend)))
        for s1, s2, swp, p in jobs]


def _bag():
    rng = np.random.default_rng(3)
    params = AlignmentParams()

    def mkjob(L1, L2, k):
        s1 = rng.integers(0, 4, L1).astype(np.int32)
        s2 = s1[:min(L1, L2)].copy()
        if L2 > len(s2):
            s2 = np.concatenate(
                [s2, rng.integers(0, 4, L2 - len(s2)).astype(np.int32)])
        idx = rng.integers(0, L2, max(1, L2 // 20))
        s2[idx] = (s2[idx] + 1) % 4
        return (s1, s2, k % 5 == 0, params.truncated(1 + k % params.num_pw))

    return ([mkjob(int(rng.integers(90, 127)), int(rng.integers(90, 127)), k)
             for k in range(40)] +
            [mkjob(int(rng.integers(140, 250)), int(rng.integers(140, 250)), k)
             for k in range(12)])


def _check(jobs, results):
    assert len(results) == len(jobs)
    for (s1, s2, swp, p), (aln, score) in zip(jobs, results):
        aln_j, score_j = jax_gotoh_align(s1, s2, p, swap_pref=swp)
        assert score == score_j
        assert aln.dtype == np.int64
        assert np.array_equal(aln, aln_j)


def test_dispatch_fetch_matches_jax():
    jobs = _bag()
    handles = [gc.gotoh_dispatch(_port(jobs[:40]), CPU),
               gc.gotoh_dispatch(_port(jobs[40:]), CPU)]
    results = [r for h in handles for r in gc.gotoh_fetch(h)]
    _check(jobs, results)


def test_dispatch_splits_launches(monkeypatch):
    jobs = _port(_bag()[:20])
    one = gc.gotoh_align_batched(jobs, CPU)
    # a cap of one job's backpointers per launch: one launch per job
    monkeypatch.setattr(gc, "MAX_LAUNCH_BP_BYTES", 1)
    handle = gc.gotoh_dispatch(jobs, CPU)
    assert len(handle) == len(jobs)
    split = gc.gotoh_fetch(handle)
    for (a1, s1), (a2, s2) in zip(one, split):
        assert s1 == s2 and np.array_equal(a1, a2)


def test_counters_count_jobs_not_cpu_launches():
    gc.reset_counters()
    gc.gotoh_align_batched(_port(_bag()[:3]), CPU)
    # launches count kernel launches only; the CPU runs the plain versions
    assert (gc.DISPATCHED_JOBS, gc.FILL_LAUNCHES, gc.TRACEBACK_LAUNCHES) == (3, 0, 0)
    gc.reset_counters()
    assert gc.DISPATCHED_JOBS == 0


def test_params_table_layout():
    rng = np.random.default_rng(1)
    p3 = AlignmentParams(20, 80, (60, 800, 2500), (30, 5, 1))
    jobs = [(rng.integers(0, 4, 7).astype(np.int32),
             rng.integers(0, 4, 5).astype(np.int32), True, p3.truncated(2)),
            (rng.integers(0, 4, 3).astype(np.int32),
             rng.integers(0, 4, 9).astype(np.int32), False, p3)]
    jobs = _port(jobs)
    tab = gc.params_table(jobs)
    assert tab.dtype == torch.int32 and tab.shape == (2, 16)
    # columns 0..4+2npw as the Pallas packed kernels' params rows
    # (gotoh_pallas.py:753-754), zero-padded
    assert tab[0, :10].tolist() == [7, 5, 20, 80, 60, 800, 30, 5, 0, 0]
    assert tab[1, :10].tolist() == [3, 9, 20, 80, 60, 800, 2500, 30, 5, 1]
    # lane_is_i, swap_pref, npw, sequence offset, bp offset (lo, hi)
    assert tab[0, 10:].tolist() == [0, 1, 2, 0, 0, 0]
    assert tab[1, 10:].tolist() == [1, 0, 3, 12, (7 + 5 + 1) * (5 + 1), 0]
    seqs = gc.pack_seqs(jobs)
    assert seqs.dtype == torch.int32
    assert np.array_equal(seqs.numpy(), np.concatenate(
        [jobs[0][0], jobs[0][1], jobs[1][0], jobs[1][1]]))
    assert gc.launch_sizes(jobs) == (13 * 6 + 13 * 4, 6, 12)


def test_params_table_splits_int64_offset():
    # a job past 2^32 backpointer entries keeps its offset in two words
    p = AlignmentParams()
    big = np.zeros(70000, np.int32)
    jobs = _port([(big, big, False, p), (big[:3], big[:4], False, p)])
    tab = gc.params_table(jobs).numpy().astype(np.int64)
    off = (tab[1, 14] & 0xFFFFFFFF) | (tab[1, 15] << 32)
    assert off == (2 * 70000 + 1) * 70001
    assert off >= 1 << 32


def test_wrappers_reject_other_devices():
    jobs = _port(_bag()[:1])
    table = gc.params_table(jobs).to("meta")
    with pytest.raises(ValueError):
        gc.gotoh_fill(table, gc.pack_seqs(jobs).to("meta"),
                      *gc.launch_sizes(jobs)[:2])

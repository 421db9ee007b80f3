"""The port's traceback against the JAX package's device traceback.

One set of backpointers (from the JAX package's _gotoh_scan) goes into
centrolign_tpu.ops.gotoh_pallas._traceback_pack8_on_device (pure lax, so
it runs on the CPU) and into the port's gotoh_traceback; the (cap+1, 2)
rows must be equal, element for element (tolerance: exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centrolign_tpu.ops.align_params import AlignmentParams
from centrolign_tpu.ops.gotoh_pallas import _traceback_pack8_on_device
from centrolign_tpu_torch.ops import gotoh_cuda as gc
from centrolign_tpu_torch.ops.align_params import params_from_arrays

from test_torch_gotoh import _jax_fill

PARAMS = AlignmentParams(20, 80, (60, 800, 2500), (30, 5, 1))


def _port(jobs):
    """The jobs with the JAX package's parameters turned into the port's."""
    return [(s1, s2, swp, params_from_arrays(
        p.match, p.mismatch, np.asarray(p.gap_open), np.asarray(p.gap_extend)))
        for s1, s2, swp, p in jobs]


def _group(rng, lane_is_i, swap_pref, npw):
    """Eight jobs of one orientation, as the JAX packed traceback takes."""
    jobs = []
    for _ in range(8):
        a, b = sorted(int(x) for x in rng.integers(1, 120, 2))
        V1, V2 = (a, b) if lane_is_i else (b + 1, a)
        s1 = rng.integers(0, 4, V1).astype(np.int32)
        s2 = np.resize(s1, V2).astype(np.int32)
        s2[rng.integers(0, V2, max(1, V2 // 5))] = rng.integers(0, 4)
        jobs.append((s1, s2, swap_pref, PARAMS.truncated(npw)))
    return jobs


@pytest.mark.parametrize("npw", [1, 2, 3])
@pytest.mark.parametrize("lane_is_i", [True, False], ids=["lanes_i", "lanes_j"])
@pytest.mark.parametrize("swap_pref", [False, True], ids=["pref_I", "pref_D"])
def test_traceback_rows_match_jax(npw, lane_is_i, swap_pref):
    rng = np.random.default_rng(100 * npw + 10 * lane_is_i + swap_pref)
    jobs = _group(rng, lane_is_i, swap_pref, npw)
    fills = [_jax_fill(s1, s2, p, swp) for s1, s2, swp, p in jobs]
    D = max(bp.shape[0] for bp, _, _ in fills)
    W = max(bp.shape[1] for bp, _, _ in fills)
    packed = np.zeros((D, 8, W), np.int32)
    for r, (bp, _, _) in enumerate(fills):
        packed[:bp.shape[0], r, :bp.shape[1]] = bp
    scores = np.array([sc for _, sc, _ in fills], np.int32)
    V1s = np.array([len(j[0]) for j in jobs], np.int32)
    V2s = np.array([len(j[1]) for j in jobs], np.int32)
    want = np.asarray(_traceback_pack8_on_device(
        jnp.asarray(packed), jnp.asarray(scores), jnp.asarray(V1s),
        jnp.asarray(V2s), lane_is_i, npw, D))

    flat = np.concatenate([bp.reshape(-1) for bp, _, _ in fills])
    got = gc.gotoh_traceback(
        torch.from_numpy(flat.astype(np.int16)).view(torch.uint16),
        torch.from_numpy(scores), gc.params_table(_port(jobs)), D)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_traceback_rejects_short_cap():
    rng = np.random.default_rng(0)
    jobs = _port(_group(rng, True, False, 2))
    bp, score = gc.gotoh_fill(gc.params_table(jobs), gc.pack_seqs(jobs),
                              *gc.launch_sizes(jobs)[:2])
    cap = gc.launch_sizes(jobs)[2]
    with pytest.raises(ValueError):
        gc.gotoh_traceback(bp, score, gc.params_table(jobs), cap - 1)

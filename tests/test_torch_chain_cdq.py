"""The port's SparseAffine CDQ value scan (ops/chain_cdq.py) against the
JAX package's (centrolign_tpu.ops.chain_cdq, on the CPU) and the port's
native engine (native.chain_affine_cdq), on the JAX test's generators.

Tolerance: dp, tie, struct, stored and qshift bit-equal; bp equal where the
winning channel is untied against the native engine (whose tied steps the
host resolver redoes), and equal everywhere against the JAX scan (both
take the first index of a maximum). On the CPU the scan runs its plain
version, with and without the kernel's prefix-only mode.
"""

import numpy as np
import pytest
import torch

from centrolign_tpu.ops import chain_cdq as jax_cdq
from centrolign_tpu_torch.native import chain_affine_cdq
from centrolign_tpu_torch.ops import chain_cdq, chain_cdq_cuda

from test_chain_cdq import GE, GO, _assert_same, _random_problem

CPU = torch.device("cpu")


def _check(prob, got):
    """got against the native engine and the JAX scan."""
    _assert_same(chain_affine_cdq(*prob), got)
    want = jax_cdq.chain_cdq_device(*prob)
    for a, b in zip(want, got):
        assert np.array_equal(a, b)


def _scan_modes(prob):
    """The plain scan's outputs in the prefix mode that pack chose and
    over the whole table, in sorted order."""
    n = len(prob[0])
    _, arrays = chain_cdq.pack([prob], n)
    t = [torch.from_numpy(a) for a in arrays]
    chosen = chain_cdq.cdq_scan_plain(*t)
    full = chain_cdq.cdq_scan_plain(*t[:5], torch.zeros(1, dtype=torch.int32))
    return bool(arrays[5][0]), chosen, full


@pytest.mark.parametrize("trial", range(6))
def test_cdq_random_matches_jax_and_native(trial):
    rng = np.random.default_rng(31000 + trial)
    prob = _random_problem(rng, int(rng.integers(10, 600)))
    _check(prob, chain_cdq.chain_cdq_device(*prob, CPU))


@pytest.mark.parametrize("trial", range(4))
def test_cdq_tie_dense_matches_jax_and_native(trial):
    rng = np.random.default_rng(32000 + trial)
    prob = _random_problem(rng, int(rng.integers(50, 400)), span=4000,
                           tie_dense=True)
    got = chain_cdq.chain_cdq_device(*prob, CPU)
    _check(prob, got)
    assert (got[2] != 0).any(), "tie-dense fixture produced no ties"


def test_cdq_empty_and_single():
    empty = (np.empty(0, np.int64),) * 4 + (
        np.empty(0, np.float32), np.empty(0, np.float32), GO, GE, 1.0)
    for a, b in zip(chain_affine_cdq(*empty),
                    chain_cdq.chain_cdq_device(*empty, CPU)):
        assert np.array_equal(a, b)
    one = (np.array([3]), np.array([8]), np.array([2]), np.array([7]),
           np.array([5.0], np.float32), np.array([5.0], np.float32),
           GO, GE, 0.5)
    _check(one, chain_cdq.chain_cdq_device(*one, CPU))


def test_cdq_batch_matches_singles():
    rng = np.random.default_rng(33000)
    probs = [_random_problem(rng, int(rng.integers(5, 200)))
             for _ in range(5)]
    probs.insert(2, _random_problem(rng, 0))
    chain_cdq_cuda.reset_counters()
    batched = chain_cdq.chain_cdq_device_batch(probs, CPU)
    assert chain_cdq_cuda.PLAIN_PROBLEMS == 5 and chain_cdq_cuda.LAUNCHES == 0
    assert chain_cdq_cuda.PLAIN_ANCHORS == sum(len(p[0]) for p in probs)
    jax_batched = jax_cdq.chain_cdq_device_batch(
        [p for p in probs if len(p[0])])
    for prob, got in zip(probs, batched):
        _assert_same(chain_affine_cdq(*prob), got)
    for want, got in zip(jax_batched, [g for g in batched if len(g[0])]):
        for a, b in zip(want, got):
            assert np.array_equal(a, b)


def test_cdq_prefix_mode_is_exact():
    """Every anchor with pe1 >= ps1: the prefix-only scan equals the full
    one. Anchors ending before they start: pack asks for the full scan,
    which equals the JAX scan (the native engine's timeline assumes that
    an anchor ends after it starts, so it is no reference there)."""
    rng = np.random.default_rng(34000)
    prob = _random_problem(rng, 300)
    prefix, chosen, full = _scan_modes(prob)
    assert prefix
    for a, b in zip(chosen, full):
        assert torch.equal(a, b)

    ps1, pe1, ps2, pe2, *rest = _random_problem(rng, 300)
    back = rng.random(len(ps1)) < 0.3
    pe1 = np.where(back, ps1 - rng.integers(1, 400, len(ps1)), pe1)
    pe2 = np.where(back, ps2 - rng.integers(1, 400, len(ps1)), pe2)
    bent = (ps1, pe1, ps2, pe2, *rest)
    prefix, chosen, full = _scan_modes(bent)
    assert not prefix
    got = chain_cdq.chain_cdq_device(*bent, CPU)
    for a, b in zip(jax_cdq.chain_cdq_device(*bent), got):
        assert np.array_equal(a, b)
    for a, b in zip(chosen, full):
        assert torch.equal(a, b)


def test_cdq_through_port_anchorer(monkeypatch):
    """CENTROLIGN_TPU_DEVICE_CDQ=1 with a device routes the port
    anchorer's value pass through the scan; the chain equals the JAX
    anchorer's default (native CDQ) chain exactly. Without a device the
    switch leaves the native engine in place."""
    from test_chain_ties import _run_chain, _setup_graphs, _tie_dense_matches
    from test_torch_chain_ties import _port_chain

    rng = np.random.default_rng(606)
    graphs = _setup_graphs(rng, 260, 260)
    matches = _tie_dense_matches(rng, 256, n_pos=24, dup=3)
    want = _run_chain(monkeypatch, matches, graphs, cdq=True)
    monkeypatch.setenv("CENTROLIGN_TPU_DEVICE_CDQ", "1")
    chain_cdq_cuda.reset_counters()
    assert _port_chain(monkeypatch, matches, 606) == want
    assert chain_cdq_cuda.PLAIN_PROBLEMS == 0
    assert _port_chain(monkeypatch, matches, 606, device=CPU) == want
    assert chain_cdq_cuda.PLAIN_PROBLEMS > 0 and chain_cdq_cuda.LAUNCHES == 0

"""The port's device free-gap chains (CENTROLIGN_TPU_DEVICE_CHAIN=1) against
the native parity engine at each Sparse `_chain_parity` call of a CLI run.

The small pair of tests/test_torch_cli.py (`_write_pair(.., 1)`, `-u -a
3000`) makes three free-gap calibration chains. At each call the native
engine chains deep copies of the matches first, then the device path (the
plain event scan on the CPU) chains the originals: the two chains are the
same anchors with the same walks and counts.

A replay that records the returned list and compares it after the run sees
more anchors in two of the three (594 against 593, 410 against 346): fill-in
anchoring rewrites the chain in place (`anchors[:] = merged`,
centrolign_tpu_torch/anchorer.py::_fill_in_anchor_chain), whichever engine
made it. So a replay has to key a chain when it is returned, as this one
does.

Tolerance: exact (anchors, walks and counts).
"""

import contextlib
import copy
import io

import numpy as np
import pytest

from centrolign_tpu_torch import anchorer as anchorer_mod
from centrolign_tpu_torch import cli
from centrolign_tpu_torch.ops import chain_scan_cuda

from test_torch_cli import _write_pair


def _key(chain):
    return [(a.match_set, a.idx1, a.idx2, tuple(np.asarray(a.walk1)),
             tuple(np.asarray(a.walk2)), a.count1, a.count2) for a in chain]


@pytest.fixture(scope="module")
def sparse_calls(tmp_path_factory):
    """Runs the port CLI once on the small pair with both chaining switches
    and a CPU device; returns, per Sparse call, (native key, device key at
    return)."""
    mp = pytest.MonkeyPatch()
    pair = _write_pair(tmp_path_factory.mktemp("fault") / "pair1.fasta", 1)
    for k in ("CENTROLIGN_TORCH_DEVICE_MIN_CELLS", "CENTROLIGN_TORCH_DEVICE_DAG"):
        mp.delenv(k, raising=False)
    mp.setenv("CENTROLIGN_TORCH_DEVICE", "cpu")
    mp.setenv("CENTROLIGN_TPU_DEVICE_CDQ", "1")
    mp.setenv("CENTROLIGN_TPU_DEVICE_CHAIN", "1")
    parity = anchorer_mod.Anchorer._chain_parity
    calls = []

    def both(self, matches, *args):
        if args[8] != anchorer_mod.ChainAlgorithm.Sparse:
            return parity(self, matches, *args)
        with pytest.MonkeyPatch.context() as m:
            m.delenv("CENTROLIGN_TPU_DEVICE_CHAIN")
            native = parity(self, copy.deepcopy(matches), *args)
        chain = parity(self, matches, *args)
        calls.append((_key(native), _key(chain)))
        return chain

    mp.setattr(anchorer_mod.Anchorer, "_chain_parity", both)
    chain_scan_cuda.reset_counters()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["-v", "0", "-u", "-a", "3000", pair])
    finally:
        mp.undo()
    assert rc == 0
    assert chain_scan_cuda.PLAIN_PROBLEMS == 3
    return calls


def test_device_free_gap_chains_equal_native_at_each_call(sparse_calls):
    assert [len(n) for n, _d in sparse_calls] == [592, 593, 346]
    for native, device in sparse_calls:
        assert device == native

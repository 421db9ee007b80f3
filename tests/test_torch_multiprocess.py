"""The port's torch.distributed executor (parallel/multiprocess.py, the
CLI's CENTROLIGN_TPU_EXECUTOR=jaxdist with --hosts N) must reproduce the
port's serial run and the JAX package's run on the same input and flags
byte for byte: the final GFA, and under -c/-S/-s its side files, also after
a -R restart with the root's checkpoint removed (tests/test_multiprocess.py
is the model). Two ranks on gloo, the device tier on the CPU; each rank's
counters come back to the parent, and no rank loads jax or the JAX package.

Tolerance: exact (byte-equal files).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from centrolign_tpu.parallel.multiprocess import (
    balanced_assignment as jax_balanced_assignment)
from centrolign_tpu_torch.params import Parameters
from centrolign_tpu_torch.parallel.multiprocess import (balanced_assignment,
                                                        run_multiprocess_msa)

from test_multiprocess import _collect, _make_tandem_fasta, _serial_run
from test_torch_cli import REPO, _env, _run_jax_cli, _run_port
from test_torch_scheduler import _make_fasta

CPU_TIER = {"CENTROLIGN_TORCH_DEVICE": "cpu",
            "CENTROLIGN_TORCH_DEVICE_MIN_CELLS": "4000"}


@pytest.mark.parametrize("seed", range(4))
def test_balanced_assignment_matches_jax(seed):
    rng = np.random.default_rng(seed)
    weights = [float(w) for w in rng.integers(1, 6, int(rng.integers(0, 12)))]
    for n_procs in (1, 2, 3):
        assert (balanced_assignment(weights, n_procs)
                == jax_balanced_assignment(weights, n_procs))


def test_jaxdist_cli_matches_serial(tmp_path):
    """The CLI routes --hosts 2 with CENTROLIGN_TPU_EXECUTOR=jaxdist and 3
    sequences to the ranks; the GFA is the port's serial run's and the JAX
    CLI's over its own two jax.distributed processes."""
    fa = tmp_path / "in.fa"
    _make_fasta(fa, 3, seed=19)
    argv = ["-v", "0", "-u", str(fa)]
    ser, ser_stats = _run_port(argv, **CPU_TIER)
    assert ser.returncode == 0, ser.stderr[-800:]
    r, stats = _run_port(["--hosts", "2", *argv], **CPU_TIER,
                         CENTROLIGN_TPU_EXECUTOR="jaxdist")
    assert r.returncode == 0, r.stderr[-1500:]
    assert r.stdout == ser.stdout
    ref = _run_jax_cli(["--hosts", "2", *argv],
                       CENTROLIGN_TPU_EXECUTOR="jaxdist")
    assert ref.returncode == 0, ref.stderr[-800:]
    assert r.stdout == ref.stdout
    # every job ran in a rank; the ranks' counters add up to the serial run's
    assert stats["jobs"] == 0
    assert stats["worker_jobs"] == ser_stats["jobs"] > 0
    assert stats["foreign"] == [] and stats["workers_foreign"] == []


def test_jaxdist_module_entry_point(tmp_path):
    fa = tmp_path / "in.fa"
    _make_fasta(fa, 3, length=900, seed=7, blocks=False)
    out = tmp_path / "mp.gfa"
    r = subprocess.run(
        [sys.executable, "-m", "centrolign_tpu_torch.parallel.multiprocess",
         "2", str(fa), "", str(out)],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=_env(CENTROLIGN_TORCH_DEVICE="cpu"))
    assert r.returncode == 0, r.stderr[-800:]
    ser, _ = _run_port(["-v", "0", str(fa)], CENTROLIGN_TORCH_DEVICE="cpu")
    assert out.read_text() == ser.stdout
    ref_out = tmp_path / "jax.gfa"
    ref = subprocess.run(
        [sys.executable, "-m", "centrolign_tpu.parallel.multiprocess",
         "2", str(fa), "", str(ref_out)],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=_env(JAX_PLATFORMS="cpu", CENTROLIGN_TPU_USE_DEVICE="0"))
    assert ref.returncode == 0, ref.stderr[-800:]
    assert out.read_text() == ref_out.read_text()


def _serial(fa, workdir, tag, restart=False):
    args = ["-v", "0", "-S", os.path.join(str(workdir), f"{tag}_chk"),
            "-s", os.path.join(str(workdir), f"{tag}_sub"), "-c", "-y", "180"]
    if restart:
        args.append("-R")
    r, _ = _run_port([*args, str(fa)], CENTROLIGN_TORCH_DEVICE="cpu")
    assert r.returncode == 0, r.stderr[-1200:]
    return r.stdout


def test_jaxdist_cyclize_checkpoint_subaln_restart(tmp_path, monkeypatch):
    """-c/-S/-s through run_multiprocess_msa: the GFA and every side file
    equal the port's serial run's and the JAX CLI's; then -R over the
    checkpoints with the largest removed gives the same GFA."""
    monkeypatch.setenv("CENTROLIGN_TORCH_DEVICE", "cpu")
    fa = tmp_path / "tandem.fa"
    _make_tandem_fasta(fa)
    serial_gfa = _serial(fa, tmp_path, "ser")
    serial_files = _collect(str(tmp_path), "ser_")
    jax_gfa = _serial_run(fa, tmp_path, "jax", cyclize=True)
    assert serial_gfa == jax_gfa
    assert serial_files == _collect(str(tmp_path), "jax_")

    params = Parameters()
    params.set("cyclize_tandem_duplications", True)
    params.set("min_cyclizing_length", 180)
    params.set("subproblems_prefix", str(tmp_path / "mp_chk"))
    params.set("subalignments_filepath", str(tmp_path / "mp_sub"))
    out = tmp_path / "mp.gfa"
    snaps = run_multiprocess_msa(2, str(fa), None, str(out), params=params)
    assert len(snaps) == 2 and all(s["foreign"] == [] for s in snaps)
    assert out.read_text() == serial_gfa
    mp_files = _collect(str(tmp_path), "mp_")
    assert mp_files == serial_files

    chks = [n for n in sorted(os.listdir(tmp_path))
            if n.startswith("mp_chk") and n.endswith(".gfa")]
    assert chks
    os.unlink(tmp_path / max(chks, key=lambda n: os.path.getsize(
        tmp_path / n)))
    params.set("restart", True)
    out2 = tmp_path / "mp2.gfa"
    run_multiprocess_msa(2, str(fa), None, str(out2), params=params)
    assert out2.read_text() == serial_gfa


@pytest.mark.parametrize("n_seqs", [2])
def test_jaxdist_with_two_sequences_runs_the_pool(tmp_path, n_seqs):
    """As in the JAX package (centrolign_tpu/cli.py:146-147), jaxdist takes
    more than 2 sequences; 2 go to the pool executor, whose CIGAR is the
    port's serial run's and the JAX CLI's under the same setting."""
    fa = tmp_path / "in.fa"
    _make_fasta(fa, n_seqs, seed=3)
    argv = ["-v", "0", "-u", str(fa)]
    ser, _ = _run_port(argv, **CPU_TIER)
    r, stats = _run_port(["--hosts", "2", *argv], **CPU_TIER,
                         CENTROLIGN_TPU_EXECUTOR="jaxdist")
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout == ser.stdout
    ref = _run_jax_cli(["--hosts", "2", *argv],
                       CENTROLIGN_TPU_EXECUTOR="jaxdist")
    assert ref.returncode == 0, ref.stderr[-800:]
    assert r.stdout == ref.stdout
    assert stats["workers_foreign"] == []

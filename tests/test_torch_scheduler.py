"""The port's pool executor (parallel/scheduler.py, `--hosts N`) against
the port's serial run and the JAX CLI: the final GFA, the subalignment (-s)
file and the subproblem checkpoint (-S) files are byte-identical, with -c,
with a -R restart from a -S checkpoint, and when every worker task fails
(tests/test_scheduler.py is the model). The device tier runs on the CPU
with its threshold lowered, so the workers dispatch jobs; their counters
come back to the parent. Every run is a subprocess, workers spawned; none
may load jax or the JAX package.

Tolerance: exact (byte-equal files).
"""

import numpy as np
import pytest

from conftest import mutate_sequence, random_sequence
from test_scheduler import _make_tandem_fasta
from test_torch_cli import _run_jax_cli, _run_port

CPU_TIER = {"CENTROLIGN_TORCH_DEVICE": "cpu",
            "CENTROLIGN_TORCH_DEVICE_MIN_CELLS": "4000"}


def _make_fasta(path, n_seqs, length=2000, seed=11, blocks=True):
    """Mutated copies of one sequence; with `blocks`, each has its own
    random block at two shared places: with -u most blocks become chain
    gaps of up to about 300 x 300 cells, over the lowered device
    threshold (and bubbles that make graph chaining slow, so the larger
    MSAs go without)."""
    rng = np.random.default_rng(seed)
    base = random_sequence(rng, length)
    with open(path, "w") as f:
        for i in range(n_seqs):
            s = mutate_sequence(rng, base, sub_rate=0.02, indel_rate=0.01)
            parts, pos = [], 0
            for start in ((400, 1300) if blocks else ()):
                parts += [s[pos:start], random_sequence(
                    rng, 300 + int(rng.integers(-40, 40)))]
                pos = start + 300
            parts.append(s[pos:])
            f.write(f">s{i}\n{''.join(parts)}\n")


def _files(d):
    out = {}
    for p in sorted(d.iterdir()):
        text = p.read_text()
        if p.name.endswith("_info.txt"):  # embeds the output directory
            text = text.replace(str(d), "")
        out[p.name] = text
    return out


def _side_files(out_dir, extra, fa):
    out_dir.mkdir(exist_ok=True)
    return ["-v", "1", "-s", str(out_dir / "sub.txt"),
            "-S", str(out_dir / "cp"), *extra, str(fa)]


def _port(fa, out_dir, extra, **env):
    r, stats = _run_port(_side_files(out_dir, extra, fa), **CPU_TIER, **env)
    assert r.returncode == 0, r.stderr[-1500:]
    assert stats["foreign"] == [] and stats["workers_foreign"] == []
    return r, stats


def _jax(fa, out_dir, extra):
    """The JAX CLI's serial run with the same side files: the reference."""
    r = _run_jax_cli(_side_files(out_dir, extra, fa))
    assert r.returncode == 0, r.stderr[-800:]
    return r


# 3 sequences with divergent blocks and -u (device-tier gaps); 5 shorter
# ones without (graph chaining over the blocks' bubbles is slow on the CPU)
INPUTS = {3: (dict(), ["-u"]), 5: (dict(length=900, blocks=False), [])}


@pytest.mark.parametrize("n_seqs,hosts", [(3, 2), (5, 3)])
def test_pool_matches_serial_and_jax(tmp_path, n_seqs, hosts):
    fa = tmp_path / "in.fa"
    shape, flags = INPUTS[n_seqs]
    _make_fasta(fa, n_seqs, **shape)
    ser, ser_stats = _port(fa, tmp_path / "ser", flags)
    dist, dist_stats = _port(fa, tmp_path / "dist",
                             [*flags, "--hosts", str(hosts)])
    assert "Worker failed" not in dist.stderr
    assert dist.stdout == ser.stdout
    assert _files(tmp_path / "dist") == _files(tmp_path / "ser")
    # the parent's jobs and the workers', which come back with their
    # results, add up to the serial run's
    jobs = dist_stats["jobs"] + dist_stats["worker_jobs"]
    assert jobs == ser_stats["jobs"]
    assert jobs > 0 or n_seqs == 5
    ref = _jax(fa, tmp_path / "jax", flags)
    assert dist.stdout == ref.stdout
    assert _files(tmp_path / "dist") == _files(tmp_path / "jax")


def test_pool_cyclize_and_restart(tmp_path):
    """-c across workers (the bonding rounds fan out one leaf per worker),
    then a -R restart over the -S checkpoints with the root's file
    removed: both equal the port's serial run and the JAX CLI's, files
    included."""
    fa = tmp_path / "in.fa"
    _make_tandem_fasta(fa, 3, unit=400, seed=23)
    cyc = ["-c", "-y", "500", "--bond-prefix"]
    ser, _ = _port(fa, tmp_path / "ser", cyc + [str(tmp_path / "ser" / "bond")])
    dist, _ = _port(fa, tmp_path / "dist",
                    cyc + [str(tmp_path / "dist" / "bond"), "--hosts", "3"])
    ref = _jax(fa, tmp_path / "jax", cyc + [str(tmp_path / "jax" / "bond")])
    assert "Worker failed" not in dist.stderr
    assert dist.stdout == ser.stdout == ref.stdout

    def named(d):
        return {k.replace(str(d), ""): v.replace(str(d), "")
                for k, v in _files(d).items()}
    assert named(tmp_path / "dist") == named(tmp_path / "ser")
    assert named(tmp_path / "dist") == named(tmp_path / "jax")
    subs = sorted((tmp_path / "dist").glob("cp*.gfa"))
    assert subs
    max(subs, key=lambda p: p.stat().st_size).unlink()
    again, _ = _port(fa, tmp_path / "dist",
                     cyc + [str(tmp_path / "dist" / "bond"), "--hosts", "3",
                            "-R"])
    assert again.stdout == ser.stdout == ref.stdout


@pytest.mark.parametrize("fail_mode", ["1", "2"])
def test_pool_worker_failure_recovery(tmp_path, fail_mode):
    """Every worker task fails (mode 1 raises in the task, mode 2 kills the
    worker): the parent recomputes each subproblem on its own device tier
    and the outputs stay byte-identical to the port's serial run and the
    JAX CLI's."""
    fa = tmp_path / "in.fa"
    _make_fasta(fa, 5, length=900, seed=17, blocks=False)
    ser, _ = _port(fa, tmp_path / "ser", [])
    fail, _ = _port(fa, tmp_path / "fail", ["--hosts", "3"],
                    CENTROLIGN_TPU_TEST_WORKER_FAIL=fail_mode)
    ref = _jax(fa, tmp_path / "jax", [])
    assert "Worker failed" in fail.stderr
    assert fail.stdout == ser.stdout == ref.stdout
    assert _files(tmp_path / "fail") == _files(tmp_path / "ser")
    assert _files(tmp_path / "fail") == _files(tmp_path / "jax")

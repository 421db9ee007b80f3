"""The port's CLI against the JAX package's, and the port's independence
from it.

Every run of the port is a subprocess with nothing blocked; at its end
neither jax nor any module of the JAX package may be loaded. Its CIGAR
(pairwise) or GFA (MSA) must be byte-identical to the JAX CLI's on the same
FASTA (native host path, CENTROLIGN_TPU_USE_DEVICE=0), with the device tier
on the CPU and its threshold lowered so that it takes gaps. The package and
chip_smoke.py are also scanned: no import of jax or of the JAX package, no
write to sys.modules.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from centrolign_tpu_torch.device import resolve_device
from centrolign_tpu_torch.ops import _build

from conftest import mutate_sequence, random_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "centrolign_tpu_torch")

# runs the port's cli.main; the counters and the modules loaded go to stderr
_PORT = r"""
import contextlib, io, json, sys
sys.path.insert(0, {repo!r})
from centrolign_tpu_torch import cli, metrics
from centrolign_tpu_torch.parallel import counters
from centrolign_tpu_torch.ops import (chain_cdq_cuda, chain_scan_cuda,
                                     gotoh_cuda, popoa_dag_cuda)
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = cli.main({argv!r})
sys.stdout.write(out.getvalue())
mods = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
        or m == "centrolign_tpu" or m.startswith("centrolign_tpu.")]
print(json.dumps({{"rc": rc, "jobs": gotoh_cuda.DISPATCHED_JOBS,
                  "worker_jobs": counters.MERGED.get(
                      "gotoh_cuda.DISPATCHED_JOBS", 0),
                  "fills": gotoh_cuda.FILL_LAUNCHES,
                  "dag_jobs": popoa_dag_cuda.DISPATCHED_JOBS,
                  "dag_fills": popoa_dag_cuda.FILL_LAUNCHES,
                  "pod": metrics.counters["pod"][1] if "pod" in metrics.counters else 0,
                  "podag": metrics.counters["podag"][1] if "podag" in metrics.counters else 0,
                  "posh": metrics.counters["posh"][0] if "posh" in metrics.counters else 0,
                  "cdq": [chain_cdq_cuda.PLAIN_PROBLEMS,
                          chain_cdq_cuda.PLAIN_ANCHORS,
                          chain_cdq_cuda.LAUNCHES],
                  "scan": [chain_scan_cuda.PLAIN_PROBLEMS,
                           chain_scan_cuda.PLAIN_ANCHORS,
                           chain_scan_cuda.LAUNCHES],
                  "foreign": mods,
                  "workers_foreign": sorted(counters.FOREIGN)}}),
      file=sys.stderr)
sys.exit(rc)
"""


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CENTROLIGN_")}
    env.update(kw)
    return env


def _run_port(argv, **env):
    r = subprocess.run([sys.executable, "-c",
                        _PORT.format(repo=REPO, argv=list(argv))],
                       capture_output=True, text=True, timeout=600,
                       cwd=REPO, env=_env(**env))
    stats = json.loads(r.stderr.strip().splitlines()[-1])
    return r, stats


def _run_jax_cli(argv, **env):
    return subprocess.run(
        [sys.executable, "-m", "centrolign_tpu.cli", *argv],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=_env(JAX_PLATFORMS="cpu", CENTROLIGN_TPU_USE_DEVICE="0", **env))


def _write_pair(path, seed):
    """A mutated ~4 kb pair with five divergent blocks: the blocks hold no
    anchors, so each becomes one chain gap of ~10^4-10^5 DP cells."""
    rng = np.random.default_rng(seed)
    a = random_sequence(rng, 4000)
    b = mutate_sequence(rng, a, sub_rate=0.02, indel_rate=0.01)
    out, pos = [], 0
    starts = rng.choice(np.arange(200, len(b) - 600, 500), 5, replace=False)
    for start in sorted(starts):
        L = int(rng.integers(150, 400))
        out += [b[pos:start], random_sequence(rng, L + int(rng.integers(-60, 60)))]
        pos = start + L
    out.append(b[pos:])
    path.write_text(f">a\n{a}\n>b\n{''.join(out)}\n")
    return str(path)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pairs")
    return {seed: _write_pair(d / f"pair{seed}.fasta", seed) for seed in (1, 2)}


@pytest.mark.parametrize("seed", [1, 2])
def test_cigar_matches_jax_cli_with_device_tier_on_cpu(pairs, seed):
    argv = ["-v", "0", "-u", pairs[seed]]
    ref = _run_jax_cli(argv)
    assert ref.returncode == 0, ref.stderr
    r, stats = _run_port(argv, CENTROLIGN_TORCH_DEVICE="cpu",
                         CENTROLIGN_TORCH_DEVICE_MIN_CELLS="10000")
    assert r.returncode == 0, r.stderr
    assert r.stdout == ref.stdout
    assert stats["jobs"] > 0 and stats["pod"] > 0
    # launches count CUDA kernel launches; the CPU runs the plain versions
    assert stats["fills"] == 0
    assert stats["foreign"] == []


def test_cigar_matches_jax_cli_with_device_chaining_on_cpu(pairs):
    """Both device-chaining switches: the CDQ value pass and the three
    free-gap calibration chains go through the plain scans on the CPU
    (anchor budget cut to 3,000 pairs so that the JAX scans finish on the
    CPU in seconds) and give the JAX CLI's CIGAR with the same switches."""
    argv = ["-v", "0", "-u", "-a", "3000", pairs[1]]
    chaining = {"CENTROLIGN_TPU_DEVICE_CDQ": "1",
                "CENTROLIGN_TPU_DEVICE_CHAIN": "1"}
    ref = _run_jax_cli(argv, **chaining)
    assert ref.returncode == 0, ref.stderr
    r, stats = _run_port(argv, CENTROLIGN_TORCH_DEVICE="cpu", **chaining)
    assert r.returncode == 0, r.stderr
    assert r.stdout == ref.stdout
    cdq_problems, cdq_anchors, cdq_launches = stats["cdq"]
    scan_problems, scan_anchors, scan_launches = stats["scan"]
    assert (cdq_problems, scan_problems) == (1, 3)
    assert cdq_anchors > 1000 and scan_anchors > 3000
    assert cdq_launches == scan_launches == 0
    assert stats["foreign"] == []


def test_cigar_matches_without_device_tier(pairs):
    argv = ["-v", "0", "-u", pairs[1]]
    ref = _run_jax_cli(argv)
    r, stats = _run_port(argv, CENTROLIGN_TORCH_DEVICE="none",
                         CENTROLIGN_TORCH_DEVICE_MIN_CELLS="10000")
    assert r.returncode == 0, r.stderr
    assert r.stdout == ref.stdout
    assert stats["jobs"] == 0 and stats["pod"] == 0
    assert stats["foreign"] == []


def test_module_entry_point(pairs):
    argv = ["-v", "0", "-u", pairs[2]]
    ref = _run_jax_cli(argv)
    r = subprocess.run(
        [sys.executable, "-m", "centrolign_tpu_torch.cli", *argv],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=_env(CENTROLIGN_TORCH_DEVICE="cpu",
                 CENTROLIGN_TORCH_DEVICE_MIN_CELLS="10000"))
    assert r.returncode == 0, r.stderr
    assert r.stdout == ref.stdout


def test_no_fallback_without_cuda(pairs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    r, stats = _run_port(["-v", "0", pairs[1]])
    assert r.returncode != 0 and stats["rc"] != 0
    assert "torch.cuda.is_available() is false" in r.stderr
    assert stats["jobs"] == 0


def test_multi_host_is_not_ported(pairs):
    """The name is historical: --hosts 2 runs the pool executor
    (parallel/scheduler.py), whose CIGAR is the JAX CLI's with --hosts 2;
    its worker (a leaf's calibration) loads neither jax nor the JAX
    package."""
    argv = ["-v", "0", "-u", "--hosts", "2", pairs[1]]
    ref = _run_jax_cli(argv)
    assert ref.returncode == 0, ref.stderr
    r, stats = _run_port(argv, CENTROLIGN_TORCH_DEVICE="cpu",
                         CENTROLIGN_TORCH_DEVICE_MIN_CELLS="10000")
    assert r.returncode == 0, r.stderr
    assert r.stdout == ref.stdout
    assert stats["jobs"] > 0 and stats["fills"] == 0
    assert stats["foreign"] == [] and stats["workers_foreign"] == []
    assert "Worker failed" not in r.stderr


def test_jaxdist_with_one_host_runs_serially(tmp_path):
    """CENTROLIGN_TPU_EXECUTOR=jaxdist with one host runs serially, as in
    the JAX package (centrolign_tpu/cli.py:143-174)."""
    fasta = tmp_path / "tiny.fasta"
    fasta.write_text(">a\nACGTACGTTGCA\n>b\nACGAACGTTGCA\n")
    r, stats = _run_port(["-v", "0", str(fasta)],
                         CENTROLIGN_TORCH_DEVICE="cpu",
                         CENTROLIGN_TPU_EXECUTOR="jaxdist")
    assert r.returncode == 0, r.stderr
    assert r.stdout == "3=1X8=\n"
    assert stats["foreign"] == []


def test_generate_config_matches_jax_cli():
    ref = _run_jax_cli(["-G"])
    r, stats = _run_port(["-G"], CENTROLIGN_TORCH_DEVICE="cpu")
    assert r.returncode == 0 and ref.returncode == 0
    assert r.stdout == ref.stdout


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device("none") is None
    with pytest.raises(ValueError):
        resolve_device("tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def _foreign_imports(path):
    """Imports of jax or of the JAX package, and writes to sys.modules."""
    tree = ast.parse(open(path).read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = ["." * node.level + (node.module or "")]
        else:
            names = []
        found += [n for n in names if n.split(".")[0] in ("jax",
                                                          "centrolign_tpu")]
        targets = (node.targets if isinstance(node, ast.Assign) else
                   [node.target] if isinstance(node, ast.AugAssign) else [])
        for t in targets:
            if isinstance(t, ast.Subscript) and ast.unparse(
                    t.value) == "sys.modules":
                found.append(f"sys.modules[...] = at line {node.lineno}")
        if isinstance(node, ast.Call) and ast.unparse(node.func) in (
                "sys.modules.setdefault", "sys.modules.update",
                "sys.modules.__setitem__"):
            found.append(f"{ast.unparse(node.func)} at line {node.lineno}")
    return found


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_never_imports_jax():
    files = _port_files()
    assert len(files) > 40
    found = {f: _foreign_imports(f) for f in files}
    assert {f: v for f, v in found.items() if v} == {}


def test_self_containment_scan_has_teeth(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import sys\nimport jax.numpy as jnp\n"
                   "from centrolign_tpu.graph import BaseGraph\n"
                   "sys.modules['jax'] = None\n"
                   "sys.modules.setdefault('x', None)\n"
                   "from centrolign_tpu_torch import cli\n")
    assert len(_foreign_imports(str(bad))) == 4


def _write_msa(path, seed):
    """Three mutated copies of one ~4 kb sequence, each with its own random
    blocks at four shared places: the blocks hold no anchors, so the first
    merge leaves bubbles there and the second aligns a chain to a DAG
    across them."""
    rng = np.random.default_rng(seed)
    base = random_sequence(rng, 4000)
    starts = sorted(rng.choice(np.arange(300, 3400, 500), 4, replace=False))
    out = []
    for i in range(3):
        s = mutate_sequence(rng, base, sub_rate=0.02, indel_rate=0.01)
        parts, pos = [], 0
        for start in starts:
            L = int(rng.integers(150, 300))
            parts += [s[pos:start],
                      random_sequence(rng, L + int(rng.integers(-40, 40)))]
            pos = start + L
        parts.append(s[pos:])
        out.append(f">g{i}\n{''.join(parts)}\n")
    path.write_text("".join(out))
    return str(path)


def test_msa_gfa_matches_jax_cli_with_dag_tier_on_cpu(tmp_path):
    fasta = _write_msa(tmp_path / "msa.fasta", 909)
    argv = ["-v", "0", "-u", fasta]
    ref = _run_jax_cli(argv)
    assert ref.returncode == 0, ref.stderr
    r, stats = _run_port(argv, CENTROLIGN_TORCH_DEVICE="cpu",
                         CENTROLIGN_TORCH_DEVICE_DAG="1",
                         CENTROLIGN_TORCH_DEVICE_MIN_CELLS="10000")
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("H\t") and r.stdout == ref.stdout
    assert stats["dag_jobs"] > 0 and stats["podag"] > 0
    assert stats["dag_fills"] == 0
    assert stats["foreign"] == []


def test_device_memory_usage_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from centrolign_tpu_torch.utils.memory import device_memory_usage
    assert device_memory_usage() == -1


# Options of the CLI (cli.py, build_argparser) held against the JAX CLI one
# at a time: the output and every side file byte-equal. "{dir}" is the run's
# own directory (side files), "{cfg}" a config that -G wrote, naming the
# FASTA (a config overrides every other argument) with the partition off
# (as -u), logging off and max_count lowered, so a config that is not read
# shows.
_OPTION_CASES = {
    "all-pairs": ["-u", "-A", "{dir}/ap"],
    "g0": ["-g", "0"],
    "g1": ["-g", "1"],
    "u-g1": ["-u", "-g", "1"],
    "max-count": ["-u", "-m", "10"],
    "count-power": ["-u", "-p", "2"],
    "config": ["-C", "{cfg}"],
    "skip-calibration": ["-u", "--skip-calibration"],
    "force-gfa-output": ["-u", "--force-gfa-output"],
}


def _side_files(d):
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("case", list(_OPTION_CASES))
def test_option_matches_jax_cli(pairs, tmp_path, case):
    """Each option through both CLIs at once, the port with its device
    tier on the CPU: byte-equal output and side files (-A on a 3-sequence
    input, the others on _write_pair(.., 1))."""
    from concurrent.futures import ThreadPoolExecutor

    fasta = (_write_msa(tmp_path / "msa.fasta", 909) if case == "all-pairs"
             else pairs[1])
    cfg = tmp_path / "config.yaml"
    if case == "config":
        gen = _run_jax_cli(["-G"])
        assert gen.returncode == 0
        text = gen.stdout
        for old, new in (('fasta_name: ""', f'fasta_name: "{fasta}"'),
                         ("logging_level: 2", "logging_level: 0"),
                         ("constraint_method: 3", "constraint_method: 0"),
                         ("max_count: 3000", "max_count: 10")):
            assert old in text
            text = text.replace(old, new)
        cfg.write_text(text)
    dirs = {tag: tmp_path / tag for tag in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()

    def argv(tag):
        return ["-v", "0", *(a.format(dir=dirs[tag], cfg=cfg)
                             for a in _OPTION_CASES[case]), fasta]

    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_run_jax_cli, argv("jax"))
        port = pool.submit(_run_port, argv("port"),
                           CENTROLIGN_TORCH_DEVICE="cpu",
                           CENTROLIGN_TORCH_DEVICE_MIN_CELLS="10000")
        ref, (r, stats) = ref.result(), port.result()
    assert ref.returncode == 0, ref.stderr
    assert r.returncode == 0, r.stderr
    assert r.stdout == ref.stdout and r.stdout
    assert _side_files(dirs["port"]) == _side_files(dirs["jax"])
    if case == "all-pairs":
        assert len(_side_files(dirs["jax"])) == 3
    if case == "force-gfa-output":
        assert r.stdout.startswith("H\t")
    assert stats["foreign"] == []

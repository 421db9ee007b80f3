"""The port's tools (centrolign_tpu_torch/tools/) against the JAX
package's (centrolign_tpu/tools/), each run with the same arguments on the
same inputs in its own process: stdout and every file written are
identical, the quirks included (tree_compare's unary node,
find_universal_bridges' position 0). The JAX package's tools are the
reference here, as the reference's script binaries are absent.

Tolerance: exact (byte-equal output).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_cli import REPO, _env

FIFTY = os.path.join(REPO, "benchdata", "fifty.nwk")


def _tool(package, module, args, cwd, **env):
    return subprocess.run(
        [sys.executable, "-m", f"{package}.tools.{module}", *args],
        capture_output=True, text=True, timeout=600, cwd=cwd,
        env=_env(PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
                 CENTROLIGN_TORCH_DEVICE="cpu", **env))


def _both(module, args, tmp_path, outputs=()):
    """Runs the tool of each package in its own directory; returns both
    results after checking that stdout and the named output files agree."""
    runs = []
    for package in ("centrolign_tpu", "centrolign_tpu_torch"):
        d = tmp_path / package
        d.mkdir(exist_ok=True)
        r = _tool(package, module, args, d)
        assert r.returncode == 0, (package, r.stderr[-800:])
        runs.append((r, d))
    (ref, dref), (got, dgot) = runs
    assert got.stdout == ref.stdout
    for name in outputs:
        assert (dgot / name).read_bytes() == (dref / name).read_bytes(), name
    return ref, got


@pytest.fixture(scope="module")
def msa_gfa(tmp_path_factory):
    """tests/test_tools_scripts.py's 3-sequence graph with an internal
    universal bridge, made by the JAX CLI on its host path."""
    d = tmp_path_factory.mktemp("msa")
    rng = np.random.default_rng(77)
    core = "".join("ACGT"[i] for i in rng.integers(0, 4, 300))
    fa = d / "in.fa"
    with open(fa, "w") as f:
        for i in range(3):
            pre = "".join("ACGT"[c] for c in rng.integers(0, 4, 150 + 40 * i))
            suf = "".join("ACGT"[c] for c in rng.integers(0, 4, 170 + 30 * i))
            f.write(f">b{i}\n{pre}{core}{suf}\n")
    r = subprocess.run(
        [sys.executable, "-m", "centrolign_tpu.cli", "-v", "0", str(fa)],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=_env(JAX_PLATFORMS="cpu", CENTROLIGN_TPU_USE_DEVICE="0"))
    assert r.returncode == 0, r.stderr[-500:]
    gfa = d / "g.gfa"
    gfa.write_text(r.stdout)
    return gfa


def test_tree_pair_dist(tmp_path):
    _both("tree_pair_dist", [FIFTY], tmp_path)


def test_tree_compare(tmp_path):
    flat = tmp_path / "flat.nwk"
    flat.write_text('("A":1,"B":1,"C":1,"D":1);\n')
    unary = tmp_path / "unary.nwk"
    unary.write_text('("A":1,("B":1)u:1,"C":1,"D":1);\n')
    nested = tmp_path / "nested.nwk"
    nested.write_text('(("A":1,"B":1):1,("C":1,"D":1):1);\n')
    for pair in ([FIFTY, FIFTY], [str(unary), str(flat)],
                 [str(nested), str(flat)], [str(flat), str(nested)]):
        _both("tree_compare", pair, tmp_path)


def test_remove_samples(tmp_path, msa_gfa):
    nwk = tmp_path / "t.nwk"
    nwk.write_text('(("b0":1,"b1":1):1,"b2":2);\n')
    ref, _ = _both("remove_samples",
                   ["-p", "out", "-s", "b1", "-t", str(nwk), "-T", "t.nwk",
                    "-f", "fa", str(msa_gfa)], tmp_path,
                   outputs=("t.nwk", "fa_b1.fasta"))
    made = sorted(p.name for p in (tmp_path / "centrolign_tpu").iterdir()
                  if p.name.startswith("out_"))
    assert made
    for name in made:
        assert ((tmp_path / "centrolign_tpu_torch" / name).read_bytes()
                == (tmp_path / "centrolign_tpu" / name).read_bytes())


def test_find_universal_bridges(tmp_path, msa_gfa):
    for flags in ([], ["-r"]):
        ref, _ = _both("find_universal_bridges", [*flags, str(msa_gfa)],
                       tmp_path)
        assert "node:" in ref.stdout


@pytest.mark.parametrize("opts", [[], ["-b", "-i", "-m"],
                                  ["-n", "-c", "-p", "-b", "-i"],
                                  ["-i", "-m", "-s", "-b", "-a", "-f"]])
def test_make_var_mat(tmp_path, msa_gfa, opts):
    _both("make_var_mat", [*opts, "-C", "ci.txt", str(msa_gfa)], tmp_path,
          outputs=("ci.txt",))


def test_sim_centromere_and_compare_truth_aln(tmp_path):
    """sim_centromere on the first 30 monomers of the bench ancestor (the
    files of both packages equal), then compare_truth_aln of the truth
    CIGAR against itself and against a CIGAR without indels up front."""
    bed_lines = []
    with open(os.path.join(REPO, "benchdata", "anc.bed")) as f:
        for line in f:
            bed_lines.append(line)
            if len(bed_lines) == 30:
                break
    end = int(bed_lines[-1].split()[2])
    with open(os.path.join(REPO, "benchdata", "anc.fasta")) as f:
        lines = f.read().split("\n")
    name, seq = lines[0][1:], "".join(lines[1:])
    fa = tmp_path / "anc.fa"
    fa.write_text(f">{name}\n{seq[:end]}\n")
    bed = tmp_path / "anc.bed"
    bed.write_text("".join(bed_lines))
    suffixes = ("_seq1.fasta", "_seq2.fasta", "_seq1_identity.txt",
                "_seq2_identity.txt", "_seq1_seq2_cigar.txt", "_info.txt")
    _both("sim_centromere", ["-o", "sim", "-g", "40", "-z", "7", str(fa),
                             str(bed)], tmp_path,
          outputs=[f"sim{s}" for s in suffixes])
    d = tmp_path / "centrolign_tpu"
    truth = d / "sim_seq1_seq2_cigar.txt"
    n1 = len("".join((d / "sim_seq1.fasta").read_text().split("\n")[1:]))
    n2 = len("".join((d / "sim_seq2.fasta").read_text().split("\n")[1:]))
    m = min(n1, n2)
    other = tmp_path / "other.txt"
    other.write_text(f"{m}M{n1 - m}I{n2 - m}D\n")
    for cigar in (truth, other):
        _both("compare_truth_aln", [str(d / "sim_seq1_identity.txt"),
                                    str(d / "sim_seq2_identity.txt"),
                                    str(truth), str(cigar)], tmp_path)

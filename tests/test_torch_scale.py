"""The port at its users' sizes, against references the JAX package wrote.

tests/torch_ref/ holds a simulated centromere pair of 1.1 Mbp a sequence
(mbpair.fasta.gz, with its recipe and sha256 in mbpair.json), the JAX
CLI's CIGAR on it (ref_mbpair.cigar.txt) and the JAX CLI's GFA on
benchdata/ten.fasta + ten.nwk (ref_ten.gfa), each from
`JAX_PLATFORMS=cpu CENTROLIGN_TPU_USE_DEVICE=0 python -m centrolign_tpu.cli
-v 0`. Both packages' simulator must rebuild the pair from its recipe, and
both CLIs must give the references. Also chip_smoke's stage split of a
run's wall, on a fixed log. Every comparison is exact (bytes).

The MSA on ten.fasta (about 220 s a CLI here) and the pair through the
port's device tier on the CPU (its plain fill, 2-5 min) are marked slow.
"""

import gzip
import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import chip_smoke
from conftest import mutate_sequence, random_sequence
from test_torch_cli import REPO, _run_jax_cli, _run_port
from test_torch_tools import _tool

REF = os.path.join(REPO, "tests", "torch_ref")
TEN = os.path.join(REPO, "benchdata", "ten.fasta")
TEN_TREE = os.path.join(REPO, "benchdata", "ten.nwk")


def _recipe():
    with open(os.path.join(REF, "mbpair.json")) as f:
        return json.load(f)


def _ref(name):
    with open(os.path.join(REF, name)) as f:
        return f.read()


@pytest.fixture(scope="module")
def mbpair(tmp_path_factory):
    """The pair unpacked, its sha256 checked against the recipe's."""
    with gzip.open(os.path.join(REF, "mbpair.fasta.gz"), "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == _recipe()["sha256"]
    path = tmp_path_factory.mktemp("mbpair") / "mbpair.fasta"
    path.write_bytes(data)
    return str(path)


def _write_ancestor(d, meta):
    """mbpair.json's tiled ancestor: the sequence `copies` times as one
    record, 80 bases a line, and each BED row once a copy, shifted by
    copy_length times the copy's index."""
    with open(os.path.join(REPO, meta["ancestor"])) as f:
        seq = "".join(line.strip() for line in f if not line.startswith(">"))
    assert len(seq) == meta["copy_length"]
    tiled = seq * meta["copies"]
    (d / "anc6.fasta").write_text(
        ">anc\n" + "".join(tiled[i:i + 80] + "\n"
                           for i in range(0, len(tiled), 80)))
    with open(os.path.join(REPO, meta["bed"])) as f:
        rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    (d / "anc6.bed").write_text("".join(
        "\t".join([r[0], str(int(r[1]) + c * len(seq)),
                   str(int(r[2]) + c * len(seq)), *r[3:]]) + "\n"
        for c in range(meta["copies"]) for r in rows))
    (d / "pair.nwk").write_text(meta["tree"] + "\n")


def test_sim_centromere_rebuilds_the_pair(mbpair, tmp_path):
    """Both packages' tools.sim_centromere on mbpair.json's recipe, at
    once: seq1 then seq2 as they write them equal the committed pair."""
    meta = _recipe()
    args = ["anc6.fasta", "anc6.bed", "-o", "mbpair", "-T", "pair.nwk",
            "-z", str(meta["seed"])]
    dirs = {}
    for package in ("centrolign_tpu", "centrolign_tpu_torch"):
        dirs[package] = tmp_path / package
        dirs[package].mkdir()
        _write_ancestor(dirs[package], meta)
    with ThreadPoolExecutor(2) as pool:
        runs = {package: pool.submit(_tool, package, "sim_centromere", args,
                                     d)
                for package, d in dirs.items()}
        runs = {package: r.result() for package, r in runs.items()}
    with open(mbpair, "rb") as f:
        want = f.read()
    for package, r in runs.items():
        assert r.returncode == 0, (package, r.stderr[-800:])
        d = dirs[package]
        got = b"".join((d / f"mbpair_{name}.fasta").read_bytes()
                       for name in meta["names"])
        assert hashlib.sha256(got).hexdigest() == meta["sha256"]
        assert got == want


def test_pair_cigar_matches_reference_on_the_host(mbpair):
    """The port's CLI without a device tier and the JAX CLI's host path, at
    once: both CIGARs equal ref_mbpair.cigar.txt."""
    argv = ["-v", "0", mbpair]
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_run_jax_cli, argv)
        port = pool.submit(_run_port, argv, CENTROLIGN_TORCH_DEVICE="none")
        ref, (r, stats) = ref.result(), port.result()
    want = _ref("ref_mbpair.cigar.txt")
    assert hashlib.sha256(want.encode()).hexdigest() == \
        _recipe()["ref_cigar_sha256"]
    assert ref.returncode == 0, ref.stderr[-800:]
    assert r.returncode == 0, r.stderr[-800:]
    assert ref.stdout == want
    assert r.stdout == want
    assert stats["jobs"] == 0 and stats["foreign"] == []


# a CLI log at -v 3 as centrolign_tpu_torch/logging.py stamps it: a
# three-leaf MSA (two subproblems), with the continuation lines of the
# subproblems' sequences and a message no stage starts
_LOG = """\
[centrolign_tpu] elapsed: 0:00:01.5 Initializing leaf subproblems.
[centrolign_tpu] elapsed: 0:00:01.7 Calibrating scale of anchoring parameters.
[centrolign_tpu] elapsed: 0:00:01.7 Estimating scale for sequence 1.
[centrolign_tpu] elapsed: 0:00:09.0 Estimating scale for sequence 2.
[centrolign_tpu] elapsed: 0:00:10.2 Beginning MSA.
[centrolign_tpu] elapsed: 0:00:10.3 Next subproblem contains sequences:
\tg1
\tg0
[centrolign_tpu] elapsed: 0:00:10.4 Finding matches.
[centrolign_tpu] elapsed: 0:00:11.9 Computing reachability.
[centrolign_tpu] elapsed: 0:00:59.5 Chained 7311 anchors.
[centrolign_tpu] elapsed: 0:01:00.8 Partitioned into 3 alignable segments; stitching.
[centrolign_tpu] elapsed: 0:01:04.7 Fusing MSAs along the alignment.
[centrolign_tpu] elapsed: 0:01:04.9 Next subproblem contains sequences:
\tg2
\tg1
\tg0
[centrolign_tpu] elapsed: 0:01:05.0 Finding matches.
[centrolign_tpu] elapsed: 0:01:05.6 Some message inside match finding.
[centrolign_tpu] elapsed: 0:01:06.1 Computing reachability.
[centrolign_tpu] elapsed: 1:01:06.1 Chained 12 anchors.
[centrolign_tpu] elapsed: 1:01:06.3 Partitioned into 1 alignable segments; stitching.
[centrolign_tpu] elapsed: 1:01:07.0 Fusing MSAs along the alignment.
[centrolign_tpu] elapsed: 1:01:07.4 Peak memory usage so far: 753.97 MB.
[centrolign_tpu] elapsed: 1:01:07.4 Maximum memory usage: 753.97 MB.
[centrolign_tpu] elapsed: 1:01:07.6 Run completed successfully, exiting.
"""


def test_stage_split_of_a_fixed_log():
    split = chip_smoke.stage_split(_LOG)
    assert split["setup"] == 0.3
    assert split["calibration"] == 8.5
    assert split["end"] == 0.2
    assert split["subproblems"] == [
        {"sequences": ["g1", "g0"], "match": 1.6, "reach_chain": 47.6,
         "partition": 1.3, "stitch": 3.9, "fuse": 0.2},
        {"sequences": ["g2", "g1", "g0"], "match": 1.2,
         "reach_chain": 3600.0, "partition": 0.2, "stitch": 0.7,
         "fuse": 0.4},
    ]
    assert chip_smoke.stage_split("") == {
        "setup": 0.0, "calibration": 0.0, "bonding": [], "subproblems": [],
        "cyclize": 0.0, "polish": 0.0, "end": 0.0}


@pytest.mark.parametrize("mark", chip_smoke.SUBPROBLEM_MARKS)
def test_stage_split_refuses_a_missing_mark(mark):
    """A subproblem whose log lacks the message that starts one of its
    stages (one renamed, say) is refused, not folded into the stage
    before it."""
    lines = _LOG.splitlines(keepends=True)
    k = next(i for i, line in enumerate(lines) if line.startswith("[")
             and line.split(" ", 3)[3].startswith(mark))
    with pytest.raises(ValueError, match="subproblem 1 "):
        chip_smoke.stage_split("".join(lines[:k] + lines[k + 1:]))


def test_stage_split_of_the_port_cli_log(tmp_path):
    """The port's CLI at -v 3 on a three-sequence MSA: stage_split finds
    every stage of both subproblems in the log it writes."""
    rng = np.random.default_rng(7)
    a = random_sequence(rng, 600)
    seqs = [a] + [mutate_sequence(rng, a, 0.02, 0.01) for _ in range(2)]
    fasta, tree = tmp_path / "three.fasta", tmp_path / "three.nwk"
    fasta.write_text("".join(f">s{k}\n{s}\n" for k, s in enumerate(seqs)))
    tree.write_text("((s0:1,s1:1):1,s2:1);\n")
    r, stats = _run_port(["-v", "3", "-T", str(tree), str(fasta)],
                         CENTROLIGN_TORCH_DEVICE="none")
    assert r.returncode == 0, r.stderr[-800:]
    split = chip_smoke.stage_split(r.stderr)
    assert [sorted(s["sequences"]) for s in split["subproblems"]] == [
        ["s0", "s1"], ["s0", "s1", "s2"]]
    assert stats["foreign"] == []


@pytest.mark.slow
def test_ten_gfa_matches_reference_on_the_host():
    """ten.fasta + ten.nwk through the port's CLI without a device tier
    and the JAX CLI's host path, at once: both GFAs equal ref_ten.gfa."""
    argv = ["-v", "0", "-T", TEN_TREE, TEN]
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_run_jax_cli, argv)
        port = pool.submit(_run_port, argv, CENTROLIGN_TORCH_DEVICE="none")
        ref, (r, stats) = ref.result(), port.result()
    want = _ref("ref_ten.gfa")
    assert ref.returncode == 0, ref.stderr[-800:]
    assert r.returncode == 0, r.stderr[-800:]
    assert ref.stdout == want
    assert r.stdout == want
    assert stats["foreign"] == []


@pytest.mark.slow
def test_pair_cigar_matches_reference_through_the_plain_versions(mbpair):
    """The pair through the port's device tier on the CPU (the plain fill
    and traceback): the CIGAR equals ref_mbpair.cigar.txt."""
    r, stats = _run_port(["-v", "0", mbpair], CENTROLIGN_TORCH_DEVICE="cpu")
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout == _ref("ref_mbpair.cigar.txt")
    assert stats["jobs"] == 218 and stats["pod"] == 86_385_989
    assert stats["foreign"] == []

"""-c (tandem-duplication cyclizing) through the port against the JAX
package.

tests/torch_ref/mbpair_cyc.cfg is a -G config with -c on, -v 3, the -S,
-s and bond files under one directory ({out}) and the polish after
cyclizing switched off by its three settings (max_realignment_cycle_size
0, inconsistent_indel_window 0, min_inconsistency_total_length
1000000000): with the polish on, both packages raise ZeroDivisionError in
its first realignment problem (InducedMatchFinderComponentView.find_matches,
when every subpath of the second graph comes from a parent path already
seen in the first), and what the right output is there only the C++
reference binary can say. ref_mbpair_cyc.gfa.gz is the JAX
CLI's GFA on the megabase pair with that config, mbpair_cyc.json its
record (the bonds found by round, each side file's size and sha256), and
mbpair_cyc_jobs.json the chain jobs of a CPU run of the port
(chip_smoke.record_cyclize_jobs).

Here: that shared fault, pinned in both packages; the record against the
GFA; a tandem input of three 1.5 kbp copies through both CLIs with the
config (the port's device tier on the CPU, its internal stitches
dispatching jobs); chip_smoke's stage split of a -c log. Marked slow: the
fault through both CLIs on three 3 kbp copies, and the megabase pair
through the port's host path against the record. Every comparison is
exact (bytes).
"""

import gzip
import hashlib
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import chip_smoke
from centrolign_tpu import induced_match_finder as jax_imf
from centrolign_tpu.graph import BaseGraph as JaxGraph
from centrolign_tpu_torch import induced_match_finder as port_imf
from centrolign_tpu_torch.graph import BaseGraph as PortGraph
from conftest import mutate_sequence, random_sequence
from test_torch_cli import REPO, _env, _run_jax_cli
from test_torch_scale import REF, mbpair  # noqa: F401 (a fixture)

CPU_TIER = {"CENTROLIGN_TORCH_DEVICE": "cpu",
            "CENTROLIGN_TORCH_DEVICE_MIN_CELLS": "4000"}

# runs the port's cli.main with chip_smoke's recording hooks: the chain
# jobs of each internal stitch and of the rest, and the modules loaded, go
# to stderr's last line
_PORT = r"""
import contextlib, io, json, sys
sys.path[:0] = [{repo!r}]
import chip_smoke
from centrolign_tpu_torch import cli
out = io.StringIO()
with chip_smoke.recording() as (chain, _, stitches):
    with contextlib.redirect_stdout(out):
        rc = cli.main({argv!r})
sys.stdout.write(out.getvalue())
print(json.dumps({{"rc": rc, "jobs": chip_smoke.cyclize_jobs(chain, stitches),
                  "foreign": chip_smoke.foreign_modules()}}),
      file=sys.stderr)
sys.exit(rc)
"""


def _run_port(argv, timeout=600, **env):
    r = subprocess.run([sys.executable, "-c",
                        _PORT.format(repo=REPO, argv=list(argv))],
                       capture_output=True, text=True, timeout=timeout,
                       cwd=REPO, env=_env(**env))
    return r, json.loads(r.stderr.strip().splitlines()[-1])


def _tandem_fasta(path, unit, seed, copies=3, block=300):
    """seq1 and seq2, each `copies` copies of one random unit of `unit`
    bp: each copy with 2 % substitutions, 0.5 % insertions and 0.5 %
    deletions, and about `block` bp at a third of its length replaced by
    random sequence."""
    rng = np.random.default_rng(seed)
    base = random_sequence(rng, unit)
    with open(path, "w") as f:
        for name in ("seq1", "seq2"):
            parts = []
            for _ in range(copies):
                c = mutate_sequence(rng, base, sub_rate=0.02, indel_rate=0.01)
                k = len(c) // 3
                size = block + int(rng.integers(-30, 31))
                parts.append(c[:k] + random_sequence(rng, size) + c[k + size:])
            f.write(f">{name}\n{''.join(parts)}\n")
    return str(path)


def _config(d, name, fasta, min_length=None):
    """mbpair_cyc.cfg for `fasta`, its side files in d/name/, with
    min_cyclizing_length set when given: (config path, side directory)."""
    out = d / name
    out.mkdir()
    cfg = chip_smoke.cyclize_config(str(d / f"{name}.cfg"), fasta, str(out))
    if min_length is not None:
        with open(cfg) as f:
            text = f.read()
        assert " min_cyclizing_length: 100000\n" in text
        with open(cfg, "w") as f:
            f.write(text.replace(" min_cyclizing_length: 100000\n",
                                 f" min_cyclizing_length: {min_length}\n"))
    return cfg, str(out)


def bond_rounds(split):
    """{sequence: [tandem duplications found in each bonding round]} of a
    stage_split."""
    rounds = {}
    for rnd in split["bonding"]:
        rounds.setdefault(rnd["sequence"], []).append(rnd["found"])
    return rounds


def _elapsed(log):
    """The last elapsed stamp of a -v 3 log, in seconds."""
    h, m, sec, _ = chip_smoke.STAMP.match(log.splitlines()[-1]).groups()
    return int(h) * 3600 + int(m) * 60 + float(sec)


def record(gfa, out, log, command):
    """mbpair_cyc.json's record of a run: its command, its -v 3 log's last
    elapsed stamp (s), the bonds found by round and the stage split (from
    the same log), the config's sha256, the GFA's (bytes) size and sha256,
    and side_files of its side directory `out`."""
    with open(os.path.join(REF, "mbpair_cyc.cfg"), "rb") as f:
        cfg = f.read()
    split = chip_smoke.stage_split(log)
    return {"what": "the JAX CLI's host path on mbpair.fasta.gz with "
                    "mbpair_cyc.cfg: its GFA (ref_mbpair_cyc.gfa.gz, gzip "
                    "-9 -n) and side files; chip_smoke.py --cyclize and "
                    "tests/test_torch_cyclize.py hold the port to it",
            "command": command,
            "elapsed_s": _elapsed(log),
            "config_sha256": hashlib.sha256(cfg).hexdigest(),
            "bonds": bond_rounds(split), "stages": split,
            "gfa": {"size": len(gfa),
                    "sha256": hashlib.sha256(gfa).hexdigest()},
            "side_files": chip_smoke.side_files(out)}


def write_reference(d):
    """Run the JAX CLI's host path on the megabase pair with
    mbpair_cyc.cfg in the directory `d` (about 11 minutes on a CPU), then
    write ref_mbpair_cyc.gfa.gz and mbpair_cyc.json: how both were
    written."""
    from pathlib import Path
    d = Path(d)
    d.mkdir(parents=True, exist_ok=True)
    with gzip.open(os.path.join(REF, "mbpair.fasta.gz"), "rb") as f:
        (d / "mbpair.fasta").write_bytes(f.read())
    cfg, out = _config(d, "out", str(d / "mbpair.fasta"))
    argv = ["-C", cfg, "--force-gfa-output"]
    r = subprocess.run([sys.executable, "-m", "centrolign_tpu.cli", *argv],
                       capture_output=True, cwd=REPO,
                       env=_env(JAX_PLATFORMS="cpu",
                                CENTROLIGN_TPU_USE_DEVICE="0"))
    assert r.returncode == 0, r.stderr[-800:]
    (d / "ref_mbpair_cyc.gfa").write_bytes(r.stdout)
    gz = subprocess.run(
        ["gzip", "-9", "-n", "-c", str(d / "ref_mbpair_cyc.gfa")],
        capture_output=True, check=True).stdout
    with open(os.path.join(REF, "ref_mbpair_cyc.gfa.gz"), "wb") as f:
        f.write(gz)
    command = ("JAX_PLATFORMS=cpu CENTROLIGN_TPU_USE_DEVICE=0 python -m "
               "centrolign_tpu.cli -C mbpair_cyc.cfg --force-gfa-output")
    with open(os.path.join(REF, "mbpair_cyc.json"), "w") as f:
        json.dump(record(r.stdout, out, r.stderr.decode(), command), f,
                  indent=1)
        f.write("\n")


# ---------------------------------------------------------------------------
# (a) the polish's ZeroDivisionError, shared by both packages

_PACKAGES = {"centrolign_tpu": (JaxGraph, jax_imf),
             "centrolign_tpu_torch": (PortGraph, port_imf)}


def _graph(Graph, paths):
    """A graph of one chain of nodes per path, each path over its own."""
    g = Graph()
    for name, length in paths:
        nodes = g.add_nodes(np.arange(length) % 4)
        if length > 1:
            g.add_edges(nodes[:-1], nodes[1:])
        g.extend_path_array(g.add_path(name), nodes)
    return g


def _find(package, names1, names2):
    """The package's InducedMatchFinderComponentView over a parent graph
    of paths seq1 and seq2 (40 nodes each) and no hits, on two graphs of
    subpaths named `name:begin-end`."""
    Graph, imf = _PACKAGES[package]
    parent = _graph(Graph, [("seq1", 40), ("seq2", 40)])

    def sub(names):
        return _graph(Graph, [(n, 10) for n in names])
    view = imf.InducedMatchFinderComponentView(parent, [])
    return view.find_matches(sub(names1), sub(names2), None, None)


@pytest.mark.parametrize("package", sorted(_PACKAGES))
def test_polish_zero_division_is_shared(package):
    """Both packages' component view divide by the parent-path length of
    graph 2, counted only over parent paths graph 1 has not named: when
    graph 2's subpaths all come from paths graph 1 saw (a realignment
    that merges copies of both sequences on both sides), it is 0 and the
    view raises. Pinned, not fixed: what the C++ reference gives there
    (a double division, +inf) cannot be derived without its binary; a fix
    in one package alone fails this test."""
    with pytest.raises(ZeroDivisionError):
        _find(package, ["seq2:929749-929758", "seq1:924934-924943"],
              ["seq2:754299-754308", "seq1:742307-742316"])


def test_polish_view_agrees_when_graph2_has_its_own_path():
    """The same view with a parent path that only graph 2 names: no
    error, and both packages find the same (no) matches."""
    got = {package: _find(package, ["seq1:0-9", "seq1:20-29"],
                          ["seq2:0-9", "seq1:5-14"])
           for package in _PACKAGES}
    assert got["centrolign_tpu"] == got["centrolign_tpu_torch"] == []


@pytest.mark.slow
def test_polish_crash_through_both_clis(tmp_path):
    """Three 3 kbp copies a sequence with -c -y 2500 and the polish on,
    through both CLIs at once: both exit 1 with ZeroDivisionError at the
    same realignment problem, and every side file written before it is
    byte-equal (cp_info.txt without its directory)."""
    fasta = _tandem_fasta(tmp_path / "in.fa", 3000, seed=7)

    def argv(name):
        out = tmp_path / name
        out.mkdir()
        return ["-v", "3", "-c", "-y", "2500", "--force-gfa-output",
                "-S", str(out / "cp"), "-s", str(out / "sub.txt"),
                "--bond-prefix", str(out / "bond"), fasta]
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_run_jax_cli, argv("jax"))
        port = pool.submit(
            subprocess.run,
            [sys.executable, "-m", "centrolign_tpu_torch.cli", *argv("port")],
            capture_output=True, text=True, timeout=600, cwd=REPO,
            env=_env(**CPU_TIER))
        ref, r = ref.result(), port.result()
    assert ref.returncode == 1 and r.returncode == 1
    for log, package in ((ref.stderr, "centrolign_tpu"),
                         (r.stderr, "centrolign_tpu_torch")):
        site = f"{package}/induced_match_finder.py"
        assert site in log and "ZeroDivisionError: division by zero" in log

    def last_problem(log):
        return [line.split("elapsed: ")[1].split(" ", 1)[1]
                for line in log.splitlines()
                if "Performing realignment problem" in line][-1]
    assert last_problem(ref.stderr) == last_problem(r.stderr)
    assert last_problem(r.stderr).startswith("Performing realignment "
                                             "problem 1 of ")
    jax_files = chip_smoke.side_files(str(tmp_path / "jax"))
    assert len(jax_files) > 4
    assert chip_smoke.side_files(str(tmp_path / "port")) == jax_files


# ---------------------------------------------------------------------------
# (b) the megabase pair's record

def test_record_matches_reference_gfa():
    """mbpair_cyc.json's GFA size and sha256 are ref_mbpair_cyc.gfa.gz's,
    its config sha256 mbpair_cyc.cfg's, its bonds one internal stitch a
    bond CIGAR file, and the pair's chain jobs in mbpair_cyc_jobs.json
    those of the default run (mbpair_jobs.json)."""
    ref, gfa = chip_smoke.cyclize_reference()
    data = gfa.encode()
    assert [len(data), hashlib.sha256(data).hexdigest()] == \
        [ref["gfa"]["size"], ref["gfa"]["sha256"]]
    with open(os.path.join(REF, "ref_mbpair_cyc.gfa.gz"), "rb") as f:
        assert gzip.decompress(f.read()) == data
    with open(os.path.join(REF, "mbpair_cyc.cfg"), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == ref["config_sha256"]
    bonds = {name: sum(rounds) for name, rounds in ref["bonds"].items()}
    cigars = {name: sum(1 for f in ref["side_files"]
                        if f.startswith(f"bond_{name}_cigar_"))
              for name in bonds}
    assert cigars == bonds and sum(bonds.values()) > 0
    with open(os.path.join(REF, "mbpair_cyc_jobs.json")) as f:
        jobs = json.load(f)
    with open(os.path.join(REF, "mbpair_jobs.json")) as f:
        assert jobs["pair"] == json.load(f)["dispatches"]
    assert len(jobs["bonding"]) == sum(bonds.values())
    assert sum(len(d) for bond in jobs["bonding"] for d in bond) > 0


# ---------------------------------------------------------------------------
# (c) a tandem input through both CLIs with the config

def test_cyclize_matches_jax_cli_with_device_tier_on_cpu(tmp_path):
    """Three 1.5 kbp copies a sequence with mbpair_cyc.cfg (-y 1200),
    through both CLIs at once: the GFAs and every side file byte-equal
    (cp_info.txt without its directory); the port's internal stitches
    dispatched chain jobs to its device tier; its stage split finds each
    bonding round with the count the log gives, the cyclizing and the
    polish."""
    fasta = _tandem_fasta(tmp_path / "in.fa", 1500, seed=5)
    jax_cfg, jax_out = _config(tmp_path, "jax", fasta, 1200)
    port_cfg, port_out = _config(tmp_path, "port", fasta, 1200)
    with ThreadPoolExecutor(2) as pool:
        ref = pool.submit(_run_jax_cli, ["-C", jax_cfg, "--force-gfa-output"])
        port = pool.submit(_run_port, ["-C", port_cfg, "--force-gfa-output"],
                           **CPU_TIER)
        ref, (r, stats) = ref.result(), port.result()
    assert ref.returncode == 0, ref.stderr[-800:]
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout == ref.stdout
    files = chip_smoke.side_files(jax_out)
    assert chip_smoke.side_files(port_out) == files
    assert any(name.startswith("bond_") for name in files)
    assert "Identified 0 local regions" in r.stderr
    bonding = stats["jobs"]["bonding"]
    assert bonding and sum(len(d) for bond in bonding for d in bond) > 0
    assert stats["foreign"] == []
    split = chip_smoke.stage_split(r.stderr)
    assert sum(rnd["found"] for rnd in split["bonding"]) == len(bonding)
    assert sorted(bond_rounds(split)) == ["seq1", "seq2"]
    assert len(split["subproblems"]) == 1


# ---------------------------------------------------------------------------
# (d) chip_smoke's stage split of a -c log

# a -c log at -v 3 as centrolign_tpu_torch/logging.py stamps it: two
# leaves with their bonding rounds, the pair, cyclizing and the polish
_LOG = """\
[centrolign_tpu] elapsed: 0:00:00.3 Initializing leaf subproblems.
[centrolign_tpu] elapsed: 0:00:00.6 Calibrating scale of anchoring parameters and identifying tandem duplications.
[centrolign_tpu] elapsed: 0:00:00.6 Estimating scale for sequence 1.
[centrolign_tpu] elapsed: 0:00:07.2 Estimating scale for sequence 2.
[centrolign_tpu] elapsed: 0:00:14.3 Beginning round 1 of tandem duplication detection for sequence seq1.
[centrolign_tpu] elapsed: 0:01:36.2 Found 6 tandem duplications in this round.
[centrolign_tpu] elapsed: 0:01:59.2 Beginning round 2 of tandem duplication detection for sequence seq1.
[centrolign_tpu] elapsed: 0:03:04.9 Found 0 tandem duplications in this round.
[centrolign_tpu] elapsed: 0:03:05.0 Beginning round 1 of tandem duplication detection for sequence seq2.
[centrolign_tpu] elapsed: 0:04:05.0 Found 2 tandem duplications in this round.
[centrolign_tpu] elapsed: 0:04:20.5 Beginning MSA.
[centrolign_tpu] elapsed: 0:04:20.6 Next subproblem contains sequences:
\tseq1
\tseq2
[centrolign_tpu] elapsed: 0:04:21.0 Finding matches.
[centrolign_tpu] elapsed: 0:04:23.0 Computing reachability.
[centrolign_tpu] elapsed: 0:04:33.0 Chained 7311 anchors.
[centrolign_tpu] elapsed: 0:04:35.0 Partitioned into 3 alignable segments; stitching.
[centrolign_tpu] elapsed: 0:04:39.0 Fusing MSAs along the alignment.
[centrolign_tpu] elapsed: 0:04:40.0 Cyclizing the final graph.
[centrolign_tpu] elapsed: 0:05:07.0 Polishing inconsistencies in the cyclized alignment
[centrolign_tpu] elapsed: 0:05:08.5 Identified 0 local regions that may need realignment
[centrolign_tpu] elapsed: 0:05:08.7 Maximum memory usage: 753.97 MB.
[centrolign_tpu] elapsed: 0:05:08.9 Run completed successfully, exiting.
"""


def test_stage_split_of_a_cyclizing_log():
    split = chip_smoke.stage_split(_LOG)
    assert split["setup"] == 0.4
    assert split["calibration"] == 13.7
    assert split["bonding"] == [
        {"sequence": "seq1", "round": 1, "found": 6, "chain": 81.9,
         "stitch": 23.0},
        {"sequence": "seq1", "round": 2, "found": 0, "chain": 65.7,
         "stitch": 0.1},
        {"sequence": "seq2", "round": 1, "found": 2, "chain": 60.0,
         "stitch": 15.5},
    ]
    assert split["subproblems"] == [
        {"sequences": ["seq1", "seq2"], "match": 2.4, "reach_chain": 10.0,
         "partition": 2.0, "stitch": 4.0, "fuse": 1.0}]
    assert split["cyclize"] == 27.0
    assert split["polish"] == 1.7
    assert split["end"] == 0.2


def test_stage_split_of_a_restarted_cyclizing_log():
    """A -R restart reads its bonds back: no bonding round, cyclizing
    all the same."""
    lines = [line for line in _LOG.splitlines(keepends=True)
             if "round" not in line]
    split = chip_smoke.stage_split("".join(lines))
    assert split["bonding"] == []
    assert split["cyclize"] == 27.0


@pytest.mark.parametrize("mark", chip_smoke.CYCLIZE_MARKS)
def test_stage_split_refuses_a_missing_cyclizing_mark(mark):
    """A log without a round's start or count, or without the cyclizing
    or the polish after it, is refused: their time would go to the stage
    before them."""
    lines = _LOG.splitlines(keepends=True)
    k = next(i for i, line in enumerate(lines) if line.startswith("[")
             and line.split(" ", 3)[3].startswith(mark))
    with pytest.raises(ValueError):
        chip_smoke.stage_split("".join(lines[:k] + lines[k + 1:]))


# ---------------------------------------------------------------------------
# (e) the megabase pair through the port's host path

@pytest.mark.slow
def test_megabase_cyclize_matches_record_on_the_host(mbpair,  # noqa: F811
                                                    tmp_path):
    """mbpair_cyc.cfg on the megabase pair through the port's CLI without
    a device tier (about 11 minutes on a CPU): the GFA is
    ref_mbpair_cyc.gfa.gz and every side file has the record's size and
    sha256."""
    ref, gfa = chip_smoke.cyclize_reference()
    cfg, out = _config(tmp_path, "out", mbpair)
    r, stats = _run_port(["-C", cfg, "--force-gfa-output"], timeout=2400,
                         CENTROLIGN_TORCH_DEVICE="none")
    assert r.returncode == 0, r.stderr[-800:]
    assert r.stdout == gfa
    assert chip_smoke.side_files(out) == ref["side_files"]
    assert bond_rounds(chip_smoke.stage_split(r.stderr)) == ref["bonds"]
    assert stats["foreign"] == []

"""The cell cyc2_370k (configuration cyclize-hor: `centrolign -c` with the
polish off, through a parameter file) and its readers: the cell loads and
its one job runs as `--force-gfa-output -C <file>`; the job's key is the
committed expected output's wherever the job is written, traced or not;
the 2-copy ancestor is two shifted copies of anc.fasta and anc.bed; each
new reader on hand-built run records; a small -c cell reports every
per-layer metric of this cell traced; the committed GFA is cyclized."""

import collections
import gzip
import json
import os

import pytest

from conftest import ROOT
from portbench import run as harness
from portbench import spec, traffic
from portbench.reference import expected, paramfile
from test_portbench_params_run import cyc_expected, cyc_root  # noqa: F401

CELL = "cyc2_370k"
KEY = "ccc91d28b2ef95be7b9b18bd40bbf9f5"
COPY = 184680
DATA = os.path.join(ROOT, "portbench", "data")
NEW_METRICS = ["bond_anchor_span_ms_per_kbp.cyc",
               "bond_host_span_ms_per_kbp.cyc",
               "bond_internal_stitch_ms_per_kbp.cyc",
               "cyclize_ms_per_kbp.cyc", "masked_chain_ns_per_anchor.cyc"]
# the pair cell's span, device and counter metrics, and the memory and
# set-up layers, which the cell reports as well
SHARED_METRICS = [
    *(f"{stem}_span_ms_per_kbp.pair" for stem in (
        "calib_match", "calib_chain", "match", "reach", "chain",
        "partition", "stitch", "host_align", "core")),
    "device_wait_ms_per_kbp.pair", "device_idle_pct.pair",
    "gotoh_roofline_pct.pair", "device_cell_pct.pair", "chain_tree_pct.pair",
    "job_rss_mib", "load_s"]


@pytest.fixture(scope="module")
def cohort():
    cell = spec.cell(CELL)
    return cell, traffic.cohorts(cell["config"], cell["traffic"],
                                 traffic.ancestor(cell["config"]))


def test_the_cell_loads_and_its_job_runs_with_a_parameter_file(
        tmp_path, cohort):
    cell, groups = cohort
    assert cell["chips"] == 1
    assert [m["name"] for m in cell["end_to_end"]] == [
        "pair_kbp_per_s", "peak_rss_mib", "setup_s"]
    assert sorted(m["name"] for m in cell["per_layer"]) == sorted(
        NEW_METRICS + SHARED_METRICS)
    assert all(m["moves"] == "pair_kbp_per_s" for m in cell["per_layer"]
               if m["name"] not in ("job_rss_mib", "load_s"))
    assert sorted(len(s) for s in groups[0].values()) == [373113, 380298]
    (job,) = traffic.jobs_of(cell["config"], groups, str(tmp_path),
                             cell["traffic"])
    assert job["params"] and job["output"] == "gfa"
    assert job["argv"][:2] == ["--force-gfa-output", "-C"]
    assert len(job["argv"]) == 3
    with open(job["argv"][2]) as f:
        params = paramfile.parse(f.read())
    assert params == {
        "fasta_name": job["fasta"], "cyclize_tandem_duplications": "true",
        "max_realignment_cycle_size": "0", "inconsistent_indel_window": "0",
        "min_inconsistency_total_length": "1000000000"}


def test_the_jobs_key_is_the_committed_ones(tmp_path, cohort):
    cell, groups = cohort
    keys = set()
    for name, trace in (("one", False), ("two", True), ("three", True)):
        d = tmp_path / name
        d.mkdir()
        (job,) = traffic.jobs_of(cell["config"], groups, str(d),
                                 cell["traffic"], trace)
        keys.add(expected.key(job["output"], job["argv"]))
    assert keys == {KEY}
    assert os.path.exists(expected.path(KEY))


def _fasta(name):
    with open(os.path.join(DATA, name)) as f:
        head, body = f.read().split("\n", 1)
    return head, body


def test_the_ancestor_is_two_shifted_copies():
    head, body = _fasta("anc.fasta")
    head2, body2 = _fasta("anc2.fasta")
    seq = "".join(body.split())
    assert len(seq) == COPY
    assert head2 == head == ">anc"
    assert body2 == "".join((seq * 2)[i:i + 80] + "\n"
                            for i in range(0, 2 * COPY, 80))
    with open(os.path.join(DATA, "anc.bed")) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    with open(os.path.join(DATA, "anc2.bed")) as f:
        rows2 = [line.rstrip("\n").split("\t") for line in f]
    assert rows2 == [[r[0], str(int(r[1]) + c * COPY),
                      str(int(r[2]) + c * COPY), *r[3:]]
                     for c in range(2) for r in rows]


# ---------------------------------------------------------------------------
# the readers


def _run():
    """Two jobs of 1,000 kbp with -c's spans (ms): job 100, calibration 5,
    per round bond.chain 30 holding bond.anchor 20 and bond.identify 4,
    then bond.stitch 10 holding a stitch of 6, then the update of the
    mask, bond.chain 2; a subproblem 10 with a stitch 3; cyclize 8
    holding cyclize.fuse 3 and cyclize.simplify 2; polish 1."""
    ms = 10 ** 6
    spans = [["job", -1, 0, 100 * ms],
             ["calibration", 0, 0, 5 * ms],
             ["bond.chain", 0, 5 * ms, 35 * ms],
             ["bond.anchor", 2, 5 * ms, 25 * ms],
             ["bond.identify", 2, 25 * ms, 29 * ms],
             ["bond.stitch", 0, 35 * ms, 45 * ms],
             ["stitch", 5, 36 * ms, 42 * ms],
             ["bond.chain", 0, 45 * ms, 47 * ms],
             ["subproblem", 0, 50 * ms, 60 * ms],
             ["stitch", 8, 52 * ms, 55 * ms],
             ["cyclize", 0, 60 * ms, 68 * ms],
             ["cyclize.fuse", 10, 60 * ms, 63 * ms],
             ["cyclize.simplify", 10, 63 * ms, 65 * ms],
             ["polish", 0, 68 * ms, 69 * ms]]
    dp = {"spans": spans, "chain.masked": {"count": 2, "cells": 4000,
                                           "seconds": 0.002}}
    return {"jobs": [{"kbp": 1000, "dp": dp}, {"kbp": 1000, "dp": dp}]}


def _without(run, names=(), tags=()):
    """The run with the named spans renamed (the tree kept) and the
    counters dropped, as a program that records neither gives it."""
    for j in run["jobs"]:
        j["dp"] = dict(j["dp"], spans=[
            ["other" if s[0] in names else s[0], *s[1:]]
            for s in j["dp"]["spans"]])
        for t in tags:
            j["dp"].pop(t, None)
    return run


@pytest.mark.parametrize("metric, value", [
    # bond.anchor's self time: 20 ms a job
    ("bond_anchor_span_ms_per_kbp.cyc", 20 / 1000),
    # bond.chain 30 - 24 + 2, bond.identify 4, bond.stitch 10 - 6
    ("bond_host_span_ms_per_kbp.cyc", (8 + 4 + 4) / 1000),
    # the stitch under bond.stitch, whole; not the subproblem's
    ("bond_internal_stitch_ms_per_kbp.cyc", 6 / 1000),
    # cyclize whole (its self 3, cyclize.fuse 3, cyclize.simplify 2) and
    # polish
    ("cyclize_ms_per_kbp.cyc", (3 + 3 + 2 + 1) / 1000),
    # 4 ms over 8,000 anchors
    ("masked_chain_ns_per_anchor.cyc", 500.0),
])
def test_a_reader_gives_its_value(metric, value):
    assert spec.reader(metric)(_run()) == pytest.approx(value)


@pytest.mark.parametrize("metric, names, tags", [
    ("bond_anchor_span_ms_per_kbp.cyc", ("bond.anchor",), ()),
    # the parent of the change that added bond.identify: bond.chain held
    # every stem of bonding, and the reader leaves the metric out
    ("bond_host_span_ms_per_kbp.cyc", ("bond.anchor", "bond.identify"), ()),
    ("bond_internal_stitch_ms_per_kbp.cyc", ("bond.stitch",), ()),
    ("cyclize_ms_per_kbp.cyc", ("cyclize",), ()),
    ("masked_chain_ns_per_anchor.cyc", (), ("chain.masked",)),
])
def test_a_reader_gives_none_without_its_spans_or_counters(metric, names,
                                                           tags):
    read = spec.reader(metric)
    assert read(_without(_run(), names, tags)) is None
    assert read({"jobs": [{"kbp": 1, "dp": {}}]}) is None
    assert read({"jobs": []}) is None


def test_the_span_readers_and_the_rest_partition_the_jobs():
    """The four span metrics and the job's other stems (job, calibration,
    subproblem, its stitch) add up to the jobs' wall."""
    run = _run()
    got = sum(spec.reader(m)(run) for m in (
        "bond_anchor_span_ms_per_kbp.cyc", "bond_host_span_ms_per_kbp.cyc",
        "bond_internal_stitch_ms_per_kbp.cyc", "cyclize_ms_per_kbp.cyc"))
    # job's self 100 - 5 - 30 - 10 - 2 - 10 - 8 - 1 = 34, calibration 5,
    # subproblem 10 (its stitch inside)
    assert got * 1000 + 34 + 5 + 10 == pytest.approx(100)


def test_a_traced_cyc_run_reports_the_cells_metrics(tmp_path, cyc_expected):
    """The small -c cell of test_portbench_params_run.py, given this
    cell's per-layer metrics, reports each of them traced, on the CPU's
    plain device tier; the card's trace alone gives the two read from
    it."""
    root = cyc_root(str(tmp_path), cyc_expected)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny_cyc")
    with open(path, "w") as f:
        json.dump(bench, f)
    run, metrics, numbers = harness.run_cell("tiny_cyc", 2 ** 36 + 5, 3,
                                             True, device_mode="cpu",
                                             root=root)
    assert all(n["ok"] for n in numbers.values()), (numbers, run["wrong"])
    card = {"device_idle_pct.pair", "gotoh_roofline_pct.pair"}
    want = set(NEW_METRICS + SHARED_METRICS) - card
    assert want <= set(metrics), want - set(metrics)
    for name in want - {"chain_tree_pct.pair"}:
        assert metrics[name]["value"] > 0, name
    # every unmasked chaining went to the CDQ engines
    assert metrics["chain_tree_pct.pair"]["value"] == 0


# ---------------------------------------------------------------------------
# the committed output


def test_the_expected_gfa_is_cyclized():
    """Each path of the committed GFA steps at least 50,000 bp on segments
    it visits more than once: the run found a bond in each sequence and
    merged it into a cycle. Plain text parsing, nothing of the port."""
    with gzip.open(expected.path(KEY), "rt") as f:
        lines = [line.rstrip("\n").split("\t") for line in f]
    length = {r[1]: len(r[2]) for r in lines if r[0] == "S"}
    paths = {r[1]: [s[:-1] for s in r[2].split(",")]
             for r in lines if r[0] == "P"}
    assert sorted(paths) == ["h1", "h2"]
    for steps in paths.values():
        visits = collections.Counter(steps)
        assert sum(length[s] for s in steps if visits[s] > 1) >= 50000

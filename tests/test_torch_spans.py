"""The spans of the port's CLI jobs (centrolign_tpu_torch/metrics.py).

On the CPU, with the device tier on its plain versions: a small pair and
a three-sequence MSA (tests/test_torch_cli.py's inputs) run in this
process. Each job's spans form one tree: every span inside its parent,
siblings apart, self times summing to `job`, `job` covering the call's
wall on the epoch clock; no span per gap; `reset()` keeps the process
spans; the -v 3 log's stage split agrees with the spans; -c gives the
bonding spans. Marked `cuda`: on the card, under torch.profiler, every
Gotoh kernel lies between the start of the stitch that dispatched it and
the end of the device.wait that fetched it:

    python -m pytest -m cuda tests/test_torch_spans.py -q -s
"""

import contextlib
import io
import json
import threading
import time

import pytest
import torch

from centrolign_tpu_torch import cli, metrics
from centrolign_tpu_torch import logging as logmod
from portbench import stages
from test_torch_cli import _write_msa, _write_pair

CPU_TIER = {"CENTROLIGN_TORCH_DEVICE": "cpu",
            "CENTROLIGN_TORCH_DEVICE_MIN_CELLS": "10000"}
# a pair's tree, in the order the spans open
PAIR_TREE = [
    ("job", None), ("setup", "job"), ("calibration", "job"),
    ("calibration.match", "calibration"), ("calibration.chain", "calibration"),
    ("calibration.match", "calibration"), ("calibration.chain", "calibration"),
    ("subproblem", "job"), ("match", "subproblem"), ("reach", "subproblem"),
    ("chain", "subproblem"), ("partition", "subproblem"),
    ("stitch", "subproblem"), ("stitch.align", "stitch"),
    ("device.wait", "stitch"), ("fuse", "subproblem"), ("output", "job")]


def run_job(argv, env, monkeypatch):
    """cli.main(argv) in this process after metrics.reset(): (rc, its -v
    log, metrics.summary(), the call's (start, end) in epoch ns)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    level = logmod.level
    metrics.reset()
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            t0 = time.time_ns()
            rc = cli.main(argv)
            t1 = time.time_ns()
    finally:
        logmod.level = level
    return rc, err.getvalue(), metrics.summary(), (t0, t1)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """{name: run_job's result} of the pair (seeds 1 and 2) and the MSA,
    at -v 3."""
    d = tmp_path_factory.mktemp("spans")
    inputs = {"pair": _write_pair(d / "pair1.fasta", 1),
              "pair2": _write_pair(d / "pair2.fasta", 2),
              "msa": _write_msa(d / "msa.fasta", 909)}
    with pytest.MonkeyPatch.context() as mp:
        return {name: run_job(["-v", "3", "-u", path], CPU_TIER, mp)
                for name, path in inputs.items()}


def _names(spans):
    return [(s[0], spans[s[1]][0] if s[1] >= 0 else None) for s in spans]


def _self_ns(spans):
    out = [e - s for _, _, s, e in spans]
    for _, parent, s, e in spans:
        if parent >= 0:
            out[parent] -= e - s
    return out


def test_a_pair_gives_the_documented_tree(jobs):
    rc, _, summary, _ = jobs["pair"]
    assert rc == 0
    assert _names(summary["spans"]) == PAIR_TREE


@pytest.mark.parametrize("name", ["pair", "msa"])
def test_spans_nest_inside_their_parents(jobs, name):
    spans = jobs[name][2]["spans"]
    assert [s[1] for s in spans].count(-1) == 1
    for k, (_, parent, start, end) in enumerate(spans):
        assert start <= end
        if parent >= 0:
            assert parent < k
            assert spans[parent][2] <= start and end <= spans[parent][3]
    for parent in range(-1, len(spans)):
        kids = sorted((s, e) for _, p, s, e in spans if p == parent)
        assert all(a[1] <= b[0] for a, b in zip(kids, kids[1:]))


@pytest.mark.parametrize("name", ["pair", "msa"])
def test_self_times_sum_to_the_job(jobs, name):
    spans = jobs[name][2]["spans"]
    job = spans[0][3] - spans[0][2]
    assert all(t >= 0 for t in _self_ns(spans))
    assert sum(_self_ns(spans)) == pytest.approx(job, rel=0.01)


@pytest.mark.parametrize("name", ["pair", "msa"])
def test_job_covers_the_call_on_the_epoch_clock(jobs, name):
    _, _, summary, (t0, t1) = jobs[name]
    (job_name, _, start, end), = [s for s in summary["spans"] if s[1] < 0]
    assert job_name == "job"
    assert end - start >= 0.99 * (t1 - t0)
    # on the epoch clock: inside the call, within the anchor's rounding
    assert t0 - 10 ** 6 <= start and end <= t1 + 10 ** 6


def test_no_span_per_gap(jobs):
    """Two pairs of one tree shape with different gap counts (both with
    chain-tier gaps) give the same spans."""
    a, b = jobs["pair"][2], jobs["pair2"][2]
    gaps = [sum(v["count"] for k, v in s.items() if isinstance(v, dict))
            for s in (a, b)]
    assert gaps[0] != gaps[1]
    assert a["pod"]["count"] and b["pod"]["count"]
    assert _names(a["spans"]) == _names(b["spans"]) == PAIR_TREE


def test_the_chain_tier_seconds_are_its_device_waits(jobs):
    spans, pod = jobs["pair"][2]["spans"], jobs["pair"][2]["pod"]
    waits = sum(e - s for n, _, s, e in spans if n == "device.wait") / 1e9
    assert pod["seconds"] == pytest.approx(waits, abs=1e-4)
    assert not {"dp_seconds", "dp_cells_per_sec",
                "device_contribution_s"} & set(jobs["pair"][2])


def test_reset_clears_spans_and_keeps_process(jobs):
    assert {"load.native", "device.init"} <= {
        s[0] for s in jobs["pair"][2]["process"]}
    process = [list(s) for s in metrics.process]
    with metrics.span("x"):
        pass
    metrics.record("po", 1, 0.0)
    metrics.reset()
    assert metrics.spans == [] and not metrics.counters
    assert metrics.process == process
    assert metrics.summary()["process"] == process


def test_a_span_open_across_reset_is_dropped():
    metrics.reset()
    with metrics.span("before"):
        metrics.reset()
        with metrics.span("after"):
            pass
    assert _names(metrics.spans) == [("after", None)]


def test_other_threads_record_no_spans():
    metrics.reset()
    with metrics.span("main"):
        t = threading.Thread(target=lambda: metrics.span("x").__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert _names(metrics.spans) == [("main", None)]


@pytest.mark.parametrize("name", ["pair", "msa"])
def test_summary_round_trips_through_json(jobs, name):
    summary = jobs[name][2]
    assert json.loads(json.dumps(summary)) == summary


@pytest.mark.parametrize("name", ["pair", "msa"])
def test_stage_split_agrees_with_the_spans(jobs, name):
    """The log's stamps (0.1 s) split the job as the spans do, each stage
    within 0.1 s per stamp that bounds it."""
    _, log, summary, _ = jobs[name]
    split = stages.stage_split(log)
    spans = summary["spans"]

    def seconds(span_name, parent=None):
        return [(e - s) / 1e9 for n, p, s, e in spans if n == span_name
                and (parent is None or spans[p][0] == parent)]

    assert split["calibration"] == pytest.approx(
        seconds("calibration")[0], abs=0.2)
    subs = split["subproblems"]
    assert len(subs) == len(seconds("subproblem")) == (1 if name == "pair"
                                                       else 2)
    for k, sub in enumerate(subs):
        reach_chain = seconds("reach")[k] + seconds("chain")[k]
        for stage, value in (("match", seconds("match")[k]),
                             ("reach_chain", reach_chain),
                             ("partition", seconds("partition")[k]),
                             ("stitch", seconds("stitch", "subproblem")[k]),
                             ("fuse", seconds("fuse")[k])):
            assert sub[stage] == pytest.approx(value, abs=0.2), stage


def test_cyclize_gives_bonding_spans(tmp_path, monkeypatch):
    """-c with tests/test_torch_cyclize.py's config on its tandem input
    (the polish's realignment off, as there): bond.chain and bond.stitch
    a round, an internal stitch under bond.stitch, cyclize and polish."""
    from test_torch_cyclize import CPU_TIER as CYC_TIER
    from test_torch_cyclize import _config, _tandem_fasta
    fasta = _tandem_fasta(tmp_path / "in.fa", 1500, seed=5)
    cfg, _ = _config(tmp_path, "port", fasta, 1200)
    rc, log, summary, _ = run_job(["-C", cfg, "--force-gfa-output"],
                                  CYC_TIER, monkeypatch)
    assert rc == 0, log[-800:]
    spans = summary["spans"]
    names = _names(spans)
    split = stages.stage_split(log)
    rounds = len(split["bonding"])
    assert names.count(("bond.chain", "job")) >= rounds > 0
    found = sum(r["found"] for r in split["bonding"])
    assert names.count(("stitch", "bond.stitch")) == found > 0
    assert names.count(("bond.stitch", "job")) == sum(
        1 for r in split["bonding"] if r["found"])
    assert ("cyclize", "job") in names and ("polish", "job") in names
    assert names.count(("subproblem", "job")) == 1
    assert sum(_self_ns(spans)) == pytest.approx(
        spans[0][3] - spans[0][2], rel=0.01)


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_gotoh_kernels_lie_inside_their_stitch_and_wait(card, tmp_path,
                                                        monkeypatch):
    """A pair with chain-tier gaps on the card under torch.profiler, its
    device events placed on the epoch clock as portbench/worker.py places
    them: each Gotoh kernel starts after the start of the last stitch
    span begun before it and ends before the end of that stitch's last
    device.wait, within 1 ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fasta = _write_pair(tmp_path / "pair.fasta", 1)
    env = {"CENTROLIGN_TORCH_DEVICE": "cuda",
           "CENTROLIGN_TORCH_DEVICE_MIN_CELLS": "10000"}
    assert run_job(["-v", "0", "-u", fasta], env, monkeypatch)[0] == 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rc, _, summary, _ = run_job(["-v", "0", "-u", fasta], env,
                                    monkeypatch)
        torch.cuda.synchronize()
    assert rc == 0
    assert {"device.init", "device.context", "load.cuda"} <= {
        s[0] for s in summary["process"]}
    base = prof.profiler.kineto_results.trace_start_ns()
    kernels = sorted(
        (base + int(ev.time_range.start * 1000),
         base + int(ev.time_range.end * 1000), ev.name)
        for ev in prof.events()
        if ev.device_type == DeviceType.CUDA and "gotoh" in ev.name)
    spans = summary["spans"]
    stitches = [k for k, s in enumerate(spans) if s[0] == "stitch"]
    assert kernels and stitches
    slack = 10 ** 6
    lead, lag = [], []
    for start, end, name in kernels:
        k = max((k for k in stitches if spans[k][2] <= start + slack),
                default=None)
        assert k is not None, f"{name} starts before any stitch"
        waits = [s[3] for s in spans if s[0] == "device.wait" and s[1] == k]
        assert waits, f"{name}'s stitch has no device.wait"
        lead.append(start - spans[k][2])
        lag.append(max(waits) - end)
        assert end <= max(waits) + slack, name
    print(f"{len(kernels)} Gotoh kernels in {len(stitches)} stitch spans "
          f"({torch.cuda.get_device_name(card)}): kernel start less its "
          f"stitch's start {min(lead) / 1e6:.3f}-{max(lead) / 1e6:.3f} ms, "
          f"its stitch's last device.wait end less the kernel's end "
          f"{min(lag) / 1e6:.3f}-{max(lag) / 1e6:.3f} ms")

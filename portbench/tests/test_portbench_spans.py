"""The span metrics' helper (portbench/spans.py) and readers on synthetic
run records: self times, milliseconds a kbp, the first job's process
spans, and None for a program that records no spans."""

import json

import pytest

from conftest import ROOT
from portbench import spans, spec

MS = 10 ** 6
# one job's spans: job [0, 100] ms, calibration [10, 40] with its match
# [10, 15] and chain [15, 38], subproblem [40, 95] with reach [40, 50],
# chain [50, 80] and a stitch [80, 95] with its host aligners [81, 85]
# and a device.wait [90, 93]
JOB = [["job", -1, 0, 100 * MS], ["calibration", 0, 10 * MS, 40 * MS],
       ["calibration.match", 1, 10 * MS, 15 * MS],
       ["calibration.chain", 1, 15 * MS, 38 * MS],
       ["subproblem", 0, 40 * MS, 95 * MS], ["reach", 4, 40 * MS, 50 * MS],
       ["chain", 4, 50 * MS, 80 * MS], ["stitch", 4, 80 * MS, 95 * MS],
       ["stitch.align", 7, 81 * MS, 85 * MS],
       ["device.wait", 7, 90 * MS, 93 * MS]]
PROCESS = [["device.init", -1, 0, 2 * 10 ** 9],
           ["load.native", -1, 3 * 10 ** 9, 3 * 10 ** 9 + 500 * MS]]
STEMS = {"calib_match_span_ms_per_kbp": 5, "calib_chain_span_ms_per_kbp": 23,
         "match_span_ms_per_kbp": 0, "reach_span_ms_per_kbp": 10,
         "chain_span_ms_per_kbp": 30, "partition_span_ms_per_kbp": 0,
         "stitch_span_ms_per_kbp": 8, "host_align_span_ms_per_kbp": 4,
         "device_wait_ms_per_kbp": 3,
         # job 15, calibration 2, subproblem 0
         "core_span_ms_per_kbp": 17}


def _run(with_spans=True):
    dp = {"po": {"count": 3, "cells": 10, "seconds": 0.1}}
    if with_spans:
        dp.update(spans=JOB, process=PROCESS)
    return {"jobs": [{"kbp": 2.0, "dp": json.loads(json.dumps(dp))},
                     {"kbp": 3.0, "dp": json.loads(json.dumps(dp))}]}


def test_self_time_is_a_span_less_its_children():
    got = spans.self_ns(JOB)
    assert got == {"job": 15 * MS, "calibration": 2 * MS,
                   "calibration.match": 5 * MS, "calibration.chain": 23 * MS,
                   "subproblem": 0, "reach": 10 * MS, "chain": 30 * MS,
                   "stitch": 8 * MS, "stitch.align": 4 * MS,
                   "device.wait": 3 * MS}
    assert sum(got.values()) == 100 * MS


@pytest.mark.parametrize("stem,ms", sorted(STEMS.items()))
def test_each_reader_is_its_spans_self_time_a_kbp(stem, ms):
    for kind in ("pair", "msa"):
        read = spec.reader(f"{stem}.{kind}", ROOT)
        # two jobs of 2 and 3 kbp, each with the same spans
        assert read(_run()) == pytest.approx(2 * ms / 5.0)
        assert read(_run(with_spans=False)) is None


def test_the_stems_cover_the_jobs_wall():
    run = _run()
    total = sum(spec.reader(f"{stem}.pair", ROOT)(run) for stem in STEMS)
    assert total == pytest.approx(2 * 100 / 5.0)


def test_load_is_the_first_jobs_process_spans():
    read = spec.reader("load_s", ROOT)
    run = _run()
    run["jobs"][1]["dp"]["process"] = PROCESS + [["load.cuda", -1, 0, 10 ** 9]]
    assert read(run) == pytest.approx(2.5)
    assert read(_run(with_spans=False)) is None
    assert read({"jobs": []}) is None


def test_every_span_metric_is_in_the_benchmark():
    names = {m["name"] for m in spec.benchmark(ROOT)["per_layer"]}
    want = {f"{stem}.{kind}" for stem in STEMS for kind in ("pair", "msa")}
    assert want | {"load_s"} <= names

"""Whole runs on the CPU of a cell whose configuration states upstream
parameters (`params`): -c cyclizing with the polish off, which only a
parameter file sets, on pairs of a two-copy tandem array. The device tier
runs on its plain versions (CENTROLIGN_TORCH_DEVICE=cpu), as in
test_portbench_run.py."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from conftest import ROOT, tiny_root
from portbench import expect
from portbench import run as harness

UNIT = 3000
# -c with copies over min_cyclizing_length, one bonding round a sequence,
# and the polish after cyclizing off (mbpair_cyc.cfg's settings)
PARAMS = {"cyclize_tandem_duplications": True,
          "min_cyclizing_length": 2500,
          "max_tandem_duplication_search_rounds": 1,
          "max_realignment_cycle_size": 0,
          "inconsistent_indel_window": 0,
          "min_inconsistency_total_length": 1000000000}


def cyc_root(tmp, expected_from=None):
    """conftest.tiny_root with one more cell, `tiny_cyc`: the pair of a
    cohort of two, each 2 generations from an ancestor of two copies of a
    random 3 kbp unit (the monomer rows of the ancestor's first 3 kbp
    on each copy), aligned with PARAMS and --force-gfa-output: each
    sequence's copies make one bond."""
    root = tiny_root(tmp, expected_from)
    pb = os.path.join(root, "portbench")
    unit = "".join("ACGT"[k] for k in
                   np.random.default_rng(5).integers(0, 4, UNIT))
    tandem = unit * 2
    with open(os.path.join(pb, "data", "tandem.fasta"), "w") as f:
        f.write(">anc\n" + "".join(tandem[i:i + 80] + "\n"
                                   for i in range(0, len(tandem), 80)))
    with open(os.path.join(pb, "data", "anc.bed")) as f:
        rows = [line.split("\t") for line in f
                if int(line.split("\t")[2]) <= UNIT]
    with open(os.path.join(pb, "data", "tandem.bed"), "w") as f:
        f.writelines("\t".join([r[0], str(int(r[1]) + c * UNIT),
                                str(int(r[2]) + c * UNIT), *r[3:]])
                     for c in range(2) for r in rows)
    with open(os.path.join(pb, "configs", "tiny-pair.json")) as f:
        config = json.load(f)
    config.update(name="tiny-cyc", ancestor="data/tandem.fasta",
                  annotation="data/tandem.bed", tree="(a:2,b:2):0;",
                  output="gfa", cli_args=["--force-gfa-output"],
                  params=PARAMS,
                  # gaps of 120 cells and up to the chain tier: a few jobs
                  env={"CENTROLIGN_TORCH_DEVICE_MIN_CELLS": "120"})
    with open(os.path.join(pb, "configs", "tiny-cyc.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(pb, "traffic", "tiny_cyc_pairs.json"), "w") as f:
        json.dump({"cohorts": 1, "data_seed": 6}, f)
    cell = {"name": "tiny_cyc", "config": "tiny-cyc",
            "traffic": "tiny_cyc_pairs", "chips": 1, "why": "a test"}
    with open(os.path.join(pb, "workloads", "tiny_cyc.json"), "w") as f:
        json.dump(cell, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "pair_185k" in m.get("workloads", []):
            m["workloads"].append("tiny_cyc")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="module")
def cyc_expected(tmp_path_factory):
    """The cell's expected outputs, recorded by the port's CLI on its host
    path."""
    root = cyc_root(str(tmp_path_factory.mktemp("cyc")))
    base = os.path.join(root, "cyc_expected")
    paths = expect.record("tiny_cyc",
                          [sys.executable, "-m", "centrolign_tpu_torch.cli"],
                          root=root, base=base,
                          env={"CENTROLIGN_TORCH_DEVICE": "none"})
    assert len(paths) == 1
    return base


@pytest.fixture
def cyc(tmp_path, cyc_expected):
    return cyc_root(str(tmp_path), cyc_expected)


def test_an_untraced_run_is_correct(cyc):
    run, metrics, numbers = harness.run_cell("tiny_cyc", 2 ** 36 + 3, 3,
                                             False, device_mode="cpu",
                                             root=cyc)
    assert all(n["ok"] for n in numbers.values()), (numbers, run["wrong"])
    assert numbers["gotoh_checked"]["value"] > 0
    assert run["attempted"] >= 1 and run["failed"] == 0
    assert sorted(metrics) == ["pair_kbp_per_s", "peak_rss_mib", "setup_s"]
    assert all(j["dp"]["spans"] for j in run["jobs"])


def test_a_traced_run_is_correct_with_its_stamps_and_spans(cyc):
    run, metrics, numbers = harness.run_cell("tiny_cyc", 2 ** 36 + 4, 3,
                                             True, device_mode="cpu",
                                             root=cyc)
    assert all(n["ok"] for n in numbers.values()), (numbers, run["wrong"])
    job = run["jobs"][0]
    # the -v 3 log reached the stage split through the parameter file
    assert [r["found"] for r in job["split"]["bonding"]] == [1, 1]
    assert job["split"]["calibration"] > 0
    names = {s[0] for s in job["dp"]["spans"]}
    assert {"bond.chain", "bond.stitch", "cyclize", "polish"} <= names
    for name in ("calibration_ms_per_kbp.pair", "chain_span_ms_per_kbp.pair",
                 "chain_ms_per_kbp.pair"):
        assert metrics[name]["value"] > 0, name


def test_the_jax_cli_records_the_same_expected_output(tmp_path,
                                                      cyc_expected):
    """expect.py with the reference CLI the committed files come from,
    which takes -C as the port does."""
    # looked up, not imported: the whole runs in this process refuse a
    # loaded jax
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the JAX package's CLI needs jax")
    root = cyc_root(str(tmp_path))
    os.symlink(os.path.join(ROOT, "centrolign_tpu"),
               os.path.join(root, "centrolign_tpu"))
    base = os.path.join(root, "jax_expected")
    paths = expect.record("tiny_cyc",
                          [sys.executable, "-m", "centrolign_tpu.cli"],
                          root=root, base=base,
                          env={"JAX_PLATFORMS": "cpu",
                               "CENTROLIGN_TPU_USE_DEVICE": "0"})
    assert [os.path.basename(p) for p in paths] == os.listdir(cyc_expected)
    for p in paths:
        with open(p, "rb") as f, open(os.path.join(
                cyc_expected, os.path.basename(p)), "rb") as g:
            assert f.read() == g.read()

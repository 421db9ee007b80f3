"""Shared pieces of the benchmark's own tests (run them from the repo's
root: python -m pytest portbench/tests -q)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card; skips without one")


def tiny_root(tmp, expected_from=None):
    """A copy of BENCHMARK.json and portbench/ under `tmp`, the port linked
    beside them, with two small cells of their own: `tiny_pair` (3
    haplotypes of an 8 kbp slice of the ancestor, all pairs) and
    `tiny_msa` (a cohort of 3 down a tree), both with -u and the chain
    tier taking gaps of 2,000 cells and up, so the plain versions on the
    CPU stand in for the card; their expected outputs copied from the
    directory `expected_from`."""
    root = os.path.join(tmp, "root")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "centrolign_tpu_torch"),
               os.path.join(root, "centrolign_tpu_torch"))
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "data", "anc.fasta")) as f:
        seq = "".join(f.read().split("\n", 1)[1].split())[:8000]
    with open(os.path.join(pb, "data", "tiny.fasta"), "w") as f:
        f.write(">anc\n" + "\n".join(seq[i:i + 80]
                                     for i in range(0, len(seq), 80)) + "\n")
    with open(os.path.join(pb, "data", "anc.bed")) as f, \
            open(os.path.join(pb, "data", "tiny.bed"), "w") as out:
        out.writelines(line for line in f if int(line.split()[2]) <= 8000)
    with open(os.path.join(pb, "configs", "pair-hor.json")) as f:
        base = json.load(f)
    small = {"ancestor": "data/tiny.fasta", "annotation": "data/tiny.bed",
             "cli_args": ["-u"],
             "rates": {"subs_rate": 1e-2, "point_indel_rate": 2e-3,
                       "exp_point_indel": 4.0},
             "env": {"CENTROLIGN_TORCH_DEVICE_MIN_CELLS": "2000"}}
    configs = {
        "tiny-pair": dict(base, **small, name="tiny-pair",
                          tree="(a:10,b:10,c:10):0;"),
        "tiny-msa": dict(base, **small, name="tiny-msa", mode="msa",
                         output="gfa", tree="((a:5,b:5):5,c:10):0;"),
    }
    mixes = {"tiny_pairs": {"cohorts": 1, "data_seed": 3},
             "tiny_msas": {"cohorts": 1, "data_seed": 4}}
    for name, c in configs.items():
        with open(os.path.join(pb, "configs", f"{name}.json"), "w") as f:
            json.dump(c, f)
    for name, t in mixes.items():
        with open(os.path.join(pb, "traffic", f"{name}.json"), "w") as f:
            json.dump(t, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, c, t, like in (("tiny_pair", "tiny-pair", "tiny_pairs",
                              "pair_185k"),
                             ("tiny_msa", "tiny-msa", "tiny_msas",
                              "msa4_185k")):
        w = {"name": name, "config": c, "traffic": t, "chips": 1,
             "why": "a test"}
        with open(os.path.join(pb, "workloads", f"{name}.json"), "w") as f:
            json.dump(w, f)
        bench["workloads"].append(w)
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    if expected_from:
        for name in os.listdir(expected_from):
            shutil.copy(os.path.join(expected_from, name),
                        os.path.join(pb, "expected"))
    return root


@pytest.fixture(scope="session")
def tiny_expected(tmp_path_factory):
    """The tiny cells' expected outputs, recorded once by the port's CLI
    on its host path (which the repo's own tests hold byte for byte
    against the JAX package's CLI)."""
    from portbench import expect
    root = tiny_root(str(tmp_path_factory.mktemp("tiny")))
    base = os.path.join(root, "tiny_expected")
    for cell in ("tiny_pair", "tiny_msa"):
        expect.record(cell, [sys.executable, "-m", "centrolign_tpu_torch.cli"],
                      root=root, parallel=2, base=base,
                      env={"CENTROLIGN_TORCH_DEVICE": "none"})
    return base


@pytest.fixture
def tiny(tmp_path, tiny_expected):
    return tiny_root(str(tmp_path), tiny_expected)

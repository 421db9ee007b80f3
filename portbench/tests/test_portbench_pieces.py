"""The harness's pieces on the CPU: the stage split, the metric arithmetic,
the work count, discovery of files, the import check, the generator and
the command without a card."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT
from portbench import measures, simulate, spec, stages, traffic, work
from portbench.run import foreign

LOG = """\
[centrolign_tpu] elapsed: 0:00:00.1 Initializing leaf subproblems.
[centrolign_tpu] elapsed: 0:00:00.4 Calibrating scale of anchoring parameters.
[centrolign_tpu] elapsed: 0:00:02.0 Beginning MSA.
[centrolign_tpu] elapsed: 0:00:02.1 Next subproblem contains sequences:
\th1
\th2
[centrolign_tpu] elapsed: 0:00:02.2 Finding matches.
[centrolign_tpu] elapsed: 0:00:02.9 Computing reachability.
[centrolign_tpu] elapsed: 0:00:04.4 Chained 512 anchors.
[centrolign_tpu] elapsed: 0:00:04.6 Partitioned into 3 segments.
[centrolign_tpu] elapsed: 0:00:05.7 Fusing MSAs.
[centrolign_tpu] elapsed: 0:00:05.9 Maximum memory usage: 480.00 MB.
[centrolign_tpu] elapsed: 0:00:06.0 Run completed successfully, exiting.
"""


def test_stage_split_on_a_fixed_log():
    split = stages.stage_split(LOG)
    assert split["setup"] == pytest.approx(0.3 + 0.1)
    assert split["calibration"] == pytest.approx(1.6)
    (sub,) = split["subproblems"]
    assert sub["sequences"] == ["h1", "h2"]
    assert sub["match"] == pytest.approx(0.8)
    assert sub["reach_chain"] == pytest.approx(1.5)
    assert sub["partition"] == pytest.approx(0.2)
    assert sub["stitch"] == pytest.approx(1.1)
    assert sub["fuse"] == pytest.approx(0.2)
    assert split["end"] == pytest.approx(0.1)
    assert [s for _, s in stages.stamps(LOG)] == [
        "setup", "calibration", "setup", "match", "match", "reach_chain",
        "partition", "stitch", "fuse", "end", "end"]


def test_stage_split_is_chip_smokes():
    chip_smoke = pytest.importorskip("chip_smoke")
    assert stages.stage_split(LOG) == chip_smoke.stage_split(LOG)
    assert stages.STAGE_MARKS == chip_smoke.STAGE_MARKS


def test_stage_split_refuses_a_lost_message():
    with pytest.raises(ValueError):
        stages.stage_split(LOG.replace("Chained 512", "Linked 512"))


def test_rate_is_the_windows_work_over_its_time():
    run = {"jobs": [{"kbp": 370.0, "end": 4.0}, {"kbp": 380.0, "end": 9.0}],
           "rss_first_job_bytes": 2 ** 30}
    assert measures.kbp_per_s(run) == pytest.approx(750 / 9)
    assert measures.peak_rss_mib(run) == pytest.approx(1024)
    assert measures.kbp_per_s({"jobs": []}) is None


def test_job_rss_is_the_median_growth_inside_each_job():
    from portbench import checks
    mib = 2 ** 20
    jobs = [{"start": 0.0, "end": 1.0}, {"start": 1.5, "end": 2.0},
            {"start": 3.0, "end": 4.0}, {"start": 5.0, "end": 5.001}]
    samples = [(-0.1, 100 * mib), (0.5, 400 * mib), (0.9, 150 * mib),
               (1.2, 120 * mib), (1.6, 140 * mib), (1.9, 135 * mib),
               (3.1, 200 * mib), (3.5, 260 * mib)]
    growth = checks.job_rss_growth(jobs, samples)
    # the last job has no sample inside it; the third none before it but
    # the one of the second job's
    assert growth == [300 * mib, 20 * mib, 125 * mib]
    assert measures.job_rss_mib({"job_rss_bytes": growth}) == 125
    assert measures.job_rss_mib({"job_rss_bytes": []}) is None


def test_stage_metric_is_milliseconds_a_kbp():
    split = stages.stage_split(LOG)
    run = {"jobs": [{"kbp": 380.0, "split": split},
                    {"kbp": 370.0, "split": split}]}
    assert measures.stage_ms_per_kbp(run, ("reach_chain",)) == \
        pytest.approx(1e3 * 3.0 / 750)
    assert measures.stage_ms_per_kbp(run, measures.CORE_OTHER) == \
        pytest.approx(1e3 * 2 * (0.4 + 0.2 + 0.1) / 750)
    assert measures.stage_ms_per_kbp({"jobs": [{}]}, ("match",)) is None


def test_device_cell_share():
    run = {"jobs": [{"dp": {"device_cells": 30, "dp_cells": 120}},
                    {"dp": {"device_cells": 10, "dp_cells": 80}}]}
    assert measures.device_cell_pct(run) == pytest.approx(20.0)


def test_gotoh_work_on_known_shapes():
    assert work.gotoh_ops(1, 1, 1) == 1 * (2 + 8) + 2 * 3
    assert work.gotoh_ops(3, 2, 3) == 6 * 26 + 5 * 11
    assert work.gotoh_ops(0, 5, 2) == 5 * 7
    assert work.gotoh_bytes(3, 2, 3, 4) == 5 + 4 * 8 + 32 + 4
    jobs = [(4356, 3330, 3, 5000), (600, 560, 2, 800)]
    ops = work.gotoh_ops(4356, 3330, 3) + work.gotoh_ops(600, 560, 2)
    assert work.least_seconds(jobs) == pytest.approx(
        ops / work.INT32_OPS_PER_S)
    assert work.INT32_OPS_PER_S == pytest.approx(16.7270e12, rel=1e-4)


def test_roofline_and_idle_readers():
    run = {"gotoh_shapes": [(4356, 3330, 3, 5000)], "gotoh_s": 0.004,
           "busy_s": 0.5, "window_s": 50.0}
    want = 100 * work.least_seconds(run["gotoh_shapes"]) / 0.004
    assert measures.gotoh_roofline_pct(run) == pytest.approx(want)
    assert measures.device_idle_pct(run) == pytest.approx(99.0)
    assert measures.gotoh_roofline_pct({"gotoh_shapes": [],
                                        "gotoh_s": 1.0}) is None


def test_import_check_compares_whole_top_level_names():
    assert foreign(["centrolign_tpu_torch", "centrolign_tpu_torch.cli",
                    "numpy", "torch", "jaxtyping"]) == []
    assert foreign(["centrolign_tpu"]) == ["centrolign_tpu"]
    assert foreign(["centrolign_tpu.ops.gotoh"]) == \
        ["centrolign_tpu.ops.gotoh"]
    assert foreign(["jax.numpy", "numpy"]) == ["jax.numpy"]
    assert foreign(["jaxlib", "flax.linen"]) == ["flax.linen", "jaxlib"]


def test_a_cell_config_mix_and_metric_added_as_files(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "pair-hor.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "pair-far"
    cfg["tree"] = "(a:240,b:240):0;"
    with open(os.path.join(pb, "configs", "pair-far.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "one_cohort.json"), "w") as f:
        json.dump({"cohorts": 1, "data_seed": 1}, f)
    cell = {"name": "pair_far", "config": "pair-far", "traffic": "one_cohort",
            "chips": 1, "why": "a test"}
    with open(os.path.join(pb, "workloads", "pair_far.json"), "w") as f:
        json.dump(cell, f)
    with open(os.path.join(pb, "metrics", "jobs_done.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run['jobs']))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append(cell)
    bench["per_layer"].append({"name": "jobs_done", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "CLI and core (cli.py, core.py)",
                               "moves": "pair_kbp_per_s",
                               "workloads": ["pair_far"]})
    bench["per_layer"].append({"name": "jobs_done.other", "unit": "jobs",
                               "better": "higher", "source": "host_clock",
                               "layer": "CLI and core (cli.py, core.py)",
                               "moves": "pair_kbp_per_s",
                               "workloads": ["pair_far"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    got = spec.cell("pair_far", root)
    assert got["config"]["tree"] == "(a:240,b:240):0;"
    assert got["traffic"]["data_seed"] == 1
    names = [m["name"] for m in got["per_layer"]]
    assert names == ["jobs_done", "jobs_done.other"]
    assert [m["name"] for m in got["end_to_end"]] == [
        "peak_rss_mib", "setup_s"]
    run = {"jobs": [1, 2]}
    assert spec.reader("jobs_done", root)(run) == 2.0
    assert spec.reader("jobs_done.other", root)(run) == 2.0
    assert spec.reader("pair_kbp_per_s", root) is not None
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric", root)
    cell["traffic"] = "cohort_pairs"
    with open(os.path.join(pb, "workloads", "pair_far.json"), "w") as f:
        json.dump(cell, f)
    with pytest.raises(ValueError):
        spec.cell("pair_far", root)


def test_every_cell_and_metric_of_the_benchmark_has_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        for m in cell["end_to_end"] + cell["per_layer"]:
            assert callable(spec.reader(m["name"]))
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])


def test_frozen_simulator_is_the_ports_tool(tmp_path):
    tool = pytest.importorskip("centrolign_tpu_torch.tools.sim_centromere")
    nwk = tmp_path / "t.nwk"
    nwk.write_text("(h1:4,(h2:3,h3:3):1):0;")
    out = str(tmp_path / "o")
    data = os.path.join(ROOT, "portbench", "data")
    tool.main([os.path.join(data, "anc.fasta"), os.path.join(data, "anc.bed"),
               "-o", out, "-T", str(nwk), "-z", "7", "--skip-pairwise"])
    root = simulate.initialize_sequence(os.path.join(data, "anc.fasta"),
                                        os.path.join(data, "anc.bed"))
    got = simulate.evolve_tree(root, nwk.read_text(), {}, 7)
    assert sorted(got) == ["h1", "h2", "h3"]
    for name, seq in got.items():
        with open(f"{out}_{name}.fasta") as f:
            assert simulate.parse_fasta(f)[0][1] == seq


def test_jobs_and_their_order(tmp_path):
    cell = spec.cell("pair_185k")
    cohort = [{f"h{k}": "ACGT" * (k + 1) for k in range(1, 13)}]
    every = dict(cell["traffic"], jobs_per_run=None)
    jobs = traffic.jobs_of(cell["config"], cohort, str(tmp_path), every)
    assert len(jobs) == 66
    assert jobs[0]["argv"][-1] == jobs[0]["fasta"]
    assert jobs[0]["kbp"] == pytest.approx((8 + 12) / 1000)
    some = traffic.jobs_of(cell["config"], cohort, str(tmp_path),
                           cell["traffic"])
    assert len(some) == cell["traffic"]["jobs_per_run"]
    other = dict(cell["traffic"], data_seed=cell["traffic"]["data_seed"] + 1)
    assert [j["names"] for j in some] != [
        j["names"] for j in traffic.jobs_of(cell["config"], cohort,
                                            str(tmp_path), other)]
    order = traffic.order(jobs, 2 ** 40 + 3)
    assert sorted(order) == list(range(66))
    assert order == traffic.order(jobs, 2 ** 40 + 3)
    assert order != traffic.order(jobs, 2 ** 40 + 4)


def test_every_job_of_the_cells_has_its_expected_output(tmp_path):
    """The committed expected outputs cover every job the benchmark's
    cells can send, and nothing else."""
    from portbench.reference import expected
    keys = set()
    for w in spec.benchmark()["workloads"]:
        cell = spec.cell(w["name"])
        anc = traffic.ancestor(cell["config"])
        groups = traffic.cohorts(cell["config"], cell["traffic"], anc)
        d = tmp_path / w["name"]
        d.mkdir()
        for job in traffic.jobs_of(cell["config"], groups, str(d),
                                   cell["traffic"]):
            keys.add(expected.key(job["output"], job["argv"]))
    assert all(expected.load(k) for k in keys)
    assert sorted(f"{k}.gz" for k in keys) == sorted(
        os.listdir(expected.EXPECTED))


def test_seeds_of_any_size_give_fixed_inputs():
    a = traffic.rng(2 ** 40 + 17, 1).integers(0, 1000, 5)
    b = traffic.rng(2 ** 40 + 17, 1).integers(0, 1000, 5)
    c = traffic.rng(-(2 ** 40 + 17), 1).integers(0, 1000, 5)
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_the_command_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "pair_185k", "--seed", "1", "--seconds", "10",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no card" in r.stderr


def _imports(path):
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_harness_module_imports_jax_and_the_reference_no_port():
    base = os.path.join(ROOT, "portbench")
    files = [os.path.join(d, n) for d, _, ns in os.walk(base) for n in ns
             if n.endswith(".py") and "tests" not in d]
    assert len(files) > 20
    for path in files:
        assert foreign(_imports(path)) == [], path
    for name in os.listdir(os.path.join(base, "reference")):
        if name.endswith(".py"):
            top = {m.split(".")[0] for m in _imports(
                os.path.join(base, "reference", name))}
            assert top <= {"__future__", "argparse", "gzip", "hashlib",
                           "json", "os", "pickle", "re", "sys",
                           "numpy"}, (name, top)

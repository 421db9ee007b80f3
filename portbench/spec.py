"""Find a cell's files by the names in BENCHMARK.json.

A cell `<name>` of BENCHMARK.json's "workloads" names a configuration and
a traffic mix; the harness reads

- portbench/configs/<config>.json: the deployment (mode, CLI arguments,
  environment, the simulated cohort, the output's kind), and optionally
  "params": upstream parameters by their `centrolign -G` names, for those
  that only a parameter file sets. Each job of such a configuration runs
  as "-C <file>" plus its CLI arguments, the file written beside the
  job's FASTA with the parameters, the FASTA (and tree) and, in a traced
  run, logging level 3 (reference/paramfile.py); `cell` refuses CLI
  arguments that -C would override. The job's expected output is keyed by
  the parameters, the input files by content and the logging level left
  out (reference/expected.py);
- portbench/traffic/<traffic>.json: the jobs a run sends (cohorts, their
  data seed, how many of their jobs);
- portbench/expected/<key>.gz: the expected output of each job
  (reference/expected.py);
- portbench/workloads/<name>.json: the cell as BENCHMARK.json states it,
  which has to agree with it;
- portbench/metrics/<metric>.py for each metric the cell reports, or,
  when there is none, portbench/metrics/<metric up to its first dot>.py:
  a module with `read(run) -> float | None`.

A later PR adds a cell, a mix, a configuration or a metric by adding such
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

from .reference import paramfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, root: str = ROOT) -> dict:
    """The cell `name` with its configuration, traffic and metrics:
    {"name", "chips", "config": {...}, "traffic": {...}, "end_to_end":
    [metric entries], "per_layer": [metric entries]}; the metric entries
    are BENCHMARK.json's, those that apply to this cell."""
    bench = benchmark(root)
    here = os.path.join(root, "portbench")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    own = _load(os.path.join(here, "workloads", f"{name}.json"))
    for key in ("config", "traffic", "chips"):
        if own.get(key) != entry[key]:
            raise ValueError(f"workloads/{name}.json gives {key} "
                             f"{own.get(key)!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    config = _load(os.path.join(here, "configs", f"{entry['config']}.json"))
    if "params" in config:
        paramfile.check(config)
    traffic = _load(os.path.join(here, "traffic", f"{entry['traffic']}.json"))

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {"name": name, "chips": entry["chips"], "config": config,
            "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def reader(metric: str, root: str = ROOT):
    """The `read` function of the metric's reader module."""
    base = os.path.join(root, "portbench", "metrics")
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(base, f"{stem}.py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                f"portbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {metric!r} under "
                            f"portbench/metrics/")

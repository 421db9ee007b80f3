"""The arithmetic of the metrics, over the run record of checks.run_record.
The readers under portbench/metrics/ call it; a reader returns None where
the run has nothing to read, and the harness then leaves its metric out.
"""

from __future__ import annotations

import statistics

from . import work

# the stage split's stages (portbench/stages.py) by layer
CORE_OTHER = ("setup", "fuse", "end")


def kbp_per_s(run: dict):
    """The input kbp of the window's jobs over the time from the window's
    start to the end of the last job."""
    jobs = run["jobs"]
    if not jobs:
        return None
    return sum(j["kbp"] for j in jobs) / jobs[-1]["end"]


def peak_rss_mib(run: dict):
    """The client's peak RSS, read at the end of its first window job."""
    rss = run["rss_first_job_bytes"]
    return None if rss is None else rss / 2 ** 20


def job_rss_mib(run: dict):
    """The median over the window's jobs of each job's RSS growth: the
    largest resident set sampled while it ran less the one before it
    started (checks.job_rss_growth)."""
    growth = run["job_rss_bytes"]
    return statistics.median(growth) / 2 ** 20 if growth else None


def _stage_seconds(split: dict, stage: str) -> float:
    if stage in ("setup", "calibration", "cyclize", "polish", "end"):
        return split[stage]
    return sum(sub[stage] for sub in split["subproblems"])


def stage_ms_per_kbp(run: dict, names) -> float | None:
    """Milliseconds of the named stages, summed over the window's jobs,
    over the jobs' input kbp."""
    jobs = [j for j in run["jobs"] if "split" in j]
    if not jobs:
        return None
    sec = sum(_stage_seconds(j["split"], s) for j in jobs for s in names)
    return 1e3 * sec / sum(j["kbp"] for j in jobs)


def device_cell_pct(run: dict):
    """The share of the stitch's DP cells (host po, chain tier, DAG tier,
    sharded tier) that went to the card, over the window's jobs."""
    dev = dp = 0
    for j in run["jobs"]:
        dev += j["dp"].get("device_cells", 0)
        dp += j["dp"].get("dp_cells", 0)
    return 100.0 * dev / dp if dp else None


def gotoh_roofline_pct(run: dict):
    """The least time the window's chain-tier jobs need (portbench/work.py)
    over the Gotoh kernels' device time."""
    shapes = run.get("gotoh_shapes")
    if not shapes or not run.get("gotoh_s"):
        return None
    return 100.0 * work.least_seconds(shapes) / run["gotoh_s"]


def device_idle_pct(run: dict):
    """The share of the traced window in which no operation ran on the
    card."""
    if "busy_s" not in run or not run["window_s"]:
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["window_s"])

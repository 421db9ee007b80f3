"""What decides `correct`, and the run's record that the metric readers read.

`judge` runs the plain reference (portbench/reference/check.py) over the
client's capture, in processes of its own, as many at once as the host
has cores, once the client has exited; it returns each compared number
with its limit. The limits, and the readings they were set from, are in
PERF.md:

- jobs_failed: window jobs whose cli.main raised or returned non-zero;
- outputs_differ: window jobs whose output is not byte for byte the
  expected output recorded for the job (reference/expected.py);
- outputs_wrong: window jobs whose CIGAR or GFA is not an alignment of
  their input (reference/outputs.py);
- gotoh_checked: chain-tier device jobs checked, every one of the
  window's; at least one, or the run did not reach the layer its cell
  names;
- gotoh_differ: device jobs whose alignment or score differs from the
  int32 reference's (its tie rules are the kernels');
- gotoh_shortfall_max: the largest amount by which a device alignment
  scores below the reference's optimum;
- gotoh_inputs_foreign (pairwise cells): device jobs whose sides are not
  stretches of their pair's own sequences.

Each limit is an exact comparison.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

from . import stages

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

FOREIGN = ("jax", "jaxlib", "flax", "centrolign_tpu")

LIMITS = {
    "jobs_failed": ("<=", 0),
    "outputs_differ": ("<=", 0),
    "outputs_wrong": ("<=", 0),
    "gotoh_checked": (">=", 1),
    "gotoh_differ": ("<=", 0),
    "gotoh_shortfall_max": ("<=", 0),
    "gotoh_inputs_foreign": ("<=", 0),
}


class RunFailed(RuntimeError):
    pass


def foreign(modules) -> list:
    """The names among `modules` whose top-level name (before the first
    dot) is one of FOREIGN, compared whole."""
    return sorted({m for m in list(modules) if m.split(".")[0] in FOREIGN})


def refuse_foreign(found: dict) -> None:
    """Raise RunFailed where any process ({process: [module names]})
    loaded JAX or the JAX package."""
    bad = {k: v for k, v in found.items() if v}
    if bad:
        raise RunFailed(f"modules of JAX or the JAX package loaded: {bad}")


def within(value, limit) -> bool:
    op, bound = limit
    return value <= bound if op == "<=" else value >= bound


def reference_runs(capture: str, expected_dir: str,
                   control: bool = False) -> list:
    """The reference's verdict on the capture, its outputs against the
    expected ones under `expected_dir`, in parts, one process a part, as
    many at once as the host has cores (the client has exited). Raises
    RunFailed where a part failed or loaded JAX."""
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, *filter(None, [os.environ.get("PYTHONPATH")])])
    parts = len(os.sched_getaffinity(0))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "portbench.reference.check", capture,
         "--expected", expected_dir, "--part", str(k), "--parts",
         str(parts)]
        + (["--control"] if control else []),
        cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
        for k in range(parts)]
    texts = [p.communicate()[0] for p in procs]
    failed = [p.returncode for p in procs if p.returncode != 0]
    if failed:
        raise RunFailed(f"the reference failed (rc {failed})")
    verdicts = [json.loads(t.strip().splitlines()[-1]) for t in texts]
    refuse_foreign({f"reference part {k}": foreign(v["modules"])
                    for k, v in enumerate(verdicts)})
    return verdicts


def numbers_of(verdicts: list, failed_jobs: int) -> dict:
    """{name: {"value", "limit", "ok"}} from the parts' verdicts and the
    count of jobs that raised or returned non-zero."""
    values = {"jobs_failed": failed_jobs}
    for name in ("outputs_differ", "outputs_wrong", "gotoh_checked",
                 "gotoh_differ"):
        values[name] = sum(v[name] for v in verdicts)
    values["gotoh_shortfall_max"] = max(v["gotoh_shortfall_max"]
                                        for v in verdicts)
    if any(v["pairs"] for v in verdicts):
        values["gotoh_inputs_foreign"] = sum(
            v["gotoh_inputs_foreign"] for v in verdicts)
    out = {}
    for name, value in values.items():
        op, bound = LIMITS[name]
        out[name] = {"value": value, "limit": f"{op} {bound}",
                     "ok": within(value, LIMITS[name])}
    return out


def judge(data: dict, expected_dir: str, control: bool = False):
    """(numbers, [{"n", "id", "why"} of the first wrong outputs], the
    number of window jobs that failed or whose output is wrong); with
    `control`, the int16 reference's device alignments judged in the
    program's place."""
    verdicts = reference_runs(data["client"]["capture"], expected_dir,
                              control)
    raised = {n for n, j in enumerate(data["client"]["jobs"])
              if j["rc"] != 0}
    bad = raised.union(*(v["bad_jobs"] for v in verdicts))
    return (numbers_of(verdicts, len(raised)),
            [w for v in verdicts for w in v["wrong"]], len(bad))


# --------------------------------------------------------------------------
# the record of a run that the readers of portbench/metrics/ take


def notes(run: dict) -> list:
    """Lines on where a run's time and memory went, for its standard
    error: the set-up's parts, the window's wall, the check's, the jobs
    with their wall and CPU seconds, and the client's peak RSS after import, warm-up, its first job and the
    window."""
    mib = 2 ** 20
    st = run["setup"]
    jobs = run["jobs"]
    return [
        f"setup {run['setup_s']:.3f} s (inputs simulated in "
        f"{run['inputs_s']:.3f} s meanwhile), window "
        f"{run['window_wall_s']:.3f} s, check {run['check_s']:.3f} s",
        f"client: {len(jobs)} jobs, last ends at "
        f"{jobs[-1]['end'] if jobs else 0:.3f} s; import "
        f"{st['import_s']:.3f} s, warm-up {st['warm_s']:.3f} s; peak RSS "
        f"{st['rss_imported_bytes'] / mib:.0f} MiB imported, "
        f"{st['rss_warm_bytes'] / mib:.0f} warm, "
        f"{(run['rss_first_job_bytes'] or 0) / mib:.0f} first job, "
        f"{run['rss_end_bytes'] / mib:.0f} end; a job's RSS growth "
        + ", ".join(f"{g / mib:.0f}" for g in run["job_rss_bytes"])
        + " MiB",
        "  jobs (id: wall s / CPU s): " + ", ".join(
            f"{j['id']}: {j['end'] - j['start']:.3f} / {j['cpu_s']:.3f}"
            for j in jobs)]


def job_rss_growth(jobs: list, samples: list) -> list:
    """For each job with a sample inside it, the largest resident set
    sampled while it ran less the last one sampled before it started
    (the first one inside, where none was)."""
    out = []
    for j in jobs:
        inside = [b for t, b in samples if j["start"] <= t <= j["end"]]
        if not inside:
            continue
        before = [b for t, b in samples if t < j["start"]]
        out.append(max(inside) - (before[-1] if before else inside[0]))
    return out


def _gaps(busy: list, lo: float, hi: float) -> list:
    """The idle intervals of [lo, hi] between the busy ones."""
    out, t = [], lo
    for s, e in sorted(busy):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def _stage_at(jobs: list, t: float) -> str:
    """The stage the client was in at epoch time t."""
    for job in jobs:
        if job["epoch_start"] <= t <= job["epoch_end"]:
            stage = "cli"
            for at, name in job["stamps"]:
                if job["log_epoch0"] + at > t:
                    break
                stage = name
            return stage
    return "between jobs"


def run_record(data: dict, seconds: float, trace: bool,
               failed: int) -> dict:
    """The run as the metric readers see it:

    - "setup_s"; "seconds" (the window's length as asked); "attempted",
      "failed" (jobs that failed or whose output is wrong);
    - "jobs": the window's jobs, each with "kbp", "start" and "end" in
      seconds from the window's start, "cpu_s", "dp" the program's stitch
      counters, with --trace 1 "split", its stage split;
    - "rss_first_job_bytes" (the client's peak RSS at the end of its first
      job), "job_rss_bytes" (each job's RSS growth, `job_rss_growth`);
    - with --trace 1: "busy_s" (the card's busy seconds in the window, the
      union of its kernels and copies), "window_s", "gotoh_s" (the Gotoh
      kernels' device seconds), "gotoh_shapes" (V1, V2, pieces, alignment
      length of every chain-tier job of the window), and "breakdown".
    """
    client = data["client"]
    jobs = client["jobs"]
    run = {"setup_s": data["setup_s"], "seconds": seconds, "trace": trace,
           "inputs_s": data["inputs_s"], "window_wall_s": data["window_wall_s"],
           "check_s": data.get("check_s"), "jobs": jobs,
           "setup": client["setup"],
           "rss_first_job_bytes": client["rss_first_job_bytes"],
           "rss_end_bytes": client["rss_end_bytes"],
           "job_rss_bytes": job_rss_growth(jobs, data["rss_samples"]),
           "attempted": len(jobs), "failed": failed,
           "memory_peak_bytes": client["device_reserved_peak_bytes"]}
    if not trace:
        return run
    for job in jobs:
        job["split"] = stages.stage_split(job["log"])
        job["stamps"] = stages.stamps(job["log"])
    lo, hi = client["epoch0"], client["epoch_end"]
    traced = client["trace"]
    busy = traced["busy"]
    run["busy_s"] = sum(e - s for s, e in busy)
    run["window_s"] = hi - lo
    run["gotoh_s"] = traced["gotoh_s"]
    run["gotoh_shapes"] = [tuple(x) for x in client["gotoh_shapes"]]
    gaps = sorted(_gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:10]
    run["breakdown"] = {
        "device_ops": sorted(([k, v] for k, v in traced["ops"].items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[_stage_at(jobs, (s + e) / 2), e - s]
                      for s, e in gaps]}
    return run

"""The arithmetic of the span metrics, over the run record of
checks.run_record: each window job's "dp" is the program's
metrics.summary(), whose "spans" are the job's spans and whose "process"
the client's once-per-process spans, each [name, parent index or -1,
start ns, end ns] (centrolign_tpu_torch/metrics.py names them). A program
that records no spans gives None, and the harness then leaves the metric
out.
"""

from __future__ import annotations


def self_ns(spans: list) -> dict:
    """{name: nanoseconds} of each name's self time: its spans' lengths
    less the part their child spans cover."""
    children = [0] * len(spans)
    for _, parent, start, end in spans:
        if parent >= 0:
            children[parent] += end - start
    out = {}
    for k, (name, _, start, end) in enumerate(spans):
        out[name] = out.get(name, 0) + end - start - children[k]
    return out


def self_ms_per_kbp(run: dict, names) -> float | None:
    """Milliseconds of the named spans' self time, summed over the
    window's jobs, over the jobs' input kbp; None where no job carries
    spans."""
    jobs = [j for j in run["jobs"] if j["dp"].get("spans")]
    if not jobs:
        return None
    ns = sum(self_ns(j["dp"]["spans"]).get(name, 0)
             for j in jobs for name in names)
    return ns / 1e6 / sum(j["kbp"] for j in jobs)


def load_s(run: dict) -> float | None:
    """Seconds of the client's once-per-process spans (its libraries'
    loads, the device's and its context's creation) as its first window
    job reports them; None where it reports none."""
    jobs = run["jobs"]
    if not jobs or "process" not in jobs[0]["dp"]:
        return None
    process = jobs[0]["dp"]["process"]
    return sum(end - start for _, _, start, end in process) / 1e9

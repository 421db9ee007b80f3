"""The client of a run: a single-threaded process on the card that aligns
the jobs the parent hands it, each by `centrolign_tpu_torch.cli.main(argv)` in
this process, the users' own entry.

    python -m portbench.worker        (started by portbench/run.py)

It talks to the parent by JSON lines on its standard input and on the
standard output it had when it started (its file descriptor 1 is then
pointed at standard error, so nothing the program prints can reach the
parent as a message):

    parent -> {"op": "init", ...}     worker -> {"op": "imported"}
    parent -> {"op": "warm"}          worker -> {"op": "ready", ...}
    parent -> {"op": "go", "t0"}      worker -> {"op": "next"} ...
    parent -> {"op": "job", ...}      worker -> {"op": "done", ...}

Between "go" and "done" the worker starts a job while fewer than
`seconds` have passed since t0 (a time.perf_counter() instant, the
system's monotonic clock, the same in every process), closed loop. Per
job it resets the program's counters (metrics, launch counters), records
the chain tier's device jobs at the stitcher's two entries (the jobs
handed to `gotoh_dispatch`, the alignments and scores `gotoh_fetch`
returns) and keeps the output, and notes the job's CPU seconds, which
say whether the process waited or ran slower. The recorded jobs and outputs go to a file in the run's
directory for the reference to judge once the worker has exited. With --trace 1 the jobs run at -v 3 (the stage split reads their
logs; a job with a parameter file has logging level 3 written there), and a torch.profiler trace of the card's activity, kept from
before the window to its end, gives the busy intervals and the kernels'
times.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import resource
import sys
import time
import traceback


def _send(out, msg: dict) -> None:
    out.write(json.dumps(msg) + "\n")
    out.flush()


def _recv() -> dict:
    line = sys.stdin.readline()
    if not line:
        raise EOFError("the parent closed the pipe")
    return json.loads(line)


def top_modules() -> list:
    """The top-level names of the loaded modules (the part before the
    first dot)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)})


class Recorder:
    """The stitcher's chain-tier entries wrapped: `jobs` collects, per
    fetched job, (CLI job id, seq1, seq2, swap_pref, match, mismatch,
    gap_open, gap_extend, alignment, score); `job_id` says which CLI job
    is running."""

    def __init__(self):
        from centrolign_tpu_torch import stitcher
        self.dispatch, self.fetch = stitcher.gotoh_dispatch, stitcher.gotoh_fetch
        self.pending = {}
        self.jobs = []
        self.job_id = None
        stitcher.gotoh_dispatch = self._dispatch
        stitcher.gotoh_fetch = self._fetch

    def _dispatch(self, jobs, device):
        handle = self.dispatch(jobs, device)
        self.pending[id(handle)] = [
            (s1, s2, bool(swp), int(p.match), int(p.mismatch),
             tuple(int(x) for x in p.gap_open),
             tuple(int(x) for x in p.gap_extend))
            for s1, s2, swp, p in jobs]
        return handle

    def _fetch(self, handle):
        results = self.fetch(handle)
        for job, (aln, score) in zip(self.pending.pop(id(handle)), results):
            self.jobs.append((self.job_id, *job, aln.copy(), int(score)))
        return results


def run_cli(cli, argv):
    """(rc, stdout text, stderr text, error) of cli.main(argv)."""
    out, err = io.StringIO(), io.StringIO()
    error = None
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(argv)
        except Exception:
            rc, error = -1, traceback.format_exc()
    return rc, out.getvalue(), err.getvalue(), error


def device_trace(prof, t_lo: float, t_hi: float) -> dict:
    """Busy intervals (epoch seconds, merged), seconds by operation name,
    and the Gotoh kernels' seconds, from the profiler's device events that
    fall in [t_lo, t_hi]."""
    from torch.autograd import DeviceType
    base = prof.profiler.kineto_results.trace_start_ns() / 1e9
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        s = base + ev.time_range.start / 1e6
        e = base + ev.time_range.end / 1e6
        if e <= t_lo or s >= t_hi:
            continue
        s, e = max(s, t_lo), min(e, t_hi)
        spans.append((s, e))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (e - s)
    spans.sort()
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gotoh = sum(v for k, v in by_name.items() if "gotoh" in k)
    return {"busy": merged, "ops": by_name, "gotoh_s": gotoh}


def _rss() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _cpu_s() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime



def main() -> int:
    proto = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    init = _recv()
    t_init = time.perf_counter()
    trace, cuda = init["trace"], init["cuda"]

    import torch
    torch.set_num_threads(1)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    from centrolign_tpu_torch import cli, metrics
    from centrolign_tpu_torch import logging as logmod
    from centrolign_tpu_torch.parallel import counters
    t_imported = time.perf_counter()
    rss_imported = _rss()
    _send(proto, {"op": "imported"})

    assert _recv()["op"] == "warm"
    t_warm = time.perf_counter()
    recorder = Recorder()
    metrics.reset()
    rc, _, err, error = run_cli(cli, init["warm_argv"])
    warm_pod = metrics.counters["pod"][0] if "pod" in metrics.counters else 0
    if rc != 0 or warm_pod == 0:
        _send(proto, {"op": "failed", "why": (
            f"warm-up: rc {rc}, {warm_pod} chain-tier gaps\n"
            f"{error or ''}{err[-2000:]}")})
        return 1
    recorder.jobs.clear()
    sync()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                   else ProfilerActivity.CPU])
        prof.__enter__()
    setup = {"import_s": t_imported - t_init,
             "warm_s": time.perf_counter() - t_warm,
             "rss_imported_bytes": rss_imported, "rss_warm_bytes": _rss()}
    _send(proto, {"op": "ready", "warm_pod": warm_pod})

    go = _recv()
    t0, seconds = go["t0"], go["seconds"]
    while time.perf_counter() < t0:
        time.sleep(max(0.0, min(0.01, t0 - time.perf_counter())))
    epoch0 = time.time()
    jobs = []
    rss_first = None
    extra = ["-v", "3"] if trace else []
    while time.perf_counter() - t0 < seconds:
        _send(proto, {"op": "next"})
        job = _recv()
        metrics.reset()
        counters.reset()
        recorder.job_id = job["id"]
        cpu0 = _cpu_s()
        start, e_start = time.perf_counter(), time.time()
        rc, out, err, error = run_cli(
            cli, [*([] if job["params"] else extra), *job["argv"]])
        sync()
        end, e_end = time.perf_counter(), time.time()
        if rss_first is None:
            rss_first = _rss()
        path = os.path.join(init["dir"], f"job_n{len(jobs)}.out")
        with open(path, "w") as f:
            f.write(out)
        rec = {"id": job["id"], "kbp": job["kbp"], "start": start - t0,
               "end": end - t0, "epoch_start": e_start, "epoch_end": e_end,
               "cpu_s": _cpu_s() - cpu0,
               "rc": rc, "error": error, "output": path,
               "argv": job["argv"], "fasta": job["fasta"],
               "mode": job["output"],
               "dp": metrics.summary(), "launches": counters.snapshot()}
        if trace:
            rec["log"] = err
            rec["log_epoch0"] = logmod._start
        jobs.append(rec)
    sync()
    epoch_end = time.time()
    summary = {"op": "done", "jobs": jobs,
               "rss_first_job_bytes": rss_first, "rss_end_bytes": _rss(),
               "setup": setup,
               "device_reserved_peak_bytes":
                   torch.cuda.max_memory_reserved() if cuda else 0,
               "epoch0": epoch0, "epoch_end": epoch_end}
    if trace:
        prof.__exit__(None, None, None)
        summary["trace"] = device_trace(prof, epoch0, epoch_end)
        summary["gotoh_shapes"] = [
            (len(j[1]), len(j[2]), len(j[6]), len(j[8]))
            for j in recorder.jobs]
    capture = os.path.join(init["dir"], "capture.pkl")
    with open(capture, "wb") as f:
        pickle.dump({"jobs": jobs, "device": recorder.jobs}, f)
    summary["capture"] = capture
    summary["modules"] = top_modules()
    _send(proto, summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark of centrolign_tpu_torch on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up: the cell's inputs are simulated (portbench/traffic.py) while its
client starts (portbench/worker.py), a single-threaded process on the
card that imports the port, loads its libraries (built into
centrolign_tpu_torch/_build on the first run of a checkout) and aligns a
warm-up pair with a chain-tier gap. Window: the client starts jobs,
closed loop, while fewer than --seconds have passed; a job is
`centrolign_tpu_torch.cli.main(argv)`, the jobs in an order drawn from
the seed. Meanwhile this process samples the client's resident set. Then
the plain reference (portbench/reference/) judges every job's output
against its expected output and every chain-tier device job, in
processes of its own that import nothing of the port, and the run prints
each compared number beside its limit on standard error and one JSON line
on standard output: with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, each from its reader under
portbench/metrics/.

Exits non-zero, printing no result, without a card (or with fewer than the
cell asks for), when the client fails, or when the client, the reference
or this process loaded jax, jaxlib, flax or centrolign_tpu.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import checks, spec, traffic  # noqa: E402
from portbench.checks import RunFailed, foreign  # noqa: E402

# a message from the client has to come within this many seconds (a cold
# checkout's first warm-up builds the libraries)
MESSAGE_TIMEOUT_S = 1100.0
# how often the client's resident set is sampled in the window
RSS_PERIOD_S = 0.02


def worker_env(config: dict, device_mode: str) -> dict:
    """The client's environment: the caller's, without any setting of the
    port's (CENTROLIGN_*), then one thread, a fixed hash seed (the same
    iteration orders in every run), the configuration's own settings and
    the device."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CENTROLIGN_")}
    env.update({"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                "OPENBLAS_NUM_THREADS": "1", "USE_FLAX": "0",
                "PYTHONHASHSEED": "0",
                "PYTHONPATH": os.pathsep.join(
                    [ROOT, *filter(None, [os.environ.get("PYTHONPATH")])])})
    env.update(config.get("env", {}))
    env["CENTROLIGN_TORCH_DEVICE"] = device_mode
    return env


class Client:
    """The worker process and a thread that queues its messages."""

    def __init__(self, env: dict):
        self.inbox = queue.Queue()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.worker"], cwd=ROOT, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.proc.stdout:
            try:
                self.inbox.put(json.loads(line))
            except ValueError:
                self.inbox.put({"op": "failed",
                                "why": f"not a message: {line[:200]!r}"})
        self.inbox.put({"op": "exit"})

    def send(self, msg: dict) -> None:
        self.proc.stdin.write(json.dumps(msg) + "\n")
        self.proc.stdin.flush()

    def wait(self) -> dict:
        try:
            return self.inbox.get(timeout=MESSAGE_TIMEOUT_S)
        except queue.Empty:
            raise RunFailed(f"no message from the client in "
                            f"{MESSAGE_TIMEOUT_S} s")

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.thread.join(timeout=10)


class RssSampler:
    """Samples a process's resident set (/proc/<pid>/statm) every
    RSS_PERIOD_S from another thread: (time.perf_counter(), bytes) pairs;
    none where /proc cannot be read."""

    def __init__(self, pid: int):
        self.path = f"/proc/{pid}/statm"
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.samples = []
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.done.wait(RSS_PERIOD_S):
            try:
                with open(self.path) as f:
                    pages = int(f.read().split()[1])
            except (OSError, IndexError, ValueError):
                return
            self.samples.append((time.perf_counter(), pages * self.page))

    def stop(self) -> list:
        self.done.set()
        self.thread.join()
        return self.samples


def drive(cell: dict, seed: int, seconds: float, trace: bool,
          device_mode: str, work_dir: str, base: str, t_start: float) -> dict:
    """Set up, run the window and collect the client's summary: {"setup_s",
    "inputs_s", "window_wall_s", "jobs": [job specs], "client": summary,
    "rss_samples": [(seconds from the window's start, bytes)]}."""
    config = cell["config"]
    client = Client(worker_env(config, device_mode))
    try:
        root = traffic.ancestor(config, base)
        warm_argv = traffic.warmup_fasta(
            seed, os.path.join(work_dir, "warm.fasta"), root)
        client.send({"op": "init", "trace": trace, "dir": work_dir,
                     "warm_argv": warm_argv, "cuda": device_mode == "cuda"})
        # the inputs are simulated while the client imports and warms up
        made = {}

        def make_jobs():
            t = time.perf_counter()
            try:
                groups = traffic.cohorts(config, cell["traffic"], root)
                made["jobs"] = traffic.jobs_of(config, groups, work_dir,
                                               cell["traffic"], trace)
            except Exception as e:  # reported once the client is ready
                made["error"] = e
            made["seconds"] = time.perf_counter() - t

        maker = threading.Thread(target=make_jobs, daemon=True)
        maker.start()
        for want in ("imported", "ready"):
            msg = client.wait()
            if msg["op"] != want:
                raise RunFailed(f"the client failed in set-up: "
                                f"{msg.get('why', 'it exited')}")
            if want == "imported":
                client.send({"op": "warm"})
        maker.join()
        if "error" in made:
            raise made["error"]
        jobs = made["jobs"]
        order = traffic.order(jobs, seed)
        t0 = time.perf_counter() + 0.05
        setup_s = t0 - t_start
        sampler = RssSampler(client.proc.pid)
        client.send({"op": "go", "t0": t0, "seconds": seconds})
        sent = 0
        while True:
            msg = client.wait()
            if msg["op"] == "next":
                client.send({"op": "job", **jobs[order[sent % len(order)]]})
                sent += 1
            elif msg["op"] == "done":
                summary = msg
                break
            else:
                raise RunFailed(f"the client failed in the window: "
                                f"{msg.get('why', 'it exited')}")
        t_window = time.perf_counter() - t0
        samples = sampler.stop()
        client.proc.stdin.close()
        client.proc.wait(timeout=120)
        return {"setup_s": setup_s, "jobs": jobs, "inputs_s": made["seconds"],
                "window_wall_s": t_window, "client": summary,
                "rss_samples": [(t - t0, b) for t, b in samples]}
    finally:
        client.stop()


def card(chips: int):
    """The card's name, or a reason there is none to run on."""
    import torch
    if not torch.cuda.is_available():
        return None, "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return None, (f"{torch.cuda.device_count()} cards, the cell asks "
                      f"for {chips}")
    return torch.cuda.get_device_name(0), None


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device_mode: str = "cuda", root: str = ROOT,
             control: bool = False, t_start: float | None = None):
    """One run of a cell: (run record, metrics, compared numbers); with
    `control` the record also holds "control", the numbers of the int16
    reference judged in the program's place. Set-up is counted from
    `t_start` (a time.perf_counter() instant; default now). Raises
    RunFailed."""
    if t_start is None:
        t_start = time.perf_counter()
    cell = spec.cell(name, root)
    work_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        data = drive(cell, seed, seconds, trace, device_mode, work_dir,
                     os.path.join(root, "portbench"), t_start)
        bad = {"client": foreign(data["client"]["modules"]),
               "harness": foreign(sys.modules)}
        checks.refuse_foreign(bad)
        t_check = time.perf_counter()
        expected_dir = os.path.join(root, "portbench", "expected")
        numbers, wrong, failed = checks.judge(data, expected_dir)
        data["check_s"] = time.perf_counter() - t_check
        run = checks.run_record(data, seconds, trace, failed)
        if trace and device_mode == "cuda" and not run["busy_s"]:
            raise RunFailed("the profiler's trace shows no device time")
        run["wrong"] = wrong
        if control:
            run["control"] = checks.judge(data, expected_dir, True)[0]
        metrics = {}
        wanted = cell["per_layer"] if trace else cell["end_to_end"]
        for m in wanted:
            value = spec.reader(m["name"], root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        return run, metrics, numbers
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)


def main(argv=None, *, root: str = ROOT, device_mode: str = "cuda") -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload, root)
    kind, why = card(cell["chips"])
    if kind is None:
        print(f"portbench: no card to run on: {why}", file=sys.stderr)
        return 2
    line = card_line()
    try:
        run, metrics, numbers = run_cell(args.workload, args.seed,
                                         args.seconds, bool(args.trace),
                                         device_mode, root, t_start=T_START)
    except RunFailed as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 1
    correct = all(n["ok"] for n in numbers.values())
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics,
              "device": {"platform": "gpu", "kind": kind,
                         "count": cell["chips"],
                         "memory_peak_bytes": run["memory_peak_bytes"]}}
    if args.trace:
        result["device"]["busy_s"] = run["busy_s"]
        result["device"]["window_s"] = run["window_s"]
        result["breakdown"] = run["breakdown"]
    result["card"] = line
    result["checks"] = {k: {"value": n["value"], "limit": n["limit"]}
                        for k, n in numbers.items()}
    print(f"portbench: {args.workload} seed {args.seed} on {line}; "
          f"{run['attempted']} jobs, {run['failed']} failed",
          file=sys.stderr)
    for line in checks.notes(run):
        print(line, file=sys.stderr)
    for w in run["wrong"]:
        print(f"job {w['n']} (id {w['id']}): {w['why']}", file=sys.stderr)
    for k, n in numbers.items():
        print(f"check {k} {n['value']} limit {n['limit']} "
              f"{'ok' if n['ok'] else 'FAILED'}", file=sys.stderr)
    # the metric readers have run since the last look
    if foreign(sys.modules):
        print(f"portbench: modules of JAX or the JAX package loaded: "
              f"{foreign(sys.modules)}", file=sys.stderr)
        return 1
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

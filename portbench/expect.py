"""Record the expected output of every job a cell can send.

    python3 portbench/expect.py --workload <cell> [--parallel n] \
        -- <reference CLI command ...>

The cell's jobs are written as a run writes them (portbench/traffic.py,
from the mix's data seed), the command runs once a job with the job's CLI
arguments appended, in the environment the configuration adds, and each
job's standard output is stored under portbench/expected/ by the job's
key (reference/expected.py). A job of a configuration with "params"
runs as "-C <file>" plus its CLI arguments, as in a run, and the
reference CLI has to take -C as the port does (the JAX CLI does; any
logging option in `command` is overridden by the file). A command that
fails stores nothing.
PERF.md names the reference CLI the committed files came from and how it
was run; a benchmark run never runs this.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import spec, traffic  # noqa: E402
from portbench.reference import expected  # noqa: E402


def record(cell_name: str, command: list, root: str = ROOT,
           parallel: int = 1, base: str | None = None,
           env: dict | None = None) -> list:
    """Run `command` over the cell's jobs, in this process's environment
    with the configuration's settings and `env` added, and store each
    output; returns the paths written."""
    cell = spec.cell(cell_name, root)
    config = cell["config"]
    base = base or os.path.join(root, "portbench", "expected")
    with tempfile.TemporaryDirectory(prefix="portbench-expect-") as d:
        anc = traffic.ancestor(config, os.path.join(root, "portbench"))
        groups = traffic.cohorts(config, cell["traffic"], anc)
        jobs = traffic.jobs_of(config, groups, d, cell["traffic"])
        env = {**os.environ, **config.get("env", {}), **(env or {})}

        def one(job):
            r = subprocess.run([*command, *job["argv"]], capture_output=True,
                               cwd=root, env=env)
            if r.returncode != 0:
                raise RuntimeError(
                    f"job {job['id']}: rc {r.returncode}\n"
                    f"{r.stderr.decode(errors='replace')[-2000:]}")
            return expected.store(
                expected.key(job["output"], job["argv"]), r.stdout, base)

        with ThreadPoolExecutor(max(1, parallel)) as pool:
            return list(pool.map(one, jobs))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" not in argv:
        print("usage: expect.py --workload <cell> [--parallel n] -- "
              "<command ...>", file=sys.stderr)
        return 2
    cut = argv.index("--")
    ap = argparse.ArgumentParser(prog="portbench/expect.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--parallel", type=int, default=1)
    args = ap.parse_args(argv[:cut])
    for p in record(args.workload, argv[cut + 1:], parallel=args.parallel):
        print(os.path.relpath(p, ROOT))
    return 0


if __name__ == "__main__":
    sys.exit(main())

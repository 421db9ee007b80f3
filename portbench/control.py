"""The readings the limits of `correct` are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds <s> [--trace 0|1]

For each seed, one whole run of the cell (as portbench/run.py makes it),
whose compared numbers are the program's readings (the lower ones), and
then the control judged on that run's own device jobs: the plain
reference computed at int16, the precision below the configuration's
int32 cells, put in the program's place (the upper readings). Prints one
JSON line a seed: the seed, the run's result as run.py prints it, and
the control's numbers. The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run as harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.spec.cell(args.workload)
    kind, why = harness.card(cell["chips"])
    if kind is None:
        print(f"portbench: no card to run on: {why}", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        try:
            run, metrics, numbers = harness.run_cell(
                args.workload, seed, args.seconds, bool(args.trace),
                control=True)
        except harness.RunFailed as e:
            print(json.dumps({"seed": seed, "failed": str(e)}), flush=True)
            continue
        strip = {k: {"value": n["value"], "limit": n["limit"]}
                 for k, n in numbers.items()}
        print(json.dumps({
            "seed": seed, "correct": all(n["ok"] for n in numbers.values()),
            "attempted": run["attempted"], "failed": run["failed"],
            "metrics": metrics, "checks": strip,
            "control": {k: {"value": n["value"], "ok": n["ok"]}
                        for k, n in run["control"].items()},
            "wrong": run["wrong"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

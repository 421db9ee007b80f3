"""Judge a run's window against the plain reference.

    python -m portbench.reference.check <capture> [--expected <dir>] \
        [--part k --parts n] [--control]

The capture (written by portbench/worker.py) holds the window's jobs,
each with its CLI arguments, input FASTA, output and return code, and the
chain tier's device jobs of those CLI jobs with the alignment and score
the program returned. Every job's output is compared byte for byte with
its recorded expected output (reference/expected.py; under --expected,
portbench/expected/ by default) and checked by what
it says (reference/outputs.py). Every device job is checked against
portbench/reference/gotoh.py at int32; with --parts n, this process takes
every n-th of them by size from the k-th (--part k) and the outputs only
in part 0, so n processes share a window. A device job is counted when
its alignment or score differs from the reference's, when its alignment
scores below the reference's optimum (the shortfall; an alignment that
is not one of the two sequences reads 10^9), and, for a job of a
pairwise run, when a side is not a stretch of the pair's own sequences
(the job does not start from the input).

With --control the int16 reference's alignments are judged in the
program's place: the control that the comparison has to fail.

Prints one JSON line, with the top-level names of the modules this
process loaded. Imports nothing of the port.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys

import numpy as np

from . import expected, gotoh, outputs

INVALID_SHORTFALL = 10 ** 9


def _is_stretch(side, seq) -> bool:
    return np.asarray(side, np.uint8).tobytes() in seq


def judge_outputs(jobs: list, base: str = expected.EXPECTED) -> tuple:
    """([{"n", "id", "why"}] of outputs that are no alignment of their
    input, the same of outputs that differ from the expected ones); "n" is
    the job's place in the window, "id" the job's."""
    wrong, differ = [], []
    for n, job in enumerate(jobs):
        with open(job["output"], "rb") as f:
            got = f.read()
        why = outputs.problem(job["mode"], got.decode(errors="replace"),
                              job["fasta"])
        if why is not None:
            wrong.append({"n": n, "id": job["id"], "why": why})
        want = expected.load(expected.key(job["mode"], job["argv"]), base)
        if want is None:
            differ.append({"n": n, "id": job["id"],
                           "why": "no expected output"})
        elif got != want:
            differ.append({"n": n, "id": job["id"],
                           "why": expected.first_difference(got, want)})
    return wrong, differ


def judge(cap: dict, control: bool = False, part: int = 0,
          parts: int = 1, base: str = expected.EXPECTED) -> dict:
    wrong, differ = judge_outputs(cap["jobs"] if part == 0 else [], base)
    fasta_of = {job["id"]: job["fasta"] for job in cap["jobs"]}
    mode_of = {job["id"]: job["mode"] for job in cap["jobs"]}
    device = cap["device"]
    picked = sorted(range(len(device)), key=lambda k: (
        -(len(device[k][1]) + 1) * (len(device[k][2]) + 1), k))[part::parts]
    n_differ = foreign = 0
    shortfall = 0
    sides = {}
    for k in picked:
        job_id, s1, s2, swap, match, mismatch, go, ge, aln, score = device[k]
        job = (s1, s2, swap, match, mismatch, go, ge)
        ref_aln, ref_score = gotoh.align(job)
        if control:
            try:
                aln, score = gotoh.align(job, dtype=np.int16)
            except ValueError:
                # the int16 backpointers lead out of the matrix: no
                # alignment, which reads as invalid
                aln, score = np.full((1, 2), -2, np.int64), None
        if not (np.array_equal(np.asarray(aln, np.int64).reshape(-1, 2),
                               ref_aln) and score == ref_score):
            n_differ += 1
        got = gotoh.score_of(aln, s1, s2, match, mismatch, go, ge)
        short = INVALID_SHORTFALL if got is None else ref_score - got
        shortfall = max(shortfall, short)
        if mode_of.get(job_id) == "cigar":
            if job_id not in sides:
                sides[job_id] = [outputs.codes(s).tobytes() for _, s in
                                 outputs.read_fasta(fasta_of[job_id])]
            a, b = sides[job_id]
            if not ((_is_stretch(s1, a) and _is_stretch(s2, b))
                    or (_is_stretch(s1, b) and _is_stretch(s2, a))):
                foreign += 1
    return {"outputs_wrong": len(wrong), "outputs_differ": len(differ),
            "wrong": (wrong + differ)[:5],
            "bad_jobs": sorted({w["n"] for w in wrong + differ}),
            "gotoh_checked": len(picked),
            "gotoh_differ": n_differ,
            "gotoh_shortfall_max": int(shortfall),
            "gotoh_inputs_foreign": foreign,
            "pairs": any(m == "cigar" for m in mode_of.values()),
            "modules": sorted({m.split(".")[0] for m in list(sys.modules)})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.reference.check")
    ap.add_argument("capture")
    ap.add_argument("--expected", default=expected.EXPECTED)
    ap.add_argument("--part", type=int, default=0)
    ap.add_argument("--parts", type=int, default=1)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    with open(args.capture, "rb") as f:
        cap = pickle.load(f)
    print(json.dumps(judge(cap, args.control, args.part, args.parts,
                           args.expected)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

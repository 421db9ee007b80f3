"""Score an alignment CIGAR against the simulation truth — repo-native
equivalent of the reference's compare_truth_aln tool (reference
src/scripts/compare_truth_aln.cpp): both the truth CIGAR and the candidate
CIGAR are replayed over the per-base root-origin identity files, counting
aligned pairs with equal/unequal origins.

Copy of centrolign_tpu/tools/compare_truth_aln.py.
"""

from __future__ import annotations

import argparse
import re
import sys


def parse_identity(path):
    with open(path) as f:
        return [int(line) for line in f if line.strip()]


def parse_cigar(path):
    with open(path) as f:
        text = "".join(line.strip() for line in f)
    return [(int(n), op) for n, op in re.findall(r"(\d+)([A-Za-z=])", text)]


def compute_consistency(identity1, identity2, cigar_ops):
    matches = mismatches = 0
    i = j = 0
    for n, op in cigar_ops:
        if op in "MX=":
            for k in range(n):
                if identity1[i + k] == identity2[j + k]:
                    matches += 1
                else:
                    mismatches += 1
            i += n
            j += n
        elif op in "IHS":
            j += n
        elif op in "DN":
            i += n
        else:
            print(f"error: unrecognized cigar operation {op}",
                  file=sys.stderr)
            sys.exit(1)
    assert i == len(identity1) and j == len(identity2)
    return matches, mismatches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="compare_truth_aln")
    ap.add_argument("identity1")
    ap.add_argument("identity2")
    ap.add_argument("truth_cigar")
    ap.add_argument("aln_cigar")
    args = ap.parse_args(argv)

    id1 = parse_identity(args.identity1)
    id2 = parse_identity(args.identity2)
    truth_m, truth_x = compute_consistency(
        id1, id2, parse_cigar(args.truth_cigar))
    aln_m, aln_x = compute_consistency(id1, id2, parse_cigar(args.aln_cigar))
    assert truth_x == 0, "LCS truth alignment must have no mismatches"

    denom = len(id1) + len(id2)
    print(f"truth matches: {truth_m}")
    print(f"truth match rate: {2 * truth_m / denom}")
    print(f"aln matches: {aln_m}")
    print(f"aln match rate: {2 * aln_m / denom}")
    print(f"aln mismatches: {aln_x}")
    print(f"aln mismatch rate: {2 * aln_x / denom}")
    print(f"aln match completeness: {aln_m / truth_m}")
    print(f"aln match accuracy: {aln_m / (aln_x + aln_m)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

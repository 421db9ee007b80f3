"""Plain checks of a job's final output against its input FASTA, judged by
what the output says: a CIGAR must be an alignment of the two sequences
(each '=' a pair of equal bases, each 'X' of unequal ones, 'I' taking a
base of the second sequence alone, 'D' of the first, every base once and
in order); a GFA must hold one path for each input sequence, named as it
is, whose segments spell it.

Bases compare as the port's CLI compares them (reference
src/utility.cpp:324-345): A, C, G, T and N in either case, every other
byte alike. Written for the benchmark; it imports nothing of the port.
"""

from __future__ import annotations

import re

import numpy as np

_ENC = np.full(256, 5, np.uint8)
for _k, _c in enumerate("ACGTN"):
    _ENC[ord(_c)] = _k
    _ENC[ord(_c.lower())] = _k
_COMP = str.maketrans("ACGTNacgtn", "TGCANtgcan")
_CIGAR = re.compile(r"(\d+)([=XIDM])")


def read_fasta(path: str) -> list:
    """[(name, sequence)] of a FASTA file."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                records.append((line[1:].split(" ")[0], []))
            elif records:
                records[-1][1].append(line)
    return [(n, "".join(parts)) for n, parts in records]


def codes(seq: str) -> np.ndarray:
    return _ENC[np.frombuffer(seq.encode("ascii"), np.uint8)]


def cigar_problem(text: str, seq1: str, seq2: str) -> str | None:
    """Why `text` is not an alignment of seq1 against seq2, or None."""
    text = text.strip()
    if not text:
        return "empty output"
    if _CIGAR.sub("", text):
        return "not a CIGAR"
    a, b = codes(seq1), codes(seq2)
    i = j = 0
    for n, op in _CIGAR.findall(text):
        n = int(n)
        if n == 0:
            return "an operation of length 0"
        if op in "=XM":
            if i + n > len(a) or j + n > len(b):
                return f"{n}{op} runs past a sequence's end"
            eq = a[i:i + n] == b[j:j + n]
            if op == "=" and not eq.all():
                return f"'=' over unequal bases at {i}, {j}"
            if op == "X" and eq.any():
                return f"'X' over equal bases at {i}, {j}"
            i += n
            j += n
        elif op == "D":
            i += n
        else:
            j += n
    if (i, j) != (len(a), len(b)):
        return f"takes {i} and {j} bases of {len(a)} and {len(b)}"
    return None


def gfa_problem(text: str, records) -> str | None:
    """Why the GFA `text` does not spell each of the (name, sequence)
    records along the path of its name, or None."""
    segments, paths = {}, {}
    for line in text.splitlines():
        fields = line.split("\t")
        if fields[0] == "S" and len(fields) >= 3:
            segments[fields[1]] = fields[2]
        elif fields[0] == "P" and len(fields) >= 3:
            if fields[1] in paths:
                return f"two paths named {fields[1]}"
            paths[fields[1]] = fields[2]
    names = [n for n, _ in records]
    if sorted(paths) != sorted(names):
        return f"paths {sorted(paths)[:5]} for sequences {sorted(names)[:5]}"
    for name, seq in records:
        parts = []
        for step in paths[name].split(","):
            seg, strand = step[:-1], step[-1:]
            if seg not in segments or strand not in "+-":
                return f"path {name} steps on {step!r}"
            s = segments[seg]
            parts.append(s if strand == "+" else s.translate(_COMP)[::-1])
        spelled = "".join(parts)
        if not np.array_equal(codes(spelled), codes(seq)):
            return f"path {name} does not spell its sequence"
    return None


def problem(mode: str, text: str, fasta: str) -> str | None:
    records = read_fasta(fasta)
    if mode == "cigar":
        if len(records) != 2:
            return f"{len(records)} sequences for a CIGAR"
        return cigar_problem(text, records[0][1], records[1][1])
    if mode == "gfa":
        return gfa_problem(text, records)
    raise ValueError(f"no check for output {mode!r}")

"""FASTA parsing with the reference's validation rules
(reference src/utility.cpp:19-60): names are taken up to the first space,
line lengths within a record must be non-increasing and equal except for the
final line.

Copy of centrolign_tpu/io/fasta.py.
"""

from __future__ import annotations

import io
from typing import TextIO


def parse_fasta(stream) -> list[tuple[str, str]]:
    if isinstance(stream, str):
        stream = io.StringIO(stream)
    parsed: list[tuple[str, list[str]]] = []
    prev_len = None
    prev_prev_len = None
    for line_num, line in enumerate(stream, 1):
        line = line.rstrip("\n")
        if line.startswith(">"):
            name = line[1:].split(" ")[0]
            if not name:
                raise ValueError(f"FASTA input is missing sequence name at line {line_num}")
            parsed.append((name, []))
            prev_len = prev_prev_len = None
        else:
            if not parsed:
                raise ValueError("FASTA input does not have sequence name line")
            if (prev_prev_len is not None and prev_len != prev_prev_len and line):
                raise ValueError(
                    "Encountered sequence lines of unequal lengths that were not "
                    f"followed by a sequence name at line {line_num} of FASTA input")
            if prev_len is not None and len(line) > prev_len:
                raise ValueError(
                    "Encountered adjacent sequence lines of increasing lengths "
                    f"at line {line_num} of FASTA input")
            parsed[-1][1].append(line)
            prev_prev_len = prev_len
            prev_len = len(line)
    return [(name, "".join(chunks)) for name, chunks in parsed]


def parse_fasta_file(path: str) -> list[tuple[str, str]]:
    with open(path) as f:
        return parse_fasta(f)

"""The expected output of each job, recorded once and compared byte for byte.

A job is keyed by what it computes: its output's kind and its CLI
arguments, each argument that names a file replaced by the SHA-256 of the
file's bytes, so the key holds wherever the inputs were written. A
parameter file (the argument after -C, reference/paramfile.py) is keyed by
its parameters instead: fasta_name and tree_name by the SHA-256 of the
files they name, logging_level left out (a traced run writes 3 there), and
every other parameter by its value, so that a change to any of them
changes the key. Its
expected output is `portbench/expected/<key>.gz`, written by
`portbench/expect.py` from a reference CLI (PERF.md says which). A cell
whose data is fixed ships the expected output of every job it can send;
a later cell adds its own files.

Imports nothing of the port.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os

from . import paramfile

HERE = os.path.dirname(os.path.abspath(__file__))
EXPECTED = os.path.join(os.path.dirname(HERE), "expected")


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _params(path: str) -> list:
    """[[name, value]] of a parameter file, sorted, the input files by
    content and the logging level left out."""
    with open(path) as f:
        params = paramfile.parse(f.read())
    params.pop("logging_level", None)
    for name in ("fasta_name", "tree_name"):
        if params.get(name):
            params[name] = f"file:{_digest(params[name])}"
    return sorted([name, value] for name, value in params.items())


def key(mode: str, argv: list) -> str:
    """The job's key: its output kind and arguments, files by content and
    a parameter file by its parameters."""
    words = [mode]
    for k, a in enumerate(argv):
        if not os.path.isfile(a):
            words.append(f"arg:{a}")
        elif k and argv[k - 1] == "-C":
            words.append(f"params:{json.dumps(_params(a))}")
        else:
            words.append(f"file:{_digest(a)}")
    return hashlib.sha256(json.dumps(words).encode()).hexdigest()[:32]


def path(job_key: str, base: str = EXPECTED) -> str:
    return os.path.join(base, f"{job_key}.gz")


def load(job_key: str, base: str = EXPECTED) -> bytes | None:
    """The expected output's bytes, or None where none was recorded."""
    p = path(job_key, base)
    if not os.path.exists(p):
        return None
    with gzip.open(p, "rb") as f:
        return f.read()


def store(job_key: str, output: bytes, base: str = EXPECTED) -> str:
    """Record an expected output; the file's bytes do not depend on when
    it was written."""
    os.makedirs(base, exist_ok=True)
    p = path(job_key, base)
    with open(p, "wb") as raw, gzip.GzipFile(fileobj=raw, mode="wb",
                                             filename="", mtime=0) as f:
        f.write(output)
    return p


def first_difference(got: bytes, want: bytes) -> str:
    """Where two outputs first differ, in a few words."""
    n = next((k for k, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    return (f"differs from the expected output at byte {n} "
            f"({len(got)} bytes against {len(want)}): "
            f"{got[n:n + 24]!r} for {want[n:n + 24]!r}")

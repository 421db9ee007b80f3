"""Per-aligner performance counters + optional per-gap instrumentation.

The reference has a compile-time `instrument` flag that prints, per stitched
gap, the chosen aligner tag, matrix size, and nanosecond timing (reference
stitcher.hpp:148-177, 241-366). Here the counters are always on (they cost
one dict update per gap) and drive the benchmark's DP cell-updates/sec
metric; per-gap log lines are emitted when CENTROLIGN_TPU_INSTRUMENT=1.

Aligner tags (matching the reference's): 'po' full-matrix PO-POA (host),
'pod' PO-POA on the device kernel, 'w' pruned WFA, 'ad1'/'ad2' deletion WFA,
'pd1'/'pd2' pure deletion, 'u' unalignable (greedy partial).

Copy of centrolign_tpu/metrics.py.
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict

_INSTRUMENT = os.environ.get("CENTROLIGN_TPU_INSTRUMENT", "0") == "1"

counters: dict = defaultdict(lambda: [0, 0, 0.0])  # tag -> [n, cells, sec]


def reset() -> None:
    counters.clear()


def record(tag: str, cells: int, seconds: float, detail: str = "") -> None:
    c = counters[tag]
    c[0] += 1
    c[1] += cells
    c[2] += seconds
    if _INSTRUMENT:
        print(f"[stitch-instrument] {tag} cells={cells} "
              f"t={seconds * 1e9:.0f}ns {detail}", file=sys.stderr)


def timer() -> float:
    return time.perf_counter()


def summary() -> dict:
    """{tag: {count, cells, seconds}} plus aggregate dp cell throughput."""
    out = {}
    total_cells = 0
    total_sec = 0.0
    for tag, (n, cells, sec) in counters.items():
        out[tag] = {"count": n, "cells": cells, "seconds": round(sec, 4)}
        if tag in ("po", "pod", "podag", "posh"):
            total_cells += cells
            total_sec += sec
    out["dp_cells"] = total_cells
    out["dp_seconds"] = round(total_sec, 4)
    out["dp_cells_per_sec"] = (
        round(total_cells / total_sec) if total_sec > 0 else 0)
    # net device-blocked time and cells (every device-engine tag), so each
    # bench round self-reports how much the chip actually contributed
    dev_cells = 0
    dev_sec = 0.0
    for tag in ("pod", "podag", "posh"):
        if tag in counters:
            dev_cells += counters[tag][1]
            dev_sec += counters[tag][2]
    out["device_cells"] = dev_cells
    out["device_contribution_s"] = round(dev_sec, 4)
    return out

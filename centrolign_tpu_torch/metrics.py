"""Per-aligner performance counters, optional per-gap instrumentation, and
the spans of each CLI job.

The reference has a compile-time `instrument` flag that prints, per stitched
gap, the chosen aligner tag, matrix size, and nanosecond timing (reference
stitcher.hpp:148-177, 241-366). Here the counters are always on (they cost
one dict update per gap); per-gap log lines are emitted when
CENTROLIGN_TPU_INSTRUMENT=1.

Aligner tags (matching the reference's): 'po' full-matrix PO-POA (host),
'pod' PO-POA on the device kernel (its seconds: the stitch's device.wait),
'w' pruned WFA, 'ad1'/'ad2' deletion WFA, 'pd1'/'pd2' pure deletion, 'u'
unalignable (greedy partial). Other tags: each SparseAffine chaining's
anchors and seconds by engine ('chain.cdq', 'chain.tree',
'chain.tree_fallback'; a masked -c chaining 'chain.masked' and, by the
engine that answered it, 'chain.masked_cdq' or 'chain.masked_tree'), and
-c's 'bond.found', one record a bond, its length in bp as cells.

Spans sit at layer boundaries, never per gap (the per-gap facts are the
counters'), and are always on: `with span(name):` records the name, the
start, the end and the span open around it. Each is timed with
time.perf_counter_ns() and placed on the epoch clock (time.time_ns(), the
clock a torch.profiler trace's events are placed on) by one anchor taken
at `reset()`. Only the main thread records: a span opened on another
thread (the anchorer's fill-in pool) is not kept. The spans of a --hosts
pool worker or a torch.distributed rank stay in that process: nothing
collects them. One `cli.main` call gives this tree:

    job                       all of cli.main
      setup                   arguments, FASTA, Core, the leaf subproblems
      calibration             the leaves' scales
        calibration.match     find_matches of a leaf against itself
        calibration.chain     ChainMerge and estimate_score_scale
      bond.chain              -c: a round's bonds found, then the
                              mask's update (its self time: the mask,
                              and the C heap's free pages handed back)
        bond.anchor           the masked anchor_chain of a leaf with itself
        bond.identify         identify_bonds, deduplicate_self_bonds
      bond.stitch             -c: a round's internal stitches and their
                              step-index translation
        stitch                one internal stitch
      subproblem              one tree merge
        match                 sentinel reassignment, match finding
        reach                 both PathMerge / PackedPathMerge
        chain                 anchorer.anchor_chain
        partition             partitioner.partition_anchors
        stitch                despecify_indel_breakpoints, Stitcher.stitch
          stitch.align        the deferred host aligners
          device.wait         the host blocked on the card
        fuse                  fuse_step
      cyclize                 -c: the bonds fused into the root
        cyclize.fuse          internal_fuse
        cyclize.simplify      simplify_bubbles
      polish                  -c: its realignment subproblems inside
      output                  the CIGAR or GFA written

`device.wait` wraps each copy from the card that waits for its kernels,
wherever it sits. A span's self time (its length less its children's)
partitions the job's wall. Once-per-process loads go to a list of their
own, `process`, which `reset()` keeps: `load.native` (the g++ library,
built if needed), `load.cuda` (one nvcc library, built if needed),
`device.init` (a device mode's first resolution) and `device.context` (a
card's CUDA context, made before the device tier's first copy to it).

Copy of centrolign_tpu/metrics.py with the spans added.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import defaultdict

_INSTRUMENT = os.environ.get("CENTROLIGN_TPU_INSTRUMENT", "0") == "1"

counters: dict = defaultdict(lambda: [0, 0, 0.0])  # tag -> [n, cells, sec]
# [name, parent index or -1, start ns, end ns] on the epoch clock
spans: list = []
process: list = []
_open: list = []  # indices into `spans` of the spans open, innermost last
_anchor = (time.perf_counter_ns(), time.time_ns())
_generation = 0
_MAIN = threading.main_thread().ident
_record_lock = threading.Lock()


def reset() -> None:
    """Clear the job's counters and spans, and anchor the span clock anew;
    `process` is kept."""
    global _anchor, _generation
    counters.clear()
    spans.clear()
    _open.clear()
    _generation += 1
    _anchor = (time.perf_counter_ns(), time.time_ns())


def _epoch_ns(t: int) -> int:
    return _anchor[1] + (t - _anchor[0])


class span:
    """`with span(name):` records a span of this job, a child of the span
    open around it."""

    __slots__ = ("name", "k", "gen", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.k = -1
        if threading.get_ident() == _MAIN:
            self.k, self.gen = len(spans), _generation
            spans.append([self.name, _open[-1] if _open else -1, 0, 0])
            _open.append(self.k)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.k >= 0 and self.gen == _generation:
            _open.pop()
            s = spans[self.k]
            s[2], s[3] = _epoch_ns(self.t0), _epoch_ns(t1)
        return False


class process_span:
    """`with process_span(name):` records a once-per-process span in
    `process` (parent -1)."""

    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        process.append([self.name, -1, _epoch_ns(self.t0), _epoch_ns(t1)])
        return False


def seconds_of(name: str, first: int = 0) -> float:
    """Seconds in the closed spans called `name` among spans[first:]."""
    return sum(s[3] - s[2] for s in spans[first:] if s[0] == name) / 1e9


def record(tag: str, cells: int, seconds: float, detail: str = "") -> None:
    # the anchorer's fill-in pool chains on worker threads
    with _record_lock:
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
    """{tag: {count, cells, seconds}}, the DP cells of the stitch's
    engines ("dp_cells") and of its device engines ("device_cells"), and
    the spans: "spans" this job's, "process" the process's, each a list
    of [name, parent index or -1, start ns, end ns] on the epoch clock."""
    out = {}
    for tag, (n, cells, sec) in counters.items():
        out[tag] = {"count": n, "cells": cells, "seconds": round(sec, 4)}
    out["dp_cells"] = sum(counters[t][1] for t in ("po", "pod", "podag",
                                                   "posh") if t in counters)
    out["device_cells"] = sum(counters[t][1] for t in ("pod", "podag",
                                                       "posh")
                              if t in counters)
    out["spans"] = [list(s) for s in spans]
    out["process"] = [list(s) for s in process]
    return out

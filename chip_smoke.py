#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (centrolign_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:
1. environment: torch and CUDA versions, the card's name and power limit;
   a card is required;
2. build: every kernel source of centrolign_tpu_torch/csrc/ with nvcc for
   sm_90a, one nvcc process per source, all started together;
3. the Gotoh kernels against their plain PyTorch versions on a bag of jobs
   covering npw 1-3, both lane orientations, swap_pref both, more than 8
   jobs in one launch, the fill's edge widths (short sides 0-5, 31-33,
   63/65, 127-129, 255-257), jobs split over a cluster beside jobs of one
   block, the 4356 x 3330 gap, short sides over 4096 and penalties large
   enough for the fill's exact (unscaled) arithmetic: bit-equal
   backpointers, scores and traceback rows (tolerance: exact, integer DP);
3b. the DAG x DAG kernels against their plain versions on a bag covering
   in-degree up to 4 and span up to 32 on both sides, npw 1-3, several
   sources and sinks, walks that leave through the boundary row, the
   boundary column and the corner, a job with no interior alignment, a job
   whose state is in global scratch, more than 8 jobs in one launch,
   five.fasta's shapes with the fill's lanes on graph 1 (166 x 1189, 242 x
   1268) and on graph 2 (1268 x 242, 1195 x 169), and a short side of one
   warp: bit-equal backpointers, sink M and traceback rows (exact);
3c. the single-problem Gotoh entry against its plain version on three
   pairs, one with a short side over 4096 (exact);
3d. the device-chaining kernels against their plain versions on a bag
   (exact: dp, bp, tie, struct, stored and dp, winners bit-equal): the CDQ
   scan on one launch of 7 problems (n 0, 1, 8, two tie-dense, anchors
   that end before they start, n 1,100 > the block's 1,024 threads), on a
   chain of 2,000 levels, on a batch of unequal depths (300 levels, a
   random 2,000, 600 anchors ending before they start, 5,000 in two levels
   of 2,500 queries: more than a block's threads and a chunk of
   partials), and on n 4,096 scanning the prefix, every row, and staged 8
   rows at a time; the event scan on n 1, 8, 300 tie-dense, 1,100, 4,096,
   a chain of 2,000 anchors, n 12,000 staged 16 slots at a time and n
   40,000; each with its levels, queries a level and grid barriers;
3e. the lane-sharded Gotoh (L5) against its plain version with 1, 2, 3 and
   4 shards on the card (and across the cards when there are two or more)
   on a bag (npw 1-3, both lane orientations, swap_pref both, empty and
   tiny gaps, the chunk's edges) and a related 4,500 x 4,500 pair:
   bit-equal scores and backpointers, alignments and scores equal to the
   single-problem entry; time, time a diagonal, launches, halo copies,
   event waits between the shards' streams, the host's time to queue a
   fill, bound, and the ptxas report (registers, spills) of the kernel's
   variants;
3f. the lane-sharded Gotoh at a 4356 x 3330 and a 4,500 x 4,500 gap over
   1, 2 and 4 shards for chunk lengths and block widths (HALO/BLOCK_LANES)
   64/128, 128/128, 128/256 and 256/512, each bit-equal to the module's:
   time a fill and a diagonal, launches;
4. the pairwise path: the port's CLI on benchdata/pair.fasta; the CIGAR
   must equal benchdata/ref_pair.cigar.txt byte for byte, both Gotoh
   kernels must have launched, and the device tier must have taken 28 gaps
   of 24,191,366 DP cells; then the Gotoh kernels are timed against their
   plain versions on the jobs this path dispatched;
4b. pair.fasta through the sequence-parallel tier on two shards of the
   card (CENTROLIGN_TPU_SHARD_MIN_CELLS=14000000): the CIGAR must equal the
   reference, the tier must have taken the 4356 x 3330 gap alone and the
   sharded kernel launched; the kernel is timed there against its plain
   version, and the tier's host time on the gap split into the fill (to
   the card's end), the gather of scores and backpointers to the host and
   the host traceback;
5. the MSA path: the port's CLI on benchdata/five.fasta with five.nwk and
   CENTROLIGN_TORCH_DEVICE_DAG=1; the GFA must equal benchdata/ref_five.gfa
   byte for byte, all four kernels must have launched, the DAG tier must
   have taken 12 jobs of 2,731,723 cells and the chain tier 88 jobs of
   21,645,992 cells; then the DAG kernels and the Gotoh kernels are held
   and timed against their plain versions on the jobs this path
   dispatched, with each DAG fill launch's largest job (the most cells),
   its diagonals and the time per diagonal step;
5b. the MSA path again with the DAG tier off: the same GFA, and its wall
   and host `po` time beside the first run's;
6. the single-problem entry on a pair.fasta-sized gap (4356 x 3330), timed
   against its plain version, and the Gotoh traceback alone on that gap,
   with its steps and the time per step;
6b. the Gotoh fill alone on that gap and on narrower ones of the same
   length, each with one block (C = 1) and split over a cluster (C = 8),
   bit-equal to the plain fill, with the time per diagonal step: where the
   two cross sets gotoh_cuda.CLUSTER_MIN_LANES;
6c. the DAG traceback alone on the DAG bag's 2400 x 2400 job and on
   five.fasta's longest walk, bit-equal to the host walk, with its steps
   and the time per step;
7. the device tier against host `po` below `device_min_cells`: pair.fasta
   again with the threshold at 10,000 cells (the same CIGAR); the chain
   gaps of 10,000 to 160,000 cells it dispatched are aligned by host `po`
   and by one fill + traceback dispatch on the card, both timed;
8. the pairwise path with device chaining: pair.fasta with
   CENTROLIGN_TPU_DEVICE_CDQ=1 and CENTROLIGN_TPU_DEVICE_CHAIN=1; the CIGAR
   must equal the reference, the CDQ scan must have launched once over
   145,331 anchors and the event scan 3 times over 24,025, 22,506 and
   145,331; the CDQ values must be bit-equal to the native engine's (bp
   where untied) and the free-gap chains identical to the native parity
   engine's; each kernel is timed at the path's problems and held against
   its plain version there (bit-equal), with its levels, mean and max
   queries a level, grid barriers, the host schedule's ms and the time a
   level, beside the native engines' time, its bound (the work the
   function needs: the native CDQ engine's O(N log^2 N) steps, a
   prefix-maximum tree's O(E log n)) and the bound of this design's own
   work (rows staged per level, query x row tests, partials);
9. five.fasta with --hosts 2 (the pool executor, two workers on the card):
   the GFA must equal the reference, every worker must have run on the
   card and the workers' kernel launches (sent back with their results)
   must be over 0, with no worker recomputed in the parent; wall beside
   5b's serial run;
10. five.fasta with CENTROLIGN_TPU_EXECUTOR=jaxdist --hosts 2 (two
   torch.distributed ranks on gloo, one card): the same GFA gate, each
   rank on the card, their launches; wall;
and at the end neither jax nor any module of the JAX package may be in the
process, nor in any worker or rank. Each path runs with the launch counters set to 0 just before it
and read just after. The last three lines of standard output are the
kernel table, the card's name and power limit, and {"ok": true, ...}.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(HERE, "benchdata")
PAIR = os.path.join(BENCH, "pair.fasta")
REF_CIGAR = os.path.join(BENCH, "ref_pair.cigar.txt")
FIVE = os.path.join(BENCH, "five.fasta")
FIVE_TREE = os.path.join(BENCH, "five.nwk")
REF_GFA = os.path.join(BENCH, "ref_five.gfa")
GOTOH_SRC = "centrolign_tpu_torch/csrc/gotoh.cu"
DAG_SRC = "centrolign_tpu_torch/csrc/popoa_dag.cu"
CDQ_SRC = "centrolign_tpu_torch/csrc/chain_cdq.cu"
SCAN_SRC = "centrolign_tpu_torch/csrc/chain_scan.cu"
SHARD_SRC = "centrolign_tpu_torch/csrc/sharded_gotoh.cu"
# the TPU kernels (and lax device loops) these replace
KERNELS = {
    "gotoh_fill": (GOTOH_SRC, "centrolign_tpu/ops/gotoh_pallas.py:602"),
    "gotoh_traceback": (GOTOH_SRC, "centrolign_tpu/ops/gotoh_pallas.py:652"),
    "gotoh_align_single": (GOTOH_SRC,
                           "centrolign_tpu/ops/gotoh_pallas.py:177"),
    "popoa_dag_fill": (DAG_SRC, "centrolign_tpu/ops/popoa_dag.py:173"),
    "popoa_dag_traceback": (DAG_SRC, "centrolign_tpu/ops/popoa_dag.py:376"),
    "chain_cdq_scan": (CDQ_SRC, "centrolign_tpu/ops/chain_cdq.py:58"),
    "chain_scan_event": (SCAN_SRC, "centrolign_tpu/ops/chain_scan.py:53"),
    "sharded_gotoh_fill": (SHARD_SRC,
                           "centrolign_tpu/parallel/sharded_gotoh.py:156"),
}
SOURCES = ["gotoh", "popoa_dag", "chain_cdq", "chain_scan", "sharded_gotoh"]
# pair.fasta through the sequence-parallel tier: with the threshold at
# 14,000,000 cells only the 4356 x 3330 gap (4357 x 3331 = 14,513,167
# cells) takes it
SHARD_MIN_CELLS = "14000000"
PAIR_SHARD_GAPS = 1
PAIR_GAPS, PAIR_CELLS = 28, 24_191_366
FIVE_DAG_JOBS, FIVE_DAG_CELLS = 12, 2_731_723
FIVE_CHAIN_JOBS, FIVE_CHAIN_CELLS = 88, 21_645_992
# pair.fasta with device chaining: the CDQ value pass of the pair and the
# free-gap chains of the two calibrations and of the pair
CHAINING = {"CENTROLIGN_TPU_DEVICE_CDQ": "1", "CENTROLIGN_TPU_DEVICE_CHAIN": "1"}
PAIR_CDQ_ANCHORS = (145_331,)
PAIR_SCAN_ANCHORS = (24_025, 22_506, 145_331)
# H100 SXM peaks for the bound: 3.35 TB/s of HBM; int32 on the CUDA cores
# at 64 lanes per SM x 132 SMs x 1,980 MHz (one operation per lane per
# clock; the tensor cores' int8 rate does not apply to these kernels)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, check=True)
    return r.stdout.strip().splitlines()[0]


class Work:
    """Operations and bytes of a kernel's work, for its bound: the larger
    of operations over the int32 rate and bytes over the HBM rate."""

    def __init__(self):
        self.ops = 0
        self.bytes = 0

    def add(self, ops, nbytes):
        self.ops += ops
        self.bytes += nbytes

    def bound(self):
        t_ops = self.ops / INT32_OPS_PER_S * 1e3
        t_bytes = self.bytes / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")


def timed(fn, reps):
    """(last result, CUDA-event ms per call) after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1) / reps


def wall_ms(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# Gotoh


def make_bag(rng, params):
    """Jobs shaped like the pairwise path's device tier, plus the row-kernel
    regime (short side > 4096), every option of the recurrence and the
    fill's edge widths."""
    import numpy as np
    from centrolign_tpu_torch.ops.align_params import AlignmentParams
    from centrolign_tpu_torch.ops.gotoh_cuda import CLUSTER_MIN_LANES

    def job(L1, L2, swp, npw, gen=rng):
        s1 = gen.integers(0, 4, L1).astype(np.int32)
        s2 = s1[:min(L1, L2)].copy()
        if L2 > len(s2):
            s2 = np.concatenate(
                [s2, gen.integers(0, 4, L2 - len(s2)).astype(np.int32)])
        if L2:
            idx = gen.integers(0, L2, max(1, L2 // 10))
            s2[idx] = (s2[idx] + 1) % 4
        return (s1, s2, swp, params.truncated(npw))

    bag = [job(int(rng.integers(141, 700)), int(rng.integers(141, 700)),
               bool(k % 2), 1 + k % 3) for k in range(12)]
    bag += [job(4356, 3330, False, 3), job(3330, 4356, True, 2),
            job(4500, 5200, False, 3), job(5300, 4200, True, 2)]
    # the fill's edges, from a generator of their own: short sides around a
    # thread's strip and a warp's lanes (32 R, R = 1, 2, 4 and 8), and
    # just over the cluster threshold, in both orientations
    gen = np.random.default_rng(3)
    for k, short in enumerate((0, 1, 2, 3, 4, 5, 31, 32, 33, 63, 65, 127,
                               128, 129, 255, 256, 257,
                               CLUSTER_MIN_LANES + 1)):
        long = short + int(gen.integers(0, 300))
        swp, npw = bool(k % 2), 1 + k % 3
        bag.append(job(short, long, swp, npw, gen) if k % 4 < 2
                   else job(long + 1, short, swp, npw, gen))
    # penalties whose values may leave +-2^20: the fill's exact path
    s1, s2, _, _ = job(500, 460, False, 3, gen)
    bag.append((s1, s2, True, AlignmentParams(
        2000, 8000, (6000, 80000, 250000), (3000, 500, 100))))
    return bag


def gotoh_work(jobs, rows, fill, tb):
    """Add one launch's work: fill ops per cell 3 + 18 npw (the int32
    max/add/compare of gotoh.cu per cell), bytes = table, sequences,
    backpointers and scores; traceback 8 ops and one 2-byte load per step,
    plus its rows."""
    for s1, s2, _, p in jobs:
        V1, V2 = len(s1), len(s2)
        fill.add((V1 + 1) * (V2 + 1) * (3 + 18 * p.num_pw),
                 64 + 4 * (V1 + V2) + 2 * (V1 + V2 + 1) * (min(V1, V2) + 1)
                 + 4)
    steps = int(rows[:, 0, 0].sum())
    tb.add(8 * steps, 2 * steps + 64 * len(jobs) + rows.nbytes)


def compare_gotoh(jobs, device, reps):
    """Run `jobs` through both Gotoh kernels and their plain versions on
    the card. Returns per kernel (max_abs_err, kernel ms, plain ms) and the
    traceback rows."""
    import torch
    from centrolign_tpu_torch.ops import gotoh as plain
    from centrolign_tpu_torch.ops import gotoh_cuda as gc

    table = gc.params_table(jobs).to(device)
    seqs = gc.pack_seqs(jobs).to(device)
    bp_size, plan, cap = gc.launch_sizes(jobs)
    (bp_k, sc_k), fill_ms = timed(
        lambda: gc.gotoh_fill(table, seqs, bp_size, plan), reps)
    rows_k, tb_ms = timed(
        lambda: gc.gotoh_traceback(bp_k, sc_k, table, cap), reps)
    (bp_p, sc_p), fill_plain_ms = wall_ms(
        lambda: plain.gotoh_fill_plain(table, seqs))
    rows_p, tb_plain_ms = wall_ms(
        lambda: plain.gotoh_traceback_plain(bp_k, sc_k, table, cap))
    bp_err = int((bp_k.view(torch.int16).int()
                  - bp_p.view(torch.int16).int()).abs().max()) if bp_size else 0
    sc_err = int((sc_k - sc_p).abs().max())
    tb_err = int((rows_k - rows_p).abs().max())
    require(bp_err == 0 and sc_err == 0,
            f"fill kernel disagrees with its plain version: bp {bp_err}, "
            f"score {sc_err}")
    require(tb_err == 0, f"traceback kernel disagrees with the host walk: "
            f"{tb_err}")
    return ({"gotoh_fill": (max(bp_err, sc_err), fill_ms, fill_plain_ms),
             "gotoh_traceback": (tb_err, tb_ms, tb_plain_ms)},
            rows_k.cpu().numpy())


def compare_path_gotoh(dispatched, launches, device, table, errs):
    """Hold both Gotoh kernels against their plain versions on every
    launch a path made (`dispatched`: the job list of each gotoh_dispatch
    call; `launches`: the fill launches the path counted), adding times and
    work to `table` and errors to `errs`. Returns (kernel ms, plain ms) per
    kernel over this path's launches."""
    from centrolign_tpu_torch.ops import gotoh_cuda as gc

    parts = [part for jobs in dispatched for part in gc._split_launches(jobs)]
    require(len(parts) == launches, f"the path made {launches} Gotoh fill "
            f"launches but dispatched {len(parts)}")
    here = {"gotoh_fill": [0.0, 0.0], "gotoh_traceback": [0.0, 0.0]}
    for part in parts:
        res, rows = compare_gotoh(part, device, reps=5)
        gotoh_work(part, rows, table["gotoh_fill"]["work"],
                   table["gotoh_traceback"]["work"])
        for name, (err, ms, pms) in res.items():
            table[name]["ms"] += ms
            table[name]["plain_ms"] += pms
            here[name][0] += ms
            here[name][1] += pms
            errs[name] = max(errs[name], err)
    return here


def compare_single(job, device, reps):
    """gotoh_align_device on the card against the plain fill and host walk
    of the same job. Returns (err, kernel ms, plain ms, alignment steps)."""
    import numpy as np
    import torch
    from centrolign_tpu_torch.ops import gotoh as plain
    from centrolign_tpu_torch.ops import gotoh_cuda as gc

    s1, s2, swp, p = job
    (aln, score), ms = timed(
        lambda: gc.gotoh_align_device(s1, s2, p, swp, device), reps)
    table = gc.params_table([job]).to(device)
    seqs = gc.pack_seqs([job]).to(device)
    cap = len(s1) + len(s2)

    def run_plain():
        bp, sc = plain.gotoh_fill_plain(table, seqs)
        return plain.gotoh_traceback_plain(bp, sc, table, cap)

    rows, plain_ms = wall_ms(run_plain)
    row = rows[0].cpu().numpy().astype(np.int64)
    count, sc_p = int(row[0, 0]), int(row[0, 1])
    aln_p = row[len(row) - count:]
    err = abs(score - sc_p)
    if aln.shape == aln_p.shape:
        err = max(err, int(np.abs(aln - aln_p).max()) if len(aln) else 0)
    else:
        err = max(err, 1)
    require(err == 0, f"gotoh_align_device disagrees with its plain version "
            f"on {len(s1)} x {len(s2)}: {err}")
    return err, ms, plain_ms, len(aln)


def single_work(job, steps, work):
    s1, s2, _, p = job
    V1, V2 = len(s1), len(s2)
    work.add((V1 + 1) * (V2 + 1) * (3 + 18 * p.num_pw) + 8 * steps,
             64 + 4 * (V1 + V2) + 2 * (V1 + V2 + 1) * (min(V1, V2) + 1)
             + 4 + 2 * steps + 8 * (V1 + V2 + 1))


# ---------------------------------------------------------------------------
# DAG x DAG


def dag_graph(rng, V, K, S, n_src=1, n_sink=1, labels=None):
    """A DAG on V nodes: a backbone chain from node n_src - 1 to node
    V - n_sink, sources 0 .. n_src - 1 and sinks V - n_sink .. V - 1, and
    forward edges of span <= S (one of span exactly S) up to in-degree K."""
    import numpy as np
    from centrolign_tpu_torch.graph import BaseGraph

    g = BaseGraph()
    g.add_nodes(rng.integers(0, 4, V) if labels is None else labels)
    last = V - n_sink              # the backbone's end, the first sink
    edges = [(v - 1, v) for v in range(n_src, last + 1)]
    edges += [(s, n_src + s) for s in range(n_src - 1)]
    edges += [(t - n_sink, t) for t in range(last + 1, V)]
    indeg = np.zeros(V, int)
    for _, v in edges:
        indeg[v] += 1
    if K >= 2 and S >= 2:
        v = S + int(np.flatnonzero(indeg[S:last + 1] < K)[0])
        edges.append((v - S, v))
        indeg[v] += 1
    for v in range(n_src, last + 1):
        while indeg[v] < K and rng.random() < 0.4:
            u = v - int(rng.integers(2, S + 1)) if S >= 2 else -1
            if u < 0 or (u, v) in edges:
                break
            edges.append((u, v))
            indeg[v] += 1
    order = rng.permutation(len(edges))
    g.add_edges([edges[i][0] for i in order], [edges[i][1] for i in order])
    return g


def dag_job(g1, g2, params, src1=None, snk1=None):
    """A prepared _DagJob of g1 x g2 (sources and sinks: the nodes without
    predecessors or successors, unless given for graph 1), or None outside
    the envelope (a span can grow past S when the topological order
    interleaves branches)."""
    import numpy as np
    from centrolign_tpu_torch.ops.popoa_dag import _DagJob

    def ends(g):
        return (np.flatnonzero(g.in_degrees() == 0),
                np.flatnonzero(g.out_degrees() == 0))

    s1, k1 = ends(g1)
    s2, k2 = ends(g2)
    j = _DagJob(g1, g2, s1 if src1 is None else src1, s2,
                k1 if snk1 is None else snk1, k2, params)
    if not j.eligible:
        return None
    j.prepare()
    return j


def related_dag_job(rng, params, V, K, S, lead1, lead2, n_src=1, n_sink=1):
    """A job of two graphs over mutated copies of one sequence, graph 1
    with `lead1` extra leading nodes and graph 2 with `lead2` (so the walk
    leaves through the column, the row or the corner), each of in-degree
    up to K and span up to S."""
    import numpy as np

    for _ in range(20):
        base = rng.integers(0, 4, V)
        lab2 = base.copy()
        flip = rng.random(V) < 0.05
        lab2[flip] = (lab2[flip] + 1) % 4
        lab1 = np.concatenate([rng.integers(0, 4, lead1), base])
        lab2 = np.concatenate([rng.integers(0, 4, lead2), lab2])
        j = dag_job(dag_graph(rng, len(lab1), K, S, n_src, n_sink, lab1),
                    dag_graph(rng, len(lab2), K, S, n_src, n_sink, lab2),
                    params)
        if j is not None:
            return j
    raise RuntimeError("no bag job inside the envelope in 20 draws")


def make_dag_bag(rng, params):
    """(jobs, what) for the DAG kernels: prepared _DagJobs and a label for
    each (see the module docstring, phase 3b)."""

    def job(g1, g2, npw, src1=None, snk1=None):
        return dag_job(g1, g2, params.truncated(npw), src1, snk1)

    def related(V, K, S, lead1, lead2, npw, n_src=1, n_sink=1):
        return related_dag_job(rng, params.truncated(npw), V, K, S, lead1,
                               lead2, n_src, n_sink)

    jobs, what = [], []
    for k in range(12):
        lead1, lead2 = [(60, 0), (0, 60), (0, 0)][k % 3]
        K = 1 + k % 4
        S = [1, 8, 32, 4][k % 4]
        many = K > 1
        jobs.append(related(int(rng.integers(100, 400)), K, S, lead1, lead2,
                            1 + k % 3, n_src=1 + many * (k % 2),
                            n_sink=1 + many * (k % 3)))
        what.append("")
    jobs.append(related(290, 4, 32, 0, 0, 3, n_src=2, n_sink=3))
    what.append("several sources and sinks")
    jobs.append(related(242, 2, 4, 1026, 0, 3))
    what.append("1268 x 242")
    # five.fasta's shapes with the lanes on graph 1 (166 x 1189, 242 x
    # 1268) and on graph 2 (1195 x 169), and a short side of one warp
    jobs.append(related(166, 2, 4, 0, 1023, 3))
    what.append("166 x 1189")
    jobs.append(related(242, 1, 1, 0, 1026, 3))
    what.append("242 x 1268")
    jobs.append(related(169, 1, 1, 1026, 0, 3))
    what.append("1195 x 169")
    jobs.append(related(30, 2, 4, 0, 260, 2))
    what.append("one warp of lanes")
    jobs.append(related(2400, 4, 32, 0, 0, 3))
    what.append("state in global scratch")
    # graph 1's one given source lies in one component and its one given
    # sink in another: no sink pair is reached
    two = dag_graph(rng, 80, 1, 1)
    two.remove_edge(39, 40)
    jobs.append(job(two, dag_graph(rng, 40, 2, 4), 2, src1=[0], snk1=[79]))
    what.append("no interior alignment")
    what = [f"K{j.t1.K}/{j.t2.K} S{j.t1.S}/{j.t2.S}" + (f" {w}" if w else "")
            for j, w in zip(jobs, what)]
    return jobs, what


def dag_work(jobs, rows, fill, tb):
    """Add one launch's work: fill ops per cell 20 + 6 K1 + 12 K2 + npw
    (6 (K1 + K2) + 17) (the int32 compares, maxima and adds of
    popoa_dag.cu per cell), bytes = the job's data, table row,
    backpointers and sink M; traceback 15 ops and one 4-byte load per
    step, the sink scan, and its rows."""
    for j in jobs:
        K1, K2 = j.t1.delta.shape[0], j.t2.delta.shape[0]
        npw = j.params.num_pw
        n12 = len(j.sink_pos1) * len(j.sink_pos2)
        data = ((6 + K1) * j.t1.V + (4 + K2) * j.t2.V
                + len(j.sink_pos1) + len(j.sink_pos2))
        fill.add(j.cells * (20 + 6 * K1 + 12 * K2
                            + npw * (6 * (K1 + K2) + 17)),
                 4 * data + 96 + 4 * j.cells + 4 * n12)
        tb.add(n12, 4 * n12 + 96)
    steps = int(rows[:, 0, 0].sum())
    tb.add(15 * steps, 4 * steps + rows.nbytes)


def compare_dag(jobs, device, reps):
    """Run `jobs` through both DAG kernels and their plain versions on the
    card. Returns per kernel (max_abs_err, kernel ms, plain ms) and the
    traceback rows."""
    from centrolign_tpu_torch.ops import popoa_dag as plain
    from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc

    table, data, (bp_size, sm_size, scratch, smem, cap, lanes) = \
        pdc.dag_launch(jobs, device)
    (bp_k, sm_k), fill_ms = timed(lambda: pdc.popoa_dag_fill(
        table, data, bp_size, sm_size, scratch, smem, lanes), reps)
    rows_k, tb_ms = timed(lambda: pdc.popoa_dag_traceback(
        bp_k, sm_k, table, data, cap), reps)
    (bp_p, sm_p), fill_plain_ms = wall_ms(
        lambda: plain.popoa_dag_fill_plain(table, data))
    rows_p, tb_plain_ms = wall_ms(lambda: plain.popoa_dag_traceback_plain(
        bp_k, sm_k, table, data, cap))
    fill_err = max(int((bp_k - bp_p).abs().max()) if bp_size else 0,
                   int((sm_k - sm_p).abs().max()))
    tb_err = int((rows_k - rows_p).abs().max())
    require(fill_err == 0, f"DAG fill kernel disagrees with its plain "
            f"version: {fill_err}")
    require(tb_err == 0, f"DAG traceback kernel disagrees with the host "
            f"walk: {tb_err}")
    return ({"popoa_dag_fill": (fill_err, fill_ms, fill_plain_ms),
             "popoa_dag_traceback": (tb_err, tb_ms, tb_plain_ms)},
            rows_k.cpu().numpy())


# ---------------------------------------------------------------------------
# device chaining


def cdq_problem(rng, n, tie_dense=False, bent=False):
    """A SparseAffine chain problem of n anchors shaped like
    tests/test_chain_cdq.py's (default gap parameters): random, or on a grid
    with equal weights so that maxima tie; `bent` makes a third of the
    anchors end before they start on both chains (the kernel then scans
    every row)."""
    import numpy as np
    if tie_dense:
        p1 = rng.integers(1, 4000 // 24, n) * 24
        p2 = p1 + rng.choice([-4, 0, 0, 4], n)
        ln1 = ln2 = np.full(n, 16)
        w = np.full(n, 16.0, dtype=np.float32)
    else:
        p1 = rng.integers(1, 40 * max(n, 1), n)
        p2 = np.maximum(0, p1 + rng.integers(-40, 40, n))
        ln1, ln2 = rng.integers(4, 40, n), rng.integers(4, 40, n)
        w = (rng.integers(1, 5, n) * 4.0).astype(np.float32)
    ps1, pe1, ps2, pe2 = p1.copy(), p1 + ln1, p2, p2 + ln2
    if bent:
        back = rng.random(n) < 0.3
        pe1 = np.where(back, ps1 - rng.integers(1, 400, n), pe1)
        pe2 = np.where(back, ps2 - rng.integers(1, 400, n), pe2)
    init = w.copy()
    init[rng.random(n) < 0.05] = np.finfo(np.float32).min
    ps1[rng.random(n) < 0.05] = 0  # no query: starts at the chain's head
    return (ps1.astype(np.int64), pe1.astype(np.int64), ps2.astype(np.int64),
            pe2.astype(np.int64), w, init, (1.25, 50.0, 5000.0),
            (2.5, 0.1, 0.0015), float(rng.uniform(0.05, 1.5)))


def chain_problem(n):
    """A SparseAffine chain problem of n anchors, each ending before the
    next starts: n dependency levels of one query each."""
    import numpy as np
    p = np.arange(n, dtype=np.int64) * 10 + 1
    w = np.full(n, 8.0, np.float32)
    return (p, p + 4, p, p + 4, w, w.copy(), (1.25, 50.0, 5000.0),
            (2.5, 0.1, 0.0015), 0.5)


def two_level_problem(rng, n):
    """A SparseAffine chain problem of n anchors in two dependency levels of
    n / 2 queries each: the first half ends before the second starts, and
    neither half reaches into itself."""
    import numpy as np
    h = n // 2
    ps1 = np.concatenate([rng.integers(1, 50, h), rng.integers(100, 150, h)])
    pe1 = np.concatenate([rng.integers(51, 60, h), rng.integers(201, 260, h)])
    ps2 = ps1 + rng.integers(-3, 4, 2 * h)
    pe2 = pe1 + rng.integers(-3, 4, 2 * h)
    w = (rng.integers(1, 3, 2 * h) * 4.0).astype(np.float32)
    return (ps1.astype(np.int64), pe1.astype(np.int64), ps2.astype(np.int64),
            pe2.astype(np.int64), w, w.copy(), (1.25, 50.0, 5000.0),
            (2.5, 0.1, 0.0015), 0.75)


def _levels(n):
    """ceil(log2 n), at least 1."""
    return max(1, (int(n) - 1).bit_length())


def _barriers(queries, part_queries, active):
    """Grid barriers of a level of `queries` queries: two for each chunk of
    at most part_queries queries, one when no block has rows to scan
    (csrc/chain_*.cu)."""
    return (2 if active else 1) * -(-queries // part_queries)


def cdq_work(problems, arrays, work, design, blocks):
    """Add one launch's work; return its grid barriers. `work`, for the
    bound, is what the function needs, counted as the O(N log^2 N) CDQ
    engine of native/chain_affine_cdq.cpp does it: over the ceil(log2 E)
    levels of its divide and conquer each of the E events (N inserts and
    the queries) takes part in one cross, whose two sweeps make one Fenwick
    update or query each, ceil(log2 N) steps over 3 channels at 2
    operations (compare, select); bytes = each input read once and each
    output written once (126 per anchor: keys, step, weights, f64
    constants; dp, bp, tie, struct, stored). `design` is this kernel's own
    work (csrc/chain_cdq.cu), by its level schedule `arrays[6]`: each level
    stages the rows it scans (48 bytes each: the rows below the level with
    `prefix`, all N without), tests each of its queries against each of
    them at 10 operations (the compares, the channel test, the maxima),
    writes and reads 7 partials of 16 bytes per query and block with rows,
    and folds and publishes each row at 60 operations; plus the same
    inputs and outputs. `blocks` is the launch's grid."""
    import numpy as np
    from centrolign_tpu_torch.ops.chain_cdq_cuda import PART_QUERIES
    N, prefix, levels = arrays[0].shape[1], arrays[5], arrays[6]
    barriers = 1
    for b, p in enumerate(problems):
        n = len(p[0])
        order = np.lexsort((np.arange(n), p[0]))
        events = n + int((np.asarray(p[0])[order] >= 1).sum())
        work.add(events * _levels(events) * 2 * _levels(n) * 3 * 2, 126 * n)
        design.add(0, 126 * n)
    for b, q0, q1, _ in levels:
        q = int(q1 - q0)
        rows = int(q0) if prefix[b] else N
        chunk = -(-rows // blocks)
        active = -(-rows // chunk) if chunk else 0
        design.add(10 * q * rows + 60 * q,
                   48 * rows + 2 * 7 * 16 * active * q)
        barriers += _barriers(q, PART_QUERIES, active)
    return barriers


def scan_work(ev, n_slots, levels, work, design, blocks):
    """Add one launch's work; return its grid barriers. `work`, for the
    bound, is what the function needs with a prefix-maximum tree over the
    slots: each event one update or query of ceil(log2 n_slots) steps at 2
    operations (compare, select); bytes = events (16) read and winners (4)
    written per event, dp0 read and dp written per slot (8). `design` is
    this kernel's own work (csrc/chain_scan.cu), by its level schedule
    `levels`: each level stages the slots below its largest bound (8 bytes
    each), tests each of its queries against each of them at 4 operations
    (the bound, the insert's event, the maximum), writes and reads a
    partial of 8 bytes per query and block with slots; plus the same
    inputs and outputs. `blocks` is the launch's grid."""
    from centrolign_tpu_torch.ops.chain_scan_cuda import PART_QUERIES
    nbytes = 20 * len(ev) + 8 * n_slots
    work.add(2 * len(ev) * _levels(n_slots), nbytes)
    design.add(10 * len(ev), nbytes)
    barriers = 2
    for q0, q1, hi, _ in levels[0]:
        q, hi = int(q1 - q0), int(hi)
        chunk = -(-hi // blocks)
        chunk += chunk & 1
        active = -(-hi // chunk) if chunk else 0
        design.add(4 * q * hi, 8 * hi + 2 * 8 * active * q)
        barriers += _barriers(q, PART_QUERIES, active)
    return barriers


def level_stats(sizes):
    """(levels, mean and max queries a level) of a schedule's level
    sizes."""
    import numpy as np
    sizes = np.asarray(sizes)
    return (len(sizes), float(sizes.mean()) if len(sizes) else 0.0,
            int(sizes.max()) if len(sizes) else 0)


def max_err(got, want):
    """Max |difference| over matching outputs; raises unless they are equal
    bit for bit."""
    import torch
    err = 0.0
    for a, b in zip(got, want):
        a, b = a.cpu(), b.cpu()
        if a.numel():
            err = max(err, float((a.double() - b.double()).abs().max()))
        same = (torch.equal(a.view(torch.int32), b.view(torch.int32))
                if a.dtype == torch.float32 else torch.equal(a, b))
        require(same, f"kernel disagrees with its plain version: {err}")
    return err


def compare_cdq(problems, device, reps, full=False):
    """Pack `problems` into one launch and hold chain_cdq_scan against its
    plain version (prefix mode as pack chose it, or every row with
    `full`). Returns (err, kernel ms, plain ms, the packed arrays)."""
    import torch
    from centrolign_tpu_torch.ops import chain_cdq as plain
    from centrolign_tpu_torch.ops import chain_cdq_cuda as cc

    n_pad = max(len(p[0]) for p in problems)
    _, arrays = plain.pack(problems, n_pad)
    if full:
        arrays[5][:] = 0
    t = [torch.from_numpy(a).to(device) for a in arrays]
    anchors = sum(len(p[0]) for p in problems)
    got, ms = timed(lambda: cc.cdq_scan(*t, anchors=anchors), reps)
    want, plain_ms = wall_ms(lambda: plain.cdq_scan_plain(*t))
    return max_err(got, want), ms, plain_ms, arrays


def scan_problem(rng, n, tie_dense=False):
    """Inputs of sparse_chain_scan over n anchors on two chains, shaped like
    tests/test_torch_chain_scan.py's: random, or on a grid with equal
    weights."""
    import numpy as np
    grid = 24 if tie_dense else 1
    s1 = rng.integers(1, 40 * max(n, 1) // grid + 2, n) * grid
    s2 = np.maximum(s1 + (rng.choice([-4, 0, 4], n) if tie_dense
                          else rng.integers(-40, 40, n)), 0)
    ln = np.full(n, 16) if tie_dense else rng.integers(4, 40, n)
    w = np.full(n, 16.0) if tie_dense else rng.integers(1, 5, n) * 4.0
    return (s1, s1 + ln - 1, s2, s2 + ln - 1, w, rng.random(n) < 0.95,
            rng.random(n) < 0.95)


def chain_events(n):
    """Inputs of sparse_chain_scan over n anchors, each after the last on
    both chains: every query reads the insert before it, n - 1 levels (the
    first query has nothing below its bound)."""
    import numpy as np
    s = np.arange(n, dtype=np.int64) * 10 + 1
    return (s, s + 4, s, s + 4, np.full(n, 4.0), np.ones(n, bool),
            np.ones(n, bool))


def compare_scan(args, device, reps):
    """Hold chain_scan_event against its plain version on the events of
    sparse_chain_scan inputs `args`. Returns (err, kernel ms, plain ms,
    events (numpy), slots, the level schedule (numpy))."""
    import torch
    from centrolign_tpu_torch.ops import chain_scan as plain
    from centrolign_tpu_torch.ops import chain_scan_cuda as sc

    _, _, ev_np, dp0_np, levels_np = plain.build_events(*args[:6])
    ev = torch.from_numpy(ev_np).to(device)
    dp0 = torch.from_numpy(dp0_np).to(device)
    levels = tuple(torch.from_numpy(a).to(device) for a in levels_np)
    got, ms = timed(lambda: sc.event_scan(ev, dp0, levels,
                                          anchors=len(args[4])), reps)
    want, plain_ms = wall_ms(lambda: plain.event_scan_plain(ev, dp0))
    return max_err(got, want), ms, plain_ms, ev_np, len(dp0_np), levels_np


def chaining_bag(rng, device, card, errs):
    """Phase 3d: both chaining kernels against their plain versions on a
    bag. Returns {kernel: (kernel ms, plain ms, the function's Work, the
    design's Work)} over the bag."""
    import torch
    from centrolign_tpu_torch.ops import chain_cdq_cuda as cc
    from centrolign_tpu_torch.ops import chain_scan_cuda as sc

    blocks = torch.cuda.get_device_properties(device).multi_processor_count
    out = {"chain_cdq_scan": [0.0, 0.0, Work(), Work()],
           "chain_scan_event": [0.0, 0.0, Work(), Work()]}
    # L3: one launch of several problems (n = 0, 1 and 8, tie-dense ones,
    # anchors that end before they start, more anchors than threads); a
    # chain N levels deep; a batch of unequal depths with levels of more
    # queries than a block has threads and than a chunk of partials holds;
    # n = 4,096 scanning the prefix and every row, and staged 8 rows at a
    # time
    batch = [cdq_problem(rng, 0), cdq_problem(rng, 1), cdq_problem(rng, 8),
             cdq_problem(rng, 300, tie_dense=True),
             cdq_problem(rng, 400, tie_dense=True),
             cdq_problem(rng, 500, bent=True), cdq_problem(rng, 1100)]
    unequal = [chain_problem(300), cdq_problem(rng, 2000),
               cdq_problem(rng, 600, bent=True), two_level_problem(rng, 5000)]
    big = [cdq_problem(rng, 4096)]
    stage_rows = cc.STAGE_ROWS
    for what, probs, full, stage in (
            ("a batch of 7 (n 0-1100)", batch, False, stage_rows),
            ("a chain of 2000 levels", [chain_problem(2000)], False,
             stage_rows),
            ("a batch of unequal depths (300, 2000, 600 bent, 5000 in 2 "
             "levels)", unequal, False, stage_rows),
            ("n 4096", big, False, stage_rows),
            ("n 4096, every row scanned", big, True, stage_rows),
            ("n 4096, staged 8 rows at a time", big, False, 8)):
        cc.STAGE_ROWS = stage
        try:
            err, ms, pms, arrays = compare_cdq(probs, device, 3, full)
        finally:
            cc.STAGE_ROWS = stage_rows
        errs["chain_cdq_scan"] = max(errs["chain_cdq_scan"], err)
        k = out["chain_cdq_scan"]
        k[0] += ms
        k[1] += pms
        barriers = cdq_work(probs, arrays, k[2], k[3], blocks)
        lv = arrays[6]
        print(f"chain_cdq_scan bag, {what} (prefix "
              f"{[int(x) for x in arrays[5]]}, {len(lv)} levels, max "
              f"{int((lv[:, 2] - lv[:, 1]).max())} queries a level, "
              f"{barriers} grid barriers): bit-equal, kernel {ms:.3f} ms, "
              f"plain {pms:.1f} ms ({card})", flush=True)
    # L4
    empty = sc.event_scan(torch.zeros((0, 4), dtype=torch.int32,
                                      device=device),
                          torch.zeros(1, device=device),
                          (torch.zeros((0, 4), dtype=torch.int32,
                                       device=device),
                           torch.zeros(0, dtype=torch.int32, device=device)),
                          anchors=0)
    require(empty[1].numel() == 0, "an empty event scan returned winners")
    stage_rows = sc.STAGE_ROWS
    for what, args, stage in (
            ("n 1", scan_problem(rng, 1), stage_rows),
            ("n 8", scan_problem(rng, 8), stage_rows),
            ("n 300 tie-dense", scan_problem(rng, 300, True), stage_rows),
            ("n 1100", scan_problem(rng, 1100), stage_rows),
            ("n 4096", scan_problem(rng, 4096), stage_rows),
            ("a chain of 2000 anchors", chain_events(2000), stage_rows),
            ("n 12000, staged 16 slots at a time", scan_problem(rng, 12000),
             16),
            ("n 40000", scan_problem(rng, 40000), stage_rows)):
        sc.STAGE_ROWS = stage
        try:
            err, ms, pms, ev, slots, levels = compare_scan(args, device, 3)
        finally:
            sc.STAGE_ROWS = stage_rows
        errs["chain_scan_event"] = max(errs["chain_scan_event"], err)
        k = out["chain_scan_event"]
        k[0] += ms
        k[1] += pms
        barriers = scan_work(ev, slots, levels, k[2], k[3], blocks)
        n_lv, mean_q, max_q = level_stats(levels[0][:, 1] - levels[0][:, 0])
        print(f"chain_scan_event bag, {what} ({len(ev)} events, {slots} "
              f"slots, {n_lv} levels, max {max_q} queries a level, "
              f"{barriers} grid barriers): bit-equal, kernel {ms:.3f} ms, "
              f"plain {pms:.1f} ms ({card})", flush=True)
    return out


def run_chaining_path(device, card, table, errs):
    """Phase 8: pair.fasta through the CLI with both device-chaining
    switches. Checks the CIGAR, the launches and anchors of both kernels,
    the CDQ values against the native engine and the free-gap chains
    against the native parity engine, then times each kernel at the path's
    problems and holds it against its plain version there. Returns the
    counts of the path's run."""
    import copy
    import numpy as np
    import torch
    from centrolign_tpu_torch import anchorer as anchorer_mod
    from centrolign_tpu_torch.native import chain_affine_cdq
    from centrolign_tpu_torch.ops import chain_cdq, chain_scan
    from centrolign_tpu_torch.ops import chain_cdq_cuda as cc
    from centrolign_tpu_torch.ops import chain_scan_cuda as sc

    blocks = torch.cuda.get_device_properties(device).multi_processor_count
    cdq_calls, scan_calls, sparse_calls = [], [], []
    cdq_entry, scan_entry = chain_cdq.chain_cdq_device, \
        chain_scan.sparse_chain_scan
    parity = anchorer_mod.Anchorer._chain_parity

    def recording_cdq(*args):
        out = cdq_entry(*args)
        cdq_calls.append((args[:9], out))
        return out

    def recording_scan(*args):
        scan_calls.append(args[:7])
        return scan_entry(*args)

    def recording_parity(self, matches, *args):
        if args[8] != anchorer_mod.ChainAlgorithm.Sparse:
            return parity(self, matches, *args)
        kept = []
        for m in matches:
            c = copy.copy(m)
            c.walks1, c.walks2 = m.walks1.copy(), m.walks2.copy()
            kept.append(c)
        t0 = time.perf_counter()
        chain = parity(self, matches, *args)
        # fill-in anchoring rewrites the returned list in place
        # (anchorer.py::_fill_in_anchor_chain), so keep it as returned
        sparse_calls.append((self, kept, args, list(chain),
                             time.perf_counter() - t0))
        return chain

    chain_cdq.chain_cdq_device = recording_cdq
    chain_scan.sparse_chain_scan = recording_scan
    anchorer_mod.Anchorer._chain_parity = recording_parity
    os.environ.update(CHAINING)
    try:
        reset_counts()
        rc, out, wall = run_cli(["-v", "0", PAIR])
        got = counts()
    finally:
        chain_cdq.chain_cdq_device = cdq_entry
        chain_scan.sparse_chain_scan = scan_entry
        anchorer_mod.Anchorer._chain_parity = parity
        for k in CHAINING:
            os.environ.pop(k)
    require(rc == 0, f"cli.main returned {rc} on pair.fasta with device "
            "chaining")
    with open(REF_CIGAR) as f:
        require(out == f.read(), "pair.fasta CIGAR with device chaining "
                "differs from benchdata/ref_pair.cigar.txt")
    cdq_sizes = tuple(len(a[0]) for a, _ in cdq_calls)
    scan_sizes = tuple(len(a[4]) for a in scan_calls)
    require(got["chain_cdq_scan"] == len(PAIR_CDQ_ANCHORS)
            and cdq_sizes == PAIR_CDQ_ANCHORS
            and got["cdq_anchors"] == sum(PAIR_CDQ_ANCHORS),
            f"CDQ scan: {got['chain_cdq_scan']} launches over {cdq_sizes}, "
            f"want {len(PAIR_CDQ_ANCHORS)} over {PAIR_CDQ_ANCHORS}")
    require(got["chain_scan_event"] == len(PAIR_SCAN_ANCHORS)
            and scan_sizes == PAIR_SCAN_ANCHORS
            and got["scan_anchors"] == sum(PAIR_SCAN_ANCHORS),
            f"event scan: {got['chain_scan_event']} launches over "
            f"{scan_sizes}, want {len(PAIR_SCAN_ANCHORS)} over "
            f"{PAIR_SCAN_ANCHORS}")
    print(f"pair.fasta with device chaining: CIGAR byte-identical to the "
          f"reference; wall {wall:.3f} s; chain_cdq_scan {got['chain_cdq_scan']}"
          f" launch over {cdq_sizes} anchors, chain_scan_event "
          f"{got['chain_scan_event']} launches over {scan_sizes} anchors; "
          f"launches {json.dumps(got)} ({card})", flush=True)

    # the CDQ values against the native engine, at full size
    for args, dev_out in cdq_calls:
        nat, nat_ms = wall_ms(lambda: chain_affine_cdq(*args))
        dp, bp, tie, strct, stored, qs = dev_out
        untied = nat[2] == 0
        require(all(np.array_equal(a, b) for a, b in zip(
            (nat[0], nat[2], nat[3], nat[4], nat[5]),
            (dp, tie, strct, stored, qs)))
            and np.array_equal(nat[1][untied], bp[untied]),
            "the CDQ scan's values differ from the native engine's")
        n = len(args[0])
        _, arrays = chain_cdq.pack([args], n)
        # the host schedule alone, on the sorted rows pack made it from
        t0 = time.perf_counter()
        chain_cdq.level_steps(0, arrays[1][0, :, 0], arrays[0][0, :, 0])
        sched_ms = (time.perf_counter() - t0) * 1e3
        t = [torch.from_numpy(a).to(device) for a in arrays]
        res, ms = timed(lambda: cc.cdq_scan(*t, anchors=n), 3)
        want, pms = wall_ms(lambda: chain_cdq.cdq_scan_plain(*t))
        errs["chain_cdq_scan"] = max(errs["chain_cdq_scan"],
                                     max_err(res, want))
        work, design = Work(), Work()
        barriers = cdq_work([args], arrays, work, design, blocks)
        table["chain_cdq_scan"]["work"].add(work.ops, work.bytes)
        table["chain_cdq_scan"]["design"].add(design.ops, design.bytes)
        table["chain_cdq_scan"]["ms"] += ms
        table["chain_cdq_scan"]["plain_ms"] += pms
        lv = arrays[6]
        n_lv, mean_q, max_q = level_stats(lv[:, 2] - lv[:, 1])
        print(f"chain_cdq_scan on pair.fasta's {n} anchors (prefix "
              f"{int(arrays[5][0])}): dp, tie, struct, stored bit-equal to "
              f"native, bp equal on the {int(untied.sum())} untied; "
              f"{n_lv} levels, {mean_q:.1f} queries a level on average, "
              f"{max_q} at most, {barriers} grid barriers; host schedule "
              f"{sched_ms:.3f} ms; kernel {ms:.3f} ms ({ms / n_lv * 1e3:.3f} "
              f"us a level); native engine {nat_ms:.3f} ms; plain "
              f"{pms:.1f} ms (bit-equal); bound {work.bound()[0]:.6f} ms "
              f"({work.bound()[1]}), the design's {design.bound()[0]:.6f} "
              f"ms ({design.bytes} bytes, {design.ops} operations) "
              f"({card})", flush=True)

    # the free-gap chains against the native parity engine, and the
    # event scan alone on each problem
    for self_, kept, args, chain, dev_s in sparse_calls:
        t0 = time.perf_counter()
        native = parity(self_, kept, *args)
        nat_s = time.perf_counter() - t0
        require(len(native) == len(chain) and all(
            np.array_equal(a.walk1, b.walk1)
            and np.array_equal(a.walk2, b.walk2)
            and (a.count1, a.count2) == (b.count1, b.count2)
            for a, b in zip(native, chain)),
            "a free-gap chain differs from the native parity engine's")
        print(f"free-gap chain of {len(chain)} anchors: identical to the "
              f"native parity engine's; device chaining {dev_s * 1e3:.3f} "
              f"ms, native {nat_s * 1e3:.3f} ms (host wall) ({card})",
              flush=True)
    for args in scan_calls:
        n = len(args[4])
        _, _, ev_np, dp0_np, levels_np = chain_scan.build_events(*args[:6])
        t0 = time.perf_counter()
        chain_scan.event_steps(ev_np, n)
        sched_ms = (time.perf_counter() - t0) * 1e3
        ev = torch.from_numpy(ev_np).to(device)
        dp0 = torch.from_numpy(dp0_np).to(device)
        levels = tuple(torch.from_numpy(a).to(device) for a in levels_np)
        res, ms = timed(lambda: sc.event_scan(ev, dp0, levels, anchors=n), 3)
        want, pms = wall_ms(lambda: chain_scan.event_scan_plain(ev, dp0))
        errs["chain_scan_event"] = max(errs["chain_scan_event"],
                                       max_err(res, want))
        work, design = Work(), Work()
        barriers = scan_work(ev_np, n, levels_np, work, design, blocks)
        table["chain_scan_event"]["work"].add(work.ops, work.bytes)
        table["chain_scan_event"]["design"].add(design.ops, design.bytes)
        table["chain_scan_event"]["ms"] += ms
        table["chain_scan_event"]["plain_ms"] += pms
        steps = levels_np[0]
        n_lv, mean_q, max_q = level_stats(steps[:, 1] - steps[:, 0])
        print(f"chain_scan_event on {n} anchors ({len(ev_np)} events): "
              f"{n_lv} levels, {mean_q:.1f} queries a level on average, "
              f"{max_q} at most, {barriers} grid barriers; host schedule "
              f"{sched_ms:.3f} ms; kernel {ms:.3f} ms "
              f"({ms / max(n_lv, 1) * 1e3:.3f} us a level); plain "
              f"{pms:.1f} ms (bit-equal); bound {work.bound()[0]:.6f} ms "
              f"({work.bound()[1]}), the design's {design.bound()[0]:.6f} "
              f"ms ({design.bytes} bytes, {design.ops} operations) "
              f"({card})", flush=True)
    return got


# ---------------------------------------------------------------------------
# the lane-sharded Gotoh (L5)


def shard_inputs(s1, s2, params, shards, swap):
    """fill_shards' arguments for one gap over `shards` lane shards."""
    import numpy as np
    from centrolign_tpu_torch.ops.gotoh import _build_skew_inputs
    from centrolign_tpu_torch.parallel import sharded_gotoh as sh
    V1, V2 = len(s1), len(s2)
    lane_is_i = V1 <= V2
    W = sh._bucket((V1 if lane_is_i else V2) + 1, 128 * shards)
    nd = V1 + V2 + 1
    a, b = _build_skew_inputs(s1, s2, lane_is_i, W, nd + 128)
    return (a[None], b[None], np.array([V1], np.int32),
            np.array([V2], np.int32), params, nd, lane_is_i, swap)


def shard_work(s1, s2, params, shards, work):
    """One sharded fill's work: ops per cell as gotoh_work counts them;
    bytes = the lane and other-side rows, the backpointers and the
    score."""
    V1, V2 = len(s1), len(s2)
    W = -(-(min(V1, V2) + 1) // (128 * shards)) * 128 * shards
    work.add((V1 + 1) * (V2 + 1) * (3 + 18 * params.num_pw),
             4 * (3 * W + V1 + V2 + 129) + 2 * (V1 + V2 + 1) * W + 4)


def compare_sharded(s1, s2, params, devices, swap, reps, plain):
    """The sharded fill over `devices` with the kernel and with its plain
    version on the card: bit-equal scores and backpointers. The plain
    fill's result does not depend on how the lanes are cut
    (tests/test_torch_sharded_gotoh.py), so it runs once per gap and lane
    width, on one shard, and `plain` keeps it for the other shard counts.
    Returns (max_abs_err, kernel ms, plain ms, counts, host ms) of one
    fill (CUDA events around the queued work, the inputs' copy to the card
    included; the gather to the host is outside the time): counts are the
    fill's launches, halo copies and event waits, host ms the host's time
    to queue it."""
    import torch
    from centrolign_tpu_torch.ops import sharded_gotoh_cuda as shg
    from centrolign_tpu_torch.ops.sharded_gotoh import chunk_fill_plain
    from centrolign_tpu_torch.parallel import sharded_gotoh as sh
    a, b, V1, V2, p, nd, lane_is_i, swap = shard_inputs(
        s1, s2, params, len(devices), swap)
    args = (a, b, V1, V2, p, [list(devices)], nd, lane_is_i, swap, True)
    shg.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh.fill_shards(*args)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    got_counts = (shg.LAUNCHES, shg.HALO_COPIES, shg.EVENT_WAITS)
    rows, ms = timed(lambda: sh.fill_shards(*args), reps)
    got = sh.gather(rows)
    key = (id(s1), id(s2), p.num_pw, swap, a.shape[1])
    if key not in plain:
        one = (a, b, V1, V2, p, [[devices[0]]], nd, lane_is_i, swap, True)
        rows_p, pms = wall_ms(lambda: sh.fill_shards(
            *one, chunk=chunk_fill_plain))
        plain[key] = (sh.gather(rows_p), pms)
    want, pms = plain[key]
    err = max_err([torch.from_numpy(got[0]),
                   torch.from_numpy(got[1].view("int16"))],
                  [torch.from_numpy(want[0]),
                   torch.from_numpy(want[1].view("int16"))])
    return err, ms, pms, got_counts, host_ms


def ptxas_report(name):
    """Per kernel variant of csrc/<name>.cu built in this process:
    (template arguments, registers, spill store bytes, spill load bytes),
    from nvcc's -Xptxas -v output."""
    import re
    from centrolign_tpu_torch.ops import _build
    out, entry, spill = [], None, (0, 0)
    for line in _build.build_info.get(name, (0.0, ""))[1].splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"I((?:L[ib]\d+E)+)E", m.group(1))
            entry = (",".join(re.findall(r"L[ib](\d+)E", t.group(1)))
                     if t else m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out.append((entry, int(m.group(1)), *spill))
            entry, spill = None, (0, 0)
    return out


def shard_ptxas_line():
    """The sharded fill's variants (R, npw, A first) with their registers
    and spills, one line."""
    rep = ptxas_report("sharded_gotoh")
    if not rep:
        return "ptxas report not captured (library built before this run)"
    items = ", ".join(f"({e}) {r} regs" + (f" spills {ss}/{sl} B" if ss or sl
                                            else "")
                      for e, r, ss, sl in sorted(rep))
    spills = sum(ss + sl for _, _, ss, sl in rep)
    return (f"ptxas sharded_gotoh_chunk_kernel<R, npw, A first>: {items}; "
            f"{len(rep)} variants, {spills} B of spills in all")


def shard_bag(rng, params, device, card, errs):
    """Phase 3e: the sharded fill on a bag with 1-4 shards on the card
    (and across the cards when there are two or more), against its plain
    version, and the alignment against the single-problem entry (K4)."""
    import numpy as np
    import torch
    from centrolign_tpu_torch.ops import gotoh_cuda as gc
    from centrolign_tpu_torch.ops.align_params import AlignmentParams
    from centrolign_tpu_torch.parallel import sharded_gotoh as sh

    def pair(n1, n2):
        s1 = rng.integers(0, 4, n1).astype(np.int32)
        s2 = (np.resize(s1, n2) if n1 else rng.integers(0, 4, n2)
              ).astype(np.int32)
        if n2:
            s2[rng.integers(0, n2, max(1, n2 // 10))] = rng.integers(0, 4)
        return s1, s2

    def prm(npw):
        return AlignmentParams(params.match, params.mismatch,
                               params.gap_open[:npw], params.gap_extend[:npw])

    bag = [(*pair(n1, n2), prm(npw), swap) for n1, n2, npw, swap in (
        (0, 0, 3, False), (0, 7, 1, True), (5, 0, 2, False),
        (1, 1, 3, True), (3, 200, 2, False), (200, 3, 3, True),
        (700, 640, 1, True), (640, 700, 3, False), (1500, 1300, 2, True),
        (1300, 1500, 3, False))]
    big = (*pair(4500, 4500), params, False)
    layouts = [[device] * n for n in (1, 2, 3, 4)]
    if torch.cuda.device_count() >= 2:
        layouts.append([torch.device("cuda", k)
                        for k in range(torch.cuda.device_count())])
    plain = {}
    for devices in layouts:
        n = len(devices)
        across = len(set(devices)) > 1
        where = f"{n} cards" if across else f"{n} shards on one card"
        tot = [0.0, 0.0, 0, 0, 0]
        work = Work()
        for s1, s2, p, swap in bag:
            err, ms, pms, (launches, copies, waits), _ = compare_sharded(
                s1, s2, p, devices, swap, 2, plain)
            errs["sharded_gotoh_fill"] = max(errs["sharded_gotoh_fill"], err)
            tot = [tot[0] + ms, tot[1] + pms, tot[2] + launches,
                   tot[3] + copies, tot[4] + waits]
            shard_work(s1, s2, p, n, work)
            aln, score = sh.sharded_gotoh_align(s1, s2, p, devices,
                                                swap_pref=swap)
            want, want_score = gc.gotoh_align_device(s1, s2, p, swap,
                                                     device=device)
            require(score == want_score and np.array_equal(aln, want),
                    f"the sharded alignment of {len(s1)} x {len(s2)} over "
                    f"{where} differs from gotoh_align_device")
        print(f"sharded_gotoh_fill bag of {len(bag)} gaps, {where}: "
              f"bit-equal to the plain version, alignments equal to "
              f"gotoh_align_device; kernel {tot[0]:.3f} ms, {tot[2]} "
              f"launches, {tot[3]} halo copies, {tot[4]} event waits; plain "
              f"{tot[1]:.1f} ms (one "
              f"shard, once per gap and width); bound "
              f"{work.bound()[0]:.6f} ms ({card})", flush=True)
        s1, s2, p, swap = big
        err, ms, pms, (launches, copies, waits), host = compare_sharded(
            s1, s2, p, devices, swap, 2, plain)
        errs["sharded_gotoh_fill"] = max(errs["sharded_gotoh_fill"], err)
        aln, score = sh.sharded_gotoh_align(s1, s2, p, devices)
        want, want_score = gc.gotoh_align_device(s1, s2, p, swap,
                                                 device=device)
        require(score == want_score and np.array_equal(aln, want),
                f"the sharded alignment of 4500 x 4500 over {where} differs "
                f"from gotoh_align_device")
        work = Work()
        shard_work(s1, s2, p, n, work)
        print(f"sharded_gotoh_fill 4500 x 4500 (20.25M cells), {where}: "
              f"bit-equal, alignment and score {score} equal to "
              f"gotoh_align_device; kernel {ms:.3f} ms over {launches} "
              f"launches ({ms / (len(s1) + len(s2) + 1) * 1e3:.3f} us a "
              f"diagonal), {copies} halo copies, {waits} event waits, "
              f"{host:.3f} ms to queue; plain {pms:.1f} ms (one shard); bound "
              f"{work.bound()[0]:.6f} ms ({card})", flush=True)
    print(shard_ptxas_line(), flush=True)


def shard_sweep(rng, params, device, card):
    """Phase 3f: the sharded fill at a 4356 x 3330 and a 4,500 x 4,500 gap
    over 1, 2 and 4 shards of the card, for a few chunk lengths and block
    widths (parallel/sharded_gotoh.py's HALO and BLOCK_LANES, the module's
    marked), each bit-equal to the fill at the module's: the time a fill
    and a diagonal, where the choice of the two constants comes from."""
    import numpy as np
    import torch
    from centrolign_tpu_torch.ops import sharded_gotoh_cuda as shg
    from centrolign_tpu_torch.parallel import sharded_gotoh as sh
    gaps = []
    for n1, n2 in ((4356, 3330), (4500, 4500)):
        s1 = rng.integers(0, 4, n1).astype(np.int32)
        s2 = np.resize(s1, n2).astype(np.int32)
        s2[rng.integers(0, n2, n2 // 10)] = rng.integers(0, 4)
        gaps.append((s1, s2))
    chosen = (sh.HALO, sh.BLOCK_LANES)
    try:
        for s1, s2 in gaps:
            for shards in (1, 2, 4):
                a, b, V1, V2, p, nd, lii, swap = shard_inputs(
                    s1, s2, params, shards, False)
                args = (a, b, V1, V2, p, [[device] * shards], nd, lii, swap,
                        True)
                sh.HALO, sh.BLOCK_LANES = chosen
                want = sh.gather(sh.fill_shards(*args))
                line = []
                for halo, lanes in ((64, 128), (128, 128), (128, 256),
                                    (256, 512)):
                    sh.HALO, sh.BLOCK_LANES = halo, lanes
                    shg.reset_counters()
                    rows, ms = timed(lambda: sh.fill_shards(*args), 3)
                    got = sh.gather(rows)
                    require(np.array_equal(got[0], want[0]) and
                            np.array_equal(got[1], want[1]),
                            f"the sharded fill at HALO {halo}, BLOCK_LANES "
                            f"{lanes} differs from the module's")
                    mark = "*" if (halo, lanes) == chosen else ""
                    line.append(f"{halo}/{lanes}{mark} {ms:.3f} ms "
                                f"({ms / nd * 1e3:.3f} us a diagonal, "
                                f"{shg.LAUNCHES // 4} launches)")
                print(f"sharded_gotoh_fill {len(s1)} x {len(s2)}, {shards} "
                      f"shards on the card, by HALO/BLOCK_LANES: "
                      + "; ".join(line) + f" ({card})", flush=True)
    finally:
        sh.HALO, sh.BLOCK_LANES = chosen
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# paths


def run_shard_tier(device, card, table, errs):
    """Phase 4b: pair.fasta with the sequence-parallel tier on two shards
    of the card (CENTROLIGN_TPU_SHARD_MIN_CELLS=14000000,
    CENTROLIGN_TORCH_SHARD_DEVICES=cuda:0,cuda:0). Checks the CIGAR, the
    tier's gap and the kernel's launches, then times the kernel at that gap
    against its plain version. Returns the path's counts."""
    from centrolign_tpu_torch import metrics
    from centrolign_tpu_torch.parallel import sharded_gotoh as sh_mod

    calls = []
    align = sh_mod.sharded_gotoh_align

    def recording_align(s1, s2, p, mesh, swap_pref=False):
        calls.append((s1, s2, p, list(mesh), swap_pref))
        return align(s1, s2, p, mesh, swap_pref=swap_pref)

    sh_mod.sharded_gotoh_align = recording_align
    os.environ["CENTROLIGN_TPU_SHARD_MIN_CELLS"] = SHARD_MIN_CELLS
    os.environ["CENTROLIGN_TORCH_SHARD_DEVICES"] = f"{device},{device}"
    try:
        reset_counts()
        rc, out, wall = run_cli(["-v", "0", PAIR])
        got = counts()
    finally:
        sh_mod.sharded_gotoh_align = align
        os.environ.pop("CENTROLIGN_TPU_SHARD_MIN_CELLS")
        os.environ.pop("CENTROLIGN_TORCH_SHARD_DEVICES")
    require(rc == 0, f"cli.main returned {rc} on pair.fasta with the "
            "sequence-parallel tier")
    with open(REF_CIGAR) as f:
        require(out == f.read(), "pair.fasta CIGAR through the "
                "sequence-parallel tier differs from "
                "benchdata/ref_pair.cigar.txt")
    posh = metrics.counters.get("posh", [0, 0, 0.0])
    require(posh[0] == PAIR_SHARD_GAPS and len(calls) == PAIR_SHARD_GAPS
            and got["sharded_gotoh_fill"] > 0,
            f"the sequence-parallel tier took {posh[0]} gaps with "
            f"{got['sharded_gotoh_fill']} launches, want {PAIR_SHARD_GAPS} "
            f"gap and launches")
    print(f"pair.fasta through the sequence-parallel tier (2 shards on "
          f"the card): CIGAR byte-identical to the reference; wall "
          f"{wall:.3f} s; posh {posh[0]} gap, {posh[1]} cells, "
          f"{posh[2] * 1e3:.3f} ms on the host clock (fill, gather and "
          f"host traceback); launches {json.dumps(got)} ({card})",
          flush=True)
    row = table["sharded_gotoh_fill"]
    for s1, s2, p, mesh, swap in calls:
        fill_ms, gather_ms, tb_ms = posh_split(s1, s2, p, mesh, swap)
        print(f"posh on pair.fasta's {len(s1)} x {len(s2)} gap, split: fill "
              f"{fill_ms:.3f} ms (queued and run to its end), gather "
              f"{gather_ms:.3f} ms (scores and backpointers to the host), "
              f"host traceback {tb_ms:.3f} ms ({card})", flush=True)
        err, ms, pms, (launches, copies, waits), host = compare_sharded(
            s1, s2, p, mesh, swap, 3, {})
        errs["sharded_gotoh_fill"] = max(errs["sharded_gotoh_fill"], err)
        shard_work(s1, s2, p, len(mesh), row["work"])
        row["ms"] += ms
        row["plain_ms"] += pms
        print(f"sharded_gotoh_fill on pair.fasta's {len(s1)} x {len(s2)} "
              f"gap, {len(mesh)} shards on the card: bit-equal; kernel "
              f"{ms:.3f} ms over {launches} launches "
              f"({ms / (len(s1) + len(s2) + 1) * 1e3:.3f} us a diagonal), "
              f"{copies} halo copies, {waits} event waits, {host:.3f} ms to "
              f"queue; plain {pms:.1f} ms (one shard); bound "
              f"{row['work'].bound()[0]:.6f} ms ({card})", flush=True)
    print(shard_ptxas_line(), flush=True)
    return got


def posh_split(s1, s2, params, mesh, swap):
    """The tier's work on one gap, as sharded_gotoh_align does it, timed
    in three parts on the host clock: the fill queued and run to its end,
    the gather to the host, the host traceback (ms each)."""
    import torch
    from centrolign_tpu_torch.ops.gotoh import _traceback_bp
    from centrolign_tpu_torch.parallel import sharded_gotoh as sh
    a, b, V1, V2, p, nd, lane_is_i, swap = shard_inputs(
        s1, s2, params, len(mesh), swap)
    rows, fill_ms = wall_ms(lambda: sh.fill_shards(
        a, b, V1, V2, p, [list(mesh)], nd, lane_is_i, swap, True))
    t0 = time.perf_counter()
    _, bp = sh.gather(rows)
    gather_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _traceback_bp(bp[:, 0, :], len(s1), len(s2), lane_is_i, p.num_pw)
    tb_ms = (time.perf_counter() - t0) * 1e3
    return fill_ms, gather_ms, tb_ms


def run_executors(device, card, serial_wall, serial_gfa):
    """Phases 9-10: five.fasta with --hosts 2 over the pool executor, then
    over two torch.distributed ranks (CENTROLIGN_TPU_EXECUTOR=jaxdist), on
    the card: the GFA is the reference's, every worker and rank resolved
    the card, their launches came back to this process, no worker was
    recomputed here. Walls beside the serial run's."""
    from centrolign_tpu_torch.parallel import counters as pcounters
    from centrolign_tpu_torch.parallel import multiprocess as mp_mod
    from centrolign_tpu_torch.parallel import scheduler

    with open(REF_GFA) as f:
        ref = f.read()
    require(serial_gfa == ref, "the serial five.fasta GFA is not the "
            "reference")
    argv = ["-v", "0", "--hosts", "2", "-T", FIVE_TREE, FIVE]
    kernels = ("gotoh_cuda.FILL_LAUNCHES", "gotoh_cuda.TRACEBACK_LAUNCHES")

    # 9. the pool executor
    pcounters.MERGED.clear()
    pcounters.DEVICES.clear()
    recovered = scheduler.RECOVERED
    reset_counts()
    rc, out, wall = run_cli(argv)
    got = counts()
    require(rc == 0 and out == ref, "five.fasta with --hosts 2 (pool) gave "
            "another GFA than benchdata/ref_five.gfa")
    workers = {k: pcounters.MERGED.get(k, 0) for k in kernels}
    require(scheduler.RECOVERED == recovered,
            "a pool worker failed and was recomputed in the parent")
    require(pcounters.DEVICES == {str(device)},
            f"pool workers ran on {sorted(map(str, pcounters.DEVICES))}")
    require(all(v > 0 for v in workers.values()),
            f"the pool workers launched {workers}")
    print(f"five.fasta, --hosts 2 (pool, 2 workers on the card): GFA "
          f"byte-identical to the reference; wall {wall:.3f} s (serial "
          f"{serial_wall:.3f} s); workers' launches {json.dumps(workers)}, "
          f"this process's launches {json.dumps(got)}; no worker "
          f"recomputed ({card})",
          flush=True)

    # 10. the torch.distributed executor
    ranks = []
    run_mp = mp_mod.run_multiprocess_msa

    def recording_run(*args, **kw):
        out_ = run_mp(*args, **kw)
        ranks.extend(out_)
        return out_

    mp_mod.run_multiprocess_msa = recording_run
    os.environ["CENTROLIGN_TPU_EXECUTOR"] = "jaxdist"
    try:
        reset_counts()
        rc, out, wall = run_cli(argv)
        got = counts()
    finally:
        mp_mod.run_multiprocess_msa = run_mp
        os.environ.pop("CENTROLIGN_TPU_EXECUTOR")
    require(rc == 0 and out == ref, "five.fasta with jaxdist over 2 ranks "
            "gave another GFA than benchdata/ref_five.gfa")
    require(len(ranks) == 2 and all(r["device"] == str(device)
                                    for r in ranks),
            f"the ranks ran on {[r['device'] for r in ranks]}")
    per_rank = [{k: r[k] for k in kernels} for r in ranks]
    require(sum(r[kernels[0]] for r in ranks) > 0,
            f"the ranks launched {per_rank}")
    print(f"five.fasta, CENTROLIGN_TPU_EXECUTOR=jaxdist --hosts 2 (2 ranks "
          f"on gloo, one card): GFA byte-identical to the reference; wall "
          f"{wall:.3f} s (serial {serial_wall:.3f} s); launches per rank "
          f"{json.dumps(per_rank)}, this process's launches "
          f"{json.dumps(got)} ({card})",
          flush=True)


def run_cli(argv):
    """cli.main(argv) with its standard output captured: (rc, output,
    wall seconds)."""
    import torch
    from centrolign_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    return rc, out.getvalue(), time.perf_counter() - t0


def reset_counts():
    from centrolign_tpu_torch import metrics
    from centrolign_tpu_torch.ops import chain_cdq_cuda as cc
    from centrolign_tpu_torch.ops import chain_scan_cuda as sc
    from centrolign_tpu_torch.ops import gotoh_cuda as gc
    from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc
    from centrolign_tpu_torch.ops import sharded_gotoh_cuda as shg
    metrics.reset()
    for mod in (gc, pdc, cc, sc, shg):
        mod.reset_counters()


def counts():
    from centrolign_tpu_torch.ops import chain_cdq_cuda as cc
    from centrolign_tpu_torch.ops import chain_scan_cuda as sc
    from centrolign_tpu_torch.ops import gotoh_cuda as gc
    from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc
    from centrolign_tpu_torch.ops import sharded_gotoh_cuda as shg
    return {"gotoh_fill": gc.FILL_LAUNCHES,
            "gotoh_traceback": gc.TRACEBACK_LAUNCHES,
            "popoa_dag_fill": pdc.FILL_LAUNCHES,
            "popoa_dag_traceback": pdc.TRACEBACK_LAUNCHES,
            "chain_cdq_scan": cc.LAUNCHES,
            "chain_scan_event": sc.LAUNCHES,
            "chain_jobs": gc.DISPATCHED_JOBS,
            "dag_jobs": pdc.DISPATCHED_JOBS,
            "cdq_anchors": cc.ANCHORS,
            "scan_anchors": sc.ANCHORS,
            "sharded_gotoh_fill": shg.LAUNCHES,
            "halo_copies": shg.HALO_COPIES,
            "event_waits": shg.EVENT_WAITS}


def main() -> int:
    run_t0 = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "centrolign_tpu_torch")):
        print("error: run chip_smoke.py from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    # 1. environment
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    device = torch.device("cuda", 0)
    from centrolign_tpu_torch import metrics
    from centrolign_tpu_torch import stitcher as stitcher_mod
    from centrolign_tpu_torch.device import device_kind
    from centrolign_tpu_torch.ops import _build
    from centrolign_tpu_torch.ops import gotoh as plain_gotoh
    from centrolign_tpu_torch.ops import gotoh_cuda as gc
    from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc
    from centrolign_tpu_torch.ops.align_params import AlignmentParams

    # 2. build
    from centrolign_tpu_torch.ops import chain_cdq_cuda as cc
    from centrolign_tpu_torch.ops import chain_scan_cuda as sc
    from centrolign_tpu_torch.ops import sharded_gotoh_cuda as shg
    t0 = time.perf_counter()
    _build.build_libraries(SOURCES)
    for mod in (gc, pdc, cc, sc, shg):
        mod._lib()
    print(f"build: {', '.join(sorted({src for src, _ in KERNELS.values()}))} "
          f"with nvcc {' '.join(_build.NVCC_FLAGS)} in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    for name in SOURCES:
        for line in _build.build_info.get(name, (0.0, ""))[1].splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    params = AlignmentParams(20, 80, (60, 800, 2500), (30, 5, 1))
    rng = np.random.default_rng(20261016)
    errs = {name: 0 for name in KERNELS}

    # 3. Gotoh kernels on the bag
    bag = make_bag(rng, params)
    res, rows = compare_gotoh(bag, device, reps=3)
    work = {"gotoh_fill": Work(), "gotoh_traceback": Work()}
    gotoh_work(bag, rows, work["gotoh_fill"], work["gotoh_traceback"])
    for name, (err, ms, pms) in res.items():
        print(f"bag of {len(bag)} jobs, {name}: bit-equal, kernel {ms:.3f} "
              f"ms, plain {pms:.1f} ms, bound {work[name].bound()[0]:.6f} ms "
              f"({card})", flush=True)

    # 3b. DAG kernels on their bag
    dag_bag, what = make_dag_bag(rng, params)
    for side in ("t1", "t2"):
        tabs = [getattr(j, side) for j in dag_bag]
        require(max(t.K for t in tabs) == 4 and max(t.S for t in tabs) == 32,
                f"the DAG bag's {side} does not reach in-degree 4 and span 32")
    res, rows = compare_dag(dag_bag, device, reps=3)
    exits = {int(k) for k in rows[:, 0, 1]}
    require({1, 2, 3, 4} <= exits,
            f"the DAG bag's walks left through {sorted(exits)}, want row 1, "
            f"column 2, corner 3 and no alignment 4")
    work = {"popoa_dag_fill": Work(), "popoa_dag_traceback": Work()}
    dag_work(dag_bag, rows, work["popoa_dag_fill"],
             work["popoa_dag_traceback"])
    for name, (err, ms, pms) in res.items():
        print(f"DAG bag of {len(dag_bag)} jobs ({', '.join(what)}), {name}: "
              f"bit-equal, kernel {ms:.3f} ms, plain {pms:.1f} ms, bound "
              f"{work[name].bound()[0]:.6f} ms ({card})", flush=True)

    # 3c. the single-problem entry on three pairs
    for L1, L2 in ((300, 500), (2000, 1500), (4500, 5200)):
        s1 = rng.integers(0, 4, L1).astype(np.int32)
        s2 = np.resize(s1, L2).astype(np.int32)
        s2[rng.integers(0, L2, L2 // 10)] = rng.integers(0, 4)
        job = (s1, s2, L1 > L2, params)
        err, ms, pms, _ = compare_single(job, device, reps=2)
        print(f"gotoh_align_device {L1} x {L2}: bit-equal, kernel {ms:.3f} "
              f"ms, plain {pms:.1f} ms ({card})", flush=True)

    # 3d. the device-chaining kernels on their bag
    chain_bag = chaining_bag(rng, device, card, errs)
    for name, (ms, pms, w, design) in chain_bag.items():
        print(f"chaining bag, {name}: bit-equal, kernel {ms:.3f} ms, plain "
              f"{pms:.1f} ms, bound {w.bound()[0]:.6f} ms (the function's "
              f"work), {design.bound()[0]:.6f} ms (this design's work) "
              f"({card})", flush=True)

    # 3e. the lane-sharded Gotoh on its bag, 1-4 shards on the card
    shard_bag(rng, params, device, card, errs)
    # 3f. its chunk length and block width
    shard_sweep(rng, params, device, card)

    # 4. the pairwise path
    dispatched, dag_dispatched = [], []
    dispatch, dag_batch = stitcher_mod.gotoh_dispatch, \
        stitcher_mod.popoa_dag_batch

    def recording_dispatch(jobs, dev):
        dispatched.append(list(jobs))
        return dispatch(jobs, dev)

    def recording_dag_batch(jobs, dev):
        dag_dispatched.append(list(jobs))
        return dag_batch(jobs, dev)

    stitcher_mod.gotoh_dispatch = recording_dispatch
    stitcher_mod.popoa_dag_batch = recording_dag_batch
    os.environ["CENTROLIGN_TORCH_DEVICE"] = "cuda"
    os.environ.pop("CENTROLIGN_TORCH_DEVICE_MIN_CELLS", None)
    os.environ.pop("CENTROLIGN_TORCH_DEVICE_DAG", None)
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    rc, out, wall = run_cli(["-v", "0", PAIR])
    pair_counts = counts()
    require(rc == 0, f"cli.main returned {rc} on pair.fasta")
    with open(REF_CIGAR) as f:
        require(out == f.read(),
                "pair.fasta CIGAR differs from benchdata/ref_pair.cigar.txt")
    pod = metrics.counters.get("pod", [0, 0, 0.0])
    require(pair_counts["gotoh_fill"] > 0 and pair_counts["gotoh_traceback"] > 0,
            f"pairwise path launched {pair_counts}")
    require(pair_counts["chain_jobs"] == PAIR_GAPS and pod[1] == PAIR_CELLS,
            f"device tier took {pair_counts['chain_jobs']} gaps / {pod[1]} "
            f"cells, want {PAIR_GAPS} / {PAIR_CELLS}")
    print(f"pair.fasta: CIGAR byte-identical to the reference; wall "
          f"{wall:.3f} s; device tier {pair_counts['chain_jobs']} gaps, "
          f"{pod[1]} cells in {len(dispatched)} dispatches; launches "
          f"{json.dumps(pair_counts)}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(device)} B ({card})", flush=True)
    print("pair.fasta aligner counters: " + json.dumps(metrics.summary()),
          flush=True)

    table = {name: {"ms": 0.0, "plain_ms": 0.0, "work": Work(),
                    "design": Work()}
             for name in KERNELS}
    here = compare_path_gotoh(dispatched, pair_counts["gotoh_fill"], device,
                              table, errs)
    for name, (ms, pms) in here.items():
        print(f"pair.fasta jobs, {name}: bit-equal, kernel {ms:.3f} ms, "
              f"plain {pms:.1f} ms over {len(dispatched)} dispatches "
              f"({card})", flush=True)

    # 4b. pair.fasta through the sequence-parallel tier, two shards on the
    # card: only the 4356 x 3330 gap is over its threshold
    shard_counts = run_shard_tier(device, card, table, errs)

    # 5. the MSA path
    dispatched.clear()
    os.environ["CENTROLIGN_TORCH_DEVICE_DAG"] = "1"
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    rc, out, wall = run_cli(["-v", "0", "-T", FIVE_TREE, FIVE])
    five_counts = counts()
    os.environ.pop("CENTROLIGN_TORCH_DEVICE_DAG")
    stitcher_mod.gotoh_dispatch = dispatch
    stitcher_mod.popoa_dag_batch = dag_batch
    require(rc == 0, f"cli.main returned {rc} on five.fasta")
    with open(REF_GFA) as f:
        require(out == f.read(),
                "five.fasta GFA differs from benchdata/ref_five.gfa")
    require(all(five_counts[k] > 0 for k in (
        "gotoh_fill", "gotoh_traceback", "popoa_dag_fill",
        "popoa_dag_traceback")), f"MSA path launched {five_counts}")
    podag = metrics.counters.get("podag", [0, 0, 0.0])
    pod = metrics.counters.get("pod", [0, 0, 0.0])
    require(five_counts["dag_jobs"] == FIVE_DAG_JOBS
            and podag[1] == FIVE_DAG_CELLS,
            f"DAG tier took {five_counts['dag_jobs']} jobs / {podag[1]} "
            f"cells, want {FIVE_DAG_JOBS} / {FIVE_DAG_CELLS}")
    require(five_counts["chain_jobs"] == FIVE_CHAIN_JOBS
            and pod[1] == FIVE_CHAIN_CELLS,
            f"chain tier took {five_counts['chain_jobs']} jobs / {pod[1]} "
            f"cells, want {FIVE_CHAIN_JOBS} / {FIVE_CHAIN_CELLS}")
    print(f"five.fasta: GFA byte-identical to the reference; wall "
          f"{wall:.3f} s; DAG tier {five_counts['dag_jobs']} jobs, "
          f"{podag[1]} cells in {len(dag_dispatched)} flushes; chain tier "
          f"{five_counts['chain_jobs']} jobs, {pod[1]} cells; launches "
          f"{json.dumps(five_counts)}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(device)} B ({card})", flush=True)
    five_summary = metrics.summary()
    print("five.fasta aligner counters: " + json.dumps(five_summary),
          flush=True)
    longest = (None, -1)  # five.fasta's longest walk: (job, steps)
    dag_launches = [g for flush in dag_dispatched
                    for g in pdc.launch_groups(flush)]
    for part in dag_launches:
        res, rows = compare_dag(part, device, reps=5)
        k = int(rows[:, 0, 0].argmax())
        if rows[k, 0, 0] > longest[1]:
            longest = (part[k], int(rows[k, 0, 0]))
        dag_work(part, rows, table["popoa_dag_fill"]["work"],
                 table["popoa_dag_traceback"]["work"])
        for name, (err, ms, pms) in res.items():
            table[name]["ms"] += ms
            table[name]["plain_ms"] += pms
            errs[name] = max(errs[name], err)
        # the launch's time per diagonal of its largest job (the most
        # cells), which sets the launch's time
        big = max(part, key=lambda j: j.cells)
        diags = big.t1.V + big.t2.V - 1
        fill_ms = res["popoa_dag_fill"][1]
        print(f"five.fasta DAG fill launch of {len(part)} jobs: "
              f"{fill_ms:.3f} ms; largest job {big.t1.V} x {big.t2.V} "
              f"(K {big.t1.K}/{big.t2.K}, S {big.t1.S}/{big.t2.S}), {diags} "
              f"diagonals, {fill_ms / diags * 1e3:.3f} us a diagonal step "
              f"({card})", flush=True)
    for name in ("popoa_dag_fill", "popoa_dag_traceback"):
        k = table[name]
        print(f"five.fasta DAG jobs, {name}: bit-equal, kernel "
              f"{k['ms']:.3f} ms, plain {k['plain_ms']:.1f} ms, bound "
              f"{k['work'].bound()[0]:.6f} ms over {len(dag_launches)} "
              f"launches ({card})", flush=True)
    here = compare_path_gotoh(dispatched, five_counts["gotoh_fill"], device,
                              table, errs)
    for name, (ms, pms) in here.items():
        print(f"five.fasta chain jobs, {name}: bit-equal, kernel {ms:.3f} "
              f"ms, plain {pms:.1f} ms over {len(dispatched)} dispatches "
              f"({card})", flush=True)
    for name in ("gotoh_fill", "gotoh_traceback"):
        k = table[name]
        print(f"pair.fasta + five.fasta jobs, {name}: kernel {k['ms']:.3f} "
              f"ms, plain {k['plain_ms']:.1f} ms, bound "
              f"{k['work'].bound()[0]:.6f} ms ({card})", flush=True)

    # 5b. the same MSA with the DAG tier off, for its end-to-end effect
    reset_counts()
    rc, out_off, wall_off = run_cli(["-v", "0", "-T", FIVE_TREE, FIVE])
    require(rc == 0 and out_off == out, "five.fasta without the DAG tier "
            "gave another GFA")
    po_off = metrics.counters.get("po", [0, 0, 0.0])
    po_on = five_summary["po"]
    print(f"five.fasta, DAG tier off: wall {wall_off:.3f} s (on: {wall:.3f} "
          f"s); host po {po_off[0]} gaps, {po_off[1]} cells, "
          f"{po_off[2]:.4f} s (on: {po_on['count']} gaps, {po_on['cells']} "
          f"cells, {po_on['seconds']:.4f} s) ({card})", flush=True)

    # 6. the single-problem entry on a pair.fasta-sized gap
    from centrolign_tpu_torch.io.fasta import parse_fasta
    from centrolign_tpu_torch.utils.encoding import encode_seq
    with open(PAIR) as f:
        (_, a), (_, b) = parse_fasta(f)[:2]
    job = (encode_seq(a[:4356]).astype(np.int32),
           encode_seq(b[:3330]).astype(np.int32), False, params)
    reset_counts()
    aln, score = gc.gotoh_align_device(job[0], job[1], job[3], job[2],
                                       device=device)
    single_counts = counts()
    require(single_counts["gotoh_fill"] == 1
            and single_counts["gotoh_traceback"] == 1,
            f"the single-problem entry launched {single_counts}")
    err, ms, pms, steps = compare_single(job, device, reps=3)
    single_work(job, steps, table["gotoh_align_single"]["work"])
    table["gotoh_align_single"].update(ms=ms, plain_ms=pms)
    errs["gotoh_align_single"] = err
    print(f"gotoh_align_device on pair.fasta's first 4356 x 3330 bases: "
          f"score {score}, {len(aln)} pairs, bit-equal; kernel {ms:.3f} ms, "
          f"plain {pms:.1f} ms ({card})", flush=True)
    # the traceback alone on that gap: one warp's walk, step by step
    gtab = gc.params_table([job]).to(device)
    bp_size, plan, cap = gc.launch_sizes([job])
    bp_g, sc_g = gc.gotoh_fill(gtab, gc.pack_seqs([job]).to(device), bp_size,
                               plan)
    rows_g, tb_ms = timed(lambda: gc.gotoh_traceback(bp_g, sc_g, gtab, cap),
                          20)
    require(torch.equal(rows_g, plain_gotoh.gotoh_traceback_plain(
        bp_g, sc_g, gtab, cap)), "the traceback of 4356 x 3330 differs from "
        "the host walk")
    tb_steps = int(rows_g[0, 0, 0])
    print(f"gotoh_traceback on the 4356 x 3330 gap: bit-equal; {tb_ms:.3f} "
          f"ms over {tb_steps} steps, {tb_ms / tb_steps * 1e3:.4f} us a step "
          f"({card})", flush=True)

    # 6b. the fill alone, one block against a cluster, on the 4356 x 3330
    # gap and on narrower gaps of the same length
    seq_a = job[0]
    sweep = []
    for short in (3330, 2048, 1536, 1024, 768, 512, 256, 128, 64):
        gap = [(seq_a, encode_seq(b[:short]).astype(np.int32), False, params)]
        shapes = [(len(seq_a), short)]
        gtab = gc.params_table(gap).to(device)
        gseq = gc.pack_seqs(gap).to(device)
        bp_size = gc.launch_sizes(gap)[0]
        res = {}
        for C, min_lanes in ((1, 10 ** 9), (gc.CLUSTER, 0)):
            plan = gc.fill_plan(shapes, min_lanes)
            require(plan.cluster == C, f"plan for C = {C} has {plan.cluster}")
            (bp_c, sc_c), ms = timed(
                lambda: gc.gotoh_fill(gtab, gseq, bp_size, plan), 5)
            nwj, G = int(plan.blocks[0, 3]), int(plan.blocks[0, 2])
            # one step per diagonal, plus the warps' lag behind each other
            steps = (len(seq_a) + short + 1
                     + (G * nwj - 1) * (gc.FILL_CHUNK - 1))
            res[C] = (bp_c.view(torch.int16), sc_c, ms, steps)
        require(torch.equal(res[1][0], res[gc.CLUSTER][0])
                and torch.equal(res[1][1], res[gc.CLUSTER][1]),
                f"the fill of 4356 x {short} differs between C = 1 and C = "
                f"{gc.CLUSTER}")
        if short == 3330:
            bp_p, sc_p = plain_gotoh.gotoh_fill_plain(gtab, gseq)
            require(torch.equal(res[1][0], bp_p.view(torch.int16))
                    and torch.equal(res[1][1], sc_p),
                    "the fill of 4356 x 3330 differs from the plain fill")
        w = Work()
        w.add((len(seq_a) + 1) * (short + 1) * (3 + 18 * params.num_pw),
              64 + 4 * (len(seq_a) + short)
              + 2 * (len(seq_a) + short + 1) * (short + 1) + 4)
        bound = w.bound()[0]
        sweep.append((short, res[1][2], res[gc.CLUSTER][2]))
        print(f"fill 4356 x {short}: bit-equal at C = 1 and C = "
              f"{gc.CLUSTER}; C = 1 {res[1][2]:.3f} ms over {res[1][3]} "
              f"diagonal steps ({res[1][2] / res[1][3] * 1e3:.3f} us a step, "
              f"{bound / res[1][2]:.2%} of the bound); C = {gc.CLUSTER} "
              f"{res[gc.CLUSTER][2]:.3f} ms over {res[gc.CLUSTER][3]} steps "
              f"({res[gc.CLUSTER][2] / res[gc.CLUSTER][3] * 1e3:.3f} us a "
              f"step, {bound / res[gc.CLUSTER][2]:.2%} of the bound); bound "
              f"{bound:.6f} ms ({card})", flush=True)
    faster = [s_ for s_, ms1, msc in sweep if msc < ms1]
    print(f"cluster split faster at short sides {sorted(faster)}; "
          f"CLUSTER_MIN_LANES = {gc.CLUSTER_MIN_LANES}", flush=True)

    # 6c. the DAG traceback alone on the bag's 2400 x 2400 job and on
    # five.fasta's longest walk: one block's walk, step by step
    from centrolign_tpu_torch.ops import popoa_dag as plain_dag
    big = next(j for j in dag_bag if j.t1.V == j.t2.V == 2400)
    for label, job in (("the DAG bag's 2400 x 2400 job", big),
                       ("five.fasta's longest walk", longest[0])):
        dtab, ddata, (bp_size, sm_size, scratch, smem, cap, lanes) = \
            pdc.dag_launch([job], device)
        bp_d, sm_d = pdc.popoa_dag_fill(dtab, ddata, bp_size, sm_size,
                                        scratch, smem, lanes)
        rows_d, tb_ms = timed(lambda: pdc.popoa_dag_traceback(
            bp_d, sm_d, dtab, ddata, cap), 20)
        require(torch.equal(rows_d, plain_dag.popoa_dag_traceback_plain(
            bp_d, sm_d, dtab, ddata, cap)), f"the DAG traceback of {label} "
            f"differs from the host walk")
        tb_steps = int(rows_d[0, 0, 0])
        print(f"popoa_dag_traceback on {label} ({job.t1.V} x {job.t2.V}): "
              f"bit-equal; {tb_ms:.3f} ms over {tb_steps} steps, "
              f"{tb_ms / tb_steps * 1e3:.4f} us a step ({card})", flush=True)

    # 7. device tier against host po on the gaps below device_min_cells
    from centrolign_tpu_torch.graph import BaseGraph
    from centrolign_tpu_torch.native import popoa_align

    dispatched.clear()
    stitcher_mod.gotoh_dispatch = recording_dispatch
    os.environ["CENTROLIGN_TORCH_DEVICE_MIN_CELLS"] = "10000"
    reset_counts()
    rc, out, _ = run_cli(["-v", "0", PAIR])
    os.environ.pop("CENTROLIGN_TORCH_DEVICE_MIN_CELLS")
    stitcher_mod.gotoh_dispatch = dispatch
    require(rc == 0, f"cli.main returned {rc} on pair.fasta at 10,000 cells")
    with open(REF_CIGAR) as f:
        require(out == f.read(), "pair.fasta CIGAR at a 10,000-cell "
                "threshold differs from benchdata/ref_pair.cigar.txt")
    below = [j for jobs in dispatched for j in jobs
             if len(j[0]) * len(j[1]) < 160_000]

    def chain(seq):
        g = BaseGraph()
        ids = g.add_nodes(seq)
        g.add_edges(ids[:-1], ids[1:])
        return g

    gc.gotoh_align_batched(below[:1], device)  # warm
    for lo, hi in ((10_000, 20_000), (20_000, 40_000), (40_000, 80_000),
                   (80_000, 120_000), (120_000, 160_000)):
        part = [j for j in below if lo <= len(j[0]) * len(j[1]) < hi]
        if not part:
            continue
        cells = sum((len(s1) + 1) * (len(s2) + 1) for s1, s2, _, _ in part)
        host_s = 0.0
        host_scores = []
        for s1, s2, _, p in part:
            g1, g2 = chain(s1), chain(s2)
            t0 = time.perf_counter()
            _, sc = popoa_align(g1, g2, [0], [0], [len(s1) - 1],
                                [len(s2) - 1], p)
            host_s += time.perf_counter() - t0
            host_scores.append(int(sc))
        dev, dev_ms = wall_ms(lambda: gc.gotoh_align_batched(part, device))
        require([int(sc) for _, sc in dev] == host_scores,
                "device tier and host po disagree on a score")
        print(f"gaps of {lo}-{hi} cells on pair.fasta: {len(part)} gaps, "
              f"{cells} cells; host po {host_s * 1e3:.3f} ms "
              f"({host_s * 1e3 / len(part):.3f} ms a gap); one device "
              f"dispatch + fetch {dev_ms:.3f} ms ({card})", flush=True)

    # 8. the pairwise path with device chaining
    chain_counts = run_chaining_path(device, card, table, errs)
    for name in ("chain_cdq_scan", "chain_scan_event"):
        k = table[name]
        print(f"pair.fasta chaining problems, {name}: kernel {k['ms']:.3f} "
              f"ms over {chain_counts[name]} launches, plain "
              f"{k['plain_ms']:.1f} ms, bound {k['work'].bound()[0]:.6f} ms "
              f"({k['work'].bound()[1]}; the function's work), "
              f"{k['design'].bound()[0]:.6f} ms ({k['design'].bound()[1]}; "
              f"this design's work), library none ({card})", flush=True)

    # 9-10. five.fasta over two pool workers and over two torch.distributed
    # ranks on the card, beside the serial run of 5b (the same settings)
    run_executors(device, card, wall_off, out_off)

    # the end: no jax, nothing of the JAX package, in this process or in
    # any worker or rank
    from centrolign_tpu_torch.parallel import counters as pcounters
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "centrolign_tpu" or m.startswith("centrolign_tpu."))
    leaked += sorted(pcounters.FOREIGN)
    require(not leaked, f"modules of jax or the JAX package were imported: "
            f"{leaked[:5]}")

    launches = {**{k: pair_counts[k] + five_counts[k]
                   for k in ("gotoh_fill", "gotoh_traceback")},
                "popoa_dag_fill": five_counts["popoa_dag_fill"],
                "popoa_dag_traceback": five_counts["popoa_dag_traceback"],
                "gotoh_align_single": single_counts["gotoh_fill"],
                "chain_cdq_scan": chain_counts["chain_cdq_scan"],
                "chain_scan_event": chain_counts["chain_scan_event"],
                "sharded_gotoh_fill": shard_counts["sharded_gotoh_fill"]}
    rows = []
    for name, (source, replaces) in KERNELS.items():
        k = table[name]
        bound_ms, bound_by = k["work"].bound()
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    print(f"chip_smoke ran {time.perf_counter() - run_t0:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind(device),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

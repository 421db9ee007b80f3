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
   jobs in one launch, the 4356 x 3330 gap and short sides over 4096:
   bit-equal backpointers, scores and traceback rows (tolerance: exact,
   integer DP);
3b. the DAG x DAG kernels against their plain versions on a bag covering
   in-degree up to 4 and span up to 32 on both sides, npw 1-3, several
   sources and sinks, walks that leave through the boundary row, the
   boundary column and the corner, a job with no interior alignment, a job
   whose state is in global scratch, more than 8 jobs in one launch and the
   largest five.fasta shape (1268 x 242): bit-equal backpointers, sink M and
   traceback rows (exact);
3c. the single-problem Gotoh entry against its plain version on three
   pairs, one with a short side over 4096 (exact);
4. the pairwise path: the port's CLI on benchdata/pair.fasta; the CIGAR
   must equal benchdata/ref_pair.cigar.txt byte for byte, both Gotoh
   kernels must have launched, and the device tier must have taken 28 gaps
   of 24,191,366 DP cells; then the Gotoh kernels are timed against their
   plain versions on the jobs this path dispatched;
5. the MSA path: the port's CLI on benchdata/five.fasta with five.nwk and
   CENTROLIGN_TORCH_DEVICE_DAG=1; the GFA must equal benchdata/ref_five.gfa
   byte for byte, all four kernels must have launched, the DAG tier must
   have taken 12 jobs of 2,731,723 cells and the chain tier 88 jobs of
   21,645,992 cells; then the DAG kernels and the Gotoh kernels are held
   and timed against their plain versions on the jobs this path
   dispatched;
5b. the MSA path again with the DAG tier off: the same GFA, and its wall
   and host `po` time beside the first run's;
6. the single-problem entry on a pair.fasta-sized gap (4356 x 3330), timed
   against its plain version;
and at the end neither jax nor any module of the JAX package may be in the
process. Each path runs with the launch counters set to 0 just before it
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
# the TPU kernels (and lax device loops) these replace
KERNELS = {
    "gotoh_fill": (GOTOH_SRC, "centrolign_tpu/ops/gotoh_pallas.py:602"),
    "gotoh_traceback": (GOTOH_SRC, "centrolign_tpu/ops/gotoh_pallas.py:652"),
    "gotoh_align_single": (GOTOH_SRC,
                           "centrolign_tpu/ops/gotoh_pallas.py:177"),
    "popoa_dag_fill": (DAG_SRC, "centrolign_tpu/ops/popoa_dag.py:173"),
    "popoa_dag_traceback": (DAG_SRC, "centrolign_tpu/ops/popoa_dag.py:376"),
}
PAIR_GAPS, PAIR_CELLS = 28, 24_191_366
FIVE_DAG_JOBS, FIVE_DAG_CELLS = 12, 2_731_723
FIVE_CHAIN_JOBS, FIVE_CHAIN_CELLS = 88, 21_645_992
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
    regime (short side > 4096) and every option of the recurrence."""
    import numpy as np

    def job(L1, L2, swp, npw):
        s1 = rng.integers(0, 4, L1).astype(np.int32)
        s2 = s1[:min(L1, L2)].copy()
        if L2 > len(s2):
            s2 = np.concatenate(
                [s2, rng.integers(0, 4, L2 - len(s2)).astype(np.int32)])
        idx = rng.integers(0, L2, max(1, L2 // 10))
        s2[idx] = (s2[idx] + 1) % 4
        return (s1, s2, swp, params.truncated(npw))

    bag = [job(int(rng.integers(141, 700)), int(rng.integers(141, 700)),
               bool(k % 2), 1 + k % 3) for k in range(12)]
    bag += [job(4356, 3330, False, 3), job(3330, 4356, True, 2),
            job(4500, 5200, False, 3), job(5300, 4200, True, 2)]
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
    bp_size, max_w, cap = gc.launch_sizes(jobs)
    (bp_k, sc_k), fill_ms = timed(
        lambda: gc.gotoh_fill(table, seqs, bp_size, max_w), reps)
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


def make_dag_bag(rng, params):
    """(jobs, what) for the DAG kernels: prepared _DagJobs and a label for
    each (see the module docstring, phase 3b)."""
    import numpy as np
    from centrolign_tpu_torch.ops.popoa_dag import _DagJob

    def ends(g):
        return (np.flatnonzero(g.in_degrees() == 0),
                np.flatnonzero(g.out_degrees() == 0))

    def job(g1, g2, npw, src1=None, snk1=None):
        """A prepared job, or None outside the envelope (a span can grow
        past S when the topological order interleaves branches)."""
        s1, k1 = ends(g1)
        s2, k2 = ends(g2)
        j = _DagJob(g1, g2, s1 if src1 is None else src1, s2,
                    k1 if snk1 is None else snk1, k2, params.truncated(npw))
        if not j.eligible:
            return None
        j.prepare()
        return j

    def related(V, K, S, lead1, lead2, npw, n_src=1, n_sink=1):
        """Two graphs over mutated copies of one sequence, graph 1 with
        `lead1` extra leading nodes and graph 2 with `lead2`: the walk
        leaves through the column, the row or the corner."""
        for _ in range(20):
            base = rng.integers(0, 4, V)
            lab2 = base.copy()
            flip = rng.random(V) < 0.05
            lab2[flip] = (lab2[flip] + 1) % 4
            lab1 = np.concatenate([rng.integers(0, 4, lead1), base])
            lab2 = np.concatenate([rng.integers(0, 4, lead2), lab2])
            j = job(dag_graph(rng, len(lab1), K, S, n_src, n_sink, lab1),
                    dag_graph(rng, len(lab2), K, S, n_src, n_sink, lab2),
                    npw)
            if j is not None:
                return j
        raise RuntimeError("no bag job inside the envelope in 20 draws")

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

    table, data, (bp_size, sm_size, scratch, smem, cap) = pdc.dag_launch(
        jobs, device)
    (bp_k, sm_k), fill_ms = timed(lambda: pdc.popoa_dag_fill(
        table, data, bp_size, sm_size, scratch, smem), reps)
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
# paths


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
    from centrolign_tpu_torch.ops import gotoh_cuda as gc
    from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc
    metrics.reset()
    gc.reset_counters()
    pdc.reset_counters()


def counts():
    from centrolign_tpu_torch.ops import gotoh_cuda as gc
    from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc
    return {"gotoh_fill": gc.FILL_LAUNCHES,
            "gotoh_traceback": gc.TRACEBACK_LAUNCHES,
            "popoa_dag_fill": pdc.FILL_LAUNCHES,
            "popoa_dag_traceback": pdc.TRACEBACK_LAUNCHES,
            "chain_jobs": gc.DISPATCHED_JOBS,
            "dag_jobs": pdc.DISPATCHED_JOBS}


def main() -> int:
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
    from centrolign_tpu_torch.ops import gotoh_cuda as gc
    from centrolign_tpu_torch.ops import popoa_dag_cuda as pdc
    from centrolign_tpu_torch.ops.align_params import AlignmentParams

    # 2. build
    t0 = time.perf_counter()
    _build.build_libraries(["gotoh", "popoa_dag"])
    gc._lib()
    pdc._lib()
    print(f"build: {GOTOH_SRC}, {DAG_SRC} with nvcc "
          f"{' '.join(_build.NVCC_FLAGS)} in {time.perf_counter() - t0:.3f} s",
          flush=True)
    for name in ("gotoh", "popoa_dag"):
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

    table = {name: {"ms": 0.0, "plain_ms": 0.0, "work": Work()}
             for name in KERNELS}
    here = compare_path_gotoh(dispatched, pair_counts["gotoh_fill"], device,
                              table, errs)
    for name, (ms, pms) in here.items():
        print(f"pair.fasta jobs, {name}: bit-equal, kernel {ms:.3f} ms, "
              f"plain {pms:.1f} ms over {len(dispatched)} dispatches "
              f"({card})", flush=True)

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
    for part in dag_dispatched:
        res, rows = compare_dag(part, device, reps=5)
        dag_work(part, rows, table["popoa_dag_fill"]["work"],
                 table["popoa_dag_traceback"]["work"])
        for name, (err, ms, pms) in res.items():
            table[name]["ms"] += ms
            table[name]["plain_ms"] += pms
            errs[name] = max(errs[name], err)
    for name in ("popoa_dag_fill", "popoa_dag_traceback"):
        k = table[name]
        print(f"five.fasta DAG jobs, {name}: bit-equal, kernel "
              f"{k['ms']:.3f} ms, plain {k['plain_ms']:.1f} ms, bound "
              f"{k['work'].bound()[0]:.6f} ms over {len(dag_dispatched)} "
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

    # the end: no jax, nothing of the JAX package
    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.")
                    or m == "centrolign_tpu" or m.startswith("centrolign_tpu."))
    require(not leaked, f"modules of jax or the JAX package were imported: "
            f"{leaked[:5]}")

    launches = {**{k: pair_counts[k] + five_counts[k]
                   for k in ("gotoh_fill", "gotoh_traceback")},
                "popoa_dag_fill": five_counts["popoa_dag_fill"],
                "popoa_dag_traceback": five_counts["popoa_dag_traceback"],
                "gotoh_align_single": single_counts["gotoh_fill"]}
    rows = []
    for name, (source, replaces) in KERNELS.items():
        k = table[name]
        bound_ms, bound_by = k["work"].bound()
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind(device),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

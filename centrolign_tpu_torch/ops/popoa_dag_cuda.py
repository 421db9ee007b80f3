"""DAG x DAG tier: kernel wrappers and dispatch (twin of the batched entry
of centrolign_tpu/ops/popoa_dag.py, :552-710).

A list of prepared _DagJob becomes one table row per job
(`dag_job_table`) and one int32 data buffer (`pack_dag_jobs`); one fill
launch and one traceback launch then serve the whole list, whatever the
jobs' shapes, and one device-to-host copy brings back every job's
traceback rows. The kernels read each job's shape, in-degrees and
parameters from its table row and its spans from its delta rows, so the
JAX package's compile buckets and its padded, reversed graph-2 arrays have
no counterpart here. The fill's lanes run along each job's short side
(`lane_sides`), a launch's threads hold the widest job's lanes
(`fill_lanes`), and its per-job state (`_ring_ints`) lies in shared memory
where it fits, else in global scratch (`dag_job_table`). The traceback's
shared-memory ring and windows are the same for every job; its copier is
modelled here (`TracebackCopier`) for the CPU tests.

On CUDA tensors the wrappers launch csrc/popoa_dag.cu or raise; on CPU
tensors they run the plain versions of ops/popoa_dag.py. Each is a
`*_buffers` + allocate + `*_into` split as in ops/gotoh_cuda.py.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .gotoh_cuda import (_check_cuda, _raise_on, _to_device, allocate,
                         check_buffers)
from .popoa_dag import (COL_BP_HI, COL_BP_LO, COL_G1, COL_G2, COL_GE, COL_GO,
                        COL_K1, COL_K2, COL_MATCH, COL_MISMATCH, COL_N1,
                        COL_N2, COL_NPW, COL_R, COL_SCRATCH_HI,
                        COL_SCRATCH_LO, COL_SINKM, COL_SINKPOS, COL_V1,
                        COL_V2, G1_DELTA, G2_DELTA, HEADER_ROWS, MAX_PW,
                        N_COLS, diag_offset, job_fields, launch_sizes,
                        popoa_dag_fill_plain, popoa_dag_traceback_plain)

# kernel launches (CUDA only) and jobs dispatched, since the last reset
FILL_LAUNCHES = 0
TRACEBACK_LAUNCHES = 0
DISPATCHED_JOBS = 0

# lanes a fill thread holds -> most threads a block may have
# (csrc/popoa_dag.cu, max_threads), and the widest short side a block holds
FILL_THREADS = {1: 512, 2: 512, 4: 640, 8: 1024}
MAX_LANES = max(r * n for r, n in FILL_THREADS.items())
# The traceback (csrc/popoa_dag.cu, kTb* and TbShared): a block of a walking
# warp and a copier warp per job. Its shared memory holds a ring of TB_RING
# rows of TB_COLS backpointers, the reachable cells of the TB_AHEAD
# diagonals below the walk, and per graph a window of TB_NODES delta words,
# the TB_NODE_AHEAD nodes below the walk staged; then two decode tables
# (256 and 1024 ints) and 40 bytes of the walk's state.
TRACEBACK_THREADS = 64
TB_AHEAD, TB_RING, TB_COLS = 96, 128, 128
TB_NODES, TB_NODE_AHEAD = 2048, 1024
TB_SMEM_BYTES = 4 * (TB_RING * TB_COLS + 2 * TB_NODES + 256 + 1024) + 40
# dynamic shared memory a block may have on sm_90 (227 KB), and the bytes of
# it the fill's kernel keeps for itself (static)
SMEM_LIMIT = 232448
FILL_STATIC_SMEM = 16
# gap penalties below this keep every DP value clear of int32's range
MAX_PENALTY = 1 << 28
# a node's sink index + 1 shares a word with its flags (csrc/popoa_dag.cu)
MAX_NODES = 1 << 27


def reset_counters() -> None:
    global FILL_LAUNCHES, TRACEBACK_LAUNCHES, DISPATCHED_JOBS
    FILL_LAUNCHES = TRACEBACK_LAUNCHES = DISPATCHED_JOBS = 0


def lane_sides(job):
    """(lane side, other side) of the fill: the lanes run along the short
    side, graph 1 when V1 <= V2."""
    return (job.t1, job.t2) if job.t1.V <= job.t2.V else (job.t2, job.t1)


def ring_depths(job):
    """Diagonals each ring plane of the fill keeps, as deep as it is read:
    (M, read at prev1 and prev2; PM, PMk1 and D, read at prev2; I, read
    at prev1) = (max(S1, S2) + 1, S2 + 1, S1 + 1)."""
    S1, S2 = job.t1.S, job.t2.S
    return max(S1, S2) + 1, S2 + 1, S1 + 1


def _ring_ints(job) -> int:
    """int32 state a fill keeps for `job`, in the kernel's order and
    rounded to whole int4s: the other side's node records (4 ints each,
    then graph 1's bdiag when graph 1 is the other side), then the rings
    of M, PM, PMk1, D[npw] and I[npw] over the lane side's lanes."""
    lane, other = lane_sides(job)
    records = 4 * other.V + (-(-other.V // 4) * 4 if other is job.t1 else 0)
    dm, d2, d1 = ring_depths(job)
    npw = job.params.num_pw
    rings = lane.V * (dm + (2 + npw) * d2 + npw * d1)
    return -(-(records + rings) // 4) * 4


def fill_lanes(jobs):
    """(lanes per thread, threads per block) of one fill launch over
    `jobs`: the fewest lanes a thread whose block holds the widest job's
    lanes (its short side)."""
    widest = max((min(j.t1.V, j.t2.V) for j in jobs), default=1)
    for R, most in FILL_THREADS.items():
        if -(-widest // R) <= most:
            return R, 32 * -(-widest // (32 * R))
    raise ValueError(f"a DAG fill block holds at most {MAX_LANES} lanes; "
                     f"a job's short side is {widest}")


def _launch_entries(job, n1: int, n2: int):
    """(data, sink-M) entries `job` adds to a launch (dag_job_table) with
    n1 x n2 sink positions."""
    t1, t2 = job.t1, job.t2
    return ((G1_DELTA + t1.delta.shape[0]) * t1.V
            + (G2_DELTA + t2.delta.shape[0]) * t2.V + n1 + n2, n1 * n2)


def launchable(job) -> bool:
    """Whether fill_lanes and dag_job_table accept `job` in a launch of its
    own: short side <= MAX_LANES, gap penalties below MAX_PENALTY, graphs
    under MAX_NODES nodes, data and sink-M entries below 2^31 (counted
    with every given sink, a bound on its sink positions)."""
    t1, t2, p = job.t1, job.t2, job.params
    entries = _launch_entries(job, len(job.sinks1), len(job.sinks2))
    return (min(t1.V, t2.V) <= MAX_LANES
            and max(p.gap_open) + max(p.gap_extend) < MAX_PENALTY
            and max(t1.V, t2.V) < MAX_NODES
            and max(entries) < 1 << 31)


def launch_groups(jobs) -> list:
    """Prepared launchable `jobs` cut into consecutive runs, each within
    one launch's 2^31 data and sink-M entries (dag_job_table)."""
    groups, data, sinkm = [], 0, 0
    for job in jobs:
        d, m = _launch_entries(job, len(job.sink_pos1), len(job.sink_pos2))
        if not groups or data + d >= 1 << 31 or sinkm + m >= 1 << 31:
            groups.append([])
            data = sinkm = 0
        groups[-1].append(job)
        data += d
        sinkm += m
    return groups


def _split64(x: int):
    """(low word as its int32 bit pattern, high word) of an int64."""
    lo = x & 0xFFFFFFFF
    return lo - (1 << 32) if lo >= 1 << 31 else lo, x >> 32


def dag_job_table(jobs, smem_limit: int = SMEM_LIMIT):
    """One int32 row of N_COLS per job (columns in ops/popoa_dag.py) and
    the launch's (scratch ints, shared-memory bytes). A job whose fill
    state (`_ring_ints`) fits `smem_limit` bytes beside the kernel's own
    keeps it in shared memory (scratch offset -1); the others get a slice
    of one global scratch buffer."""
    tab = np.zeros((len(jobs), N_COLS), np.int64)
    data_off = sinkm_off = bp_off = scratch_off = 0
    smem = 0
    for k, job in enumerate(jobs):
        t1, t2, p = job.t1, job.t2, job.params
        if p.num_pw > MAX_PW:
            raise ValueError(f"at most {MAX_PW} gap pieces, not {p.num_pw}")
        if max(p.gap_open) + max(p.gap_extend) >= MAX_PENALTY:
            raise ValueError("gap penalties must stay below 2^28")
        if max(t1.V, t2.V) >= MAX_NODES:
            raise ValueError(f"a DAG job's graphs hold under {MAX_NODES} "
                             f"nodes each")
        K1, K2 = t1.delta.shape[0], t2.delta.shape[0]
        n1, n2 = len(job.sink_pos1), len(job.sink_pos2)
        row = tab[k]
        row[[COL_V1, COL_V2, COL_K1, COL_K2, COL_R, COL_NPW, COL_MATCH,
             COL_MISMATCH]] = [t1.V, t2.V, K1, K2, job.ring, p.num_pw,
                               p.match, p.mismatch]
        row[COL_GO:COL_GO + p.num_pw] = p.gap_open
        row[COL_GE:COL_GE + p.num_pw] = p.gap_extend
        row[COL_G1] = data_off
        data_off += (G1_DELTA + K1) * t1.V
        row[COL_G2] = data_off
        data_off += (G2_DELTA + K2) * t2.V
        row[COL_SINKPOS] = data_off
        data_off += n1 + n2
        row[[COL_N1, COL_N2, COL_SINKM]] = [n1, n2, sinkm_off]
        sinkm_off += n1 * n2
        row[COL_BP_LO], row[COL_BP_HI] = _split64(bp_off)
        bp_off += job.cells
        ring_bytes = 4 * _ring_ints(job)
        if ring_bytes <= smem_limit - FILL_STATIC_SMEM:
            off = -1
            smem = max(smem, ring_bytes)
        else:
            off = scratch_off
            scratch_off += _ring_ints(job)
        row[COL_SCRATCH_LO], row[COL_SCRATCH_HI] = _split64(off)
    if max(data_off, sinkm_off) >= 1 << 31:
        raise ValueError("one launch's DAG data exceeds 2^31 entries")
    return torch.from_numpy(tab.astype(np.int32)), scratch_off, smem


def pack_dag_jobs(jobs) -> torch.Tensor:
    """Every job's graph-1 block, graph-2 block and sink positions, in
    table order, as one int32 buffer (layout in ops/popoa_dag.py)."""
    parts = []
    for job in jobs:
        t1, t2 = job.t1, job.t2
        sink1 = np.full(t1.V, -1, np.int32)
        sink1[job.sink_pos1] = np.arange(len(job.sink_pos1))
        sink2 = np.full(t2.V, -1, np.int32)
        sink2[job.sink_pos2] = np.arange(len(job.sink_pos2))
        parts += [t1.labels, t1.is_src[:t1.V], job.bcol_M, job.bdiag,
                  job.bdiag_k1, sink1, t1.delta.ravel(),
                  t2.labels, t2.is_src[:t2.V], job.brow_M, sink2,
                  t2.delta.ravel(), job.sink_pos1, job.sink_pos2]
    return torch.from_numpy(np.concatenate(
        [np.asarray(x, np.int32).ravel() for x in parts])
        if parts else np.zeros(0, np.int32))


def _diag_offset_lo(V1: int, V2: int, d: int) -> int:
    """diag_offset(V1, V2, d) modulo 2^31 as the traceback's walker
    computes it, in wrapping 32-bit arithmetic (diag_offset_lo)."""
    m = 0xFFFFFFFF
    full1 = ((V1 * (V1 + 1)) & m) >> 1
    a = ((d * (d + 1)) & m) >> 1 if d <= V1 else (full1 + (d - V1) * V1) & m
    t = d - V2 if d > V2 else 0
    return (a - (((t * (t + 1)) & m) >> 1)) & m


class TracebackCopier:
    """A model of the traceback's copier warp over one job (csrc/
    popoa_dag.cu): `round(d, r1)` is one round at the walk's position (d,
    r1), issuing the cells each diagonal within TB_AHEAD can reach as whole
    16-byte chunks into the ring, staging the nodes within TB_NODE_AHEAD
    into each graph's window and publishing the lowest of each that landed;
    `read(r1, r2)` is what the walker's step at (r1, r2) loads. Ring slots
    hold (diagonal, global bp index) and window slots the node, so a replay
    can check what each read finds."""

    def __init__(self, V1: int, V2: int, bp_off: int, r1: int, r2: int):
        self.V1, self.V2, self.bp_off = V1, V2, bp_off
        self.low = [r1 + r2 + 1, r1 + 1, r2 + 1]
        self.landed = list(self.low)
        self.ring = {}
        self.words = ({}, {})
        self.last_entry = -1   # the furthest bp entry a chunk read
        self.most_chunks = 0   # the most chunks one diagonal took

    def base(self, d: int) -> int:
        """Global bp index of cell r1 = 0 of diagonal d (cell r1 at + r1)."""
        return (self.bp_off + int(diag_offset(self.V1, self.V2, d))
                - max(0, d - self.V2 + 1))

    def round(self, d: int, r1: int) -> list:
        """One round at the walk's position. Returns the entries it
        overwrote that the walk at (d, r1) may still read (none is
        right)."""
        V1, V2 = self.V1, self.V2
        r2 = d - r1
        stops = (max(0, d - TB_AHEAD), max(0, r1 - TB_NODE_AHEAD),
                 max(0, r2 - TB_NODE_AHEAD))
        live = []
        for dd in range(min(self.low[0] - 1, d), stops[0] - 1, -1):
            lo = max(0, dd - V2 + 1)
            a, b = max(lo, r1 - (d - dd)), min(dd, V1 - 1, r1)
            if a > b:
                continue
            base = self.base(dd)
            c0, c1 = (base + a) >> 2, (base + b) >> 2
            self.most_chunks = max(self.most_chunks, c1 - c0 + 1)
            self.last_entry = max(self.last_entry, 4 * c1 + 3)
            for e in range(4 * c0, 4 * c1 + 4):
                slot = (dd % TB_RING, e % TB_COLS)
                old = self.ring.get(slot)
                if old is not None and old[0] != dd and old[0] <= d:
                    live.append(old)
                self.ring[slot] = (dd, e)
        for g, r in ((0, r1), (1, r2)):
            for p in range(min(self.low[g + 1] - 1, r), stops[g + 1] - 1, -1):
                old = self.words[g].get(p % TB_NODES)
                if old is not None and old != p and old <= r:
                    live.append(old)
                self.words[g][p % TB_NODES] = p
        self.low = [min(x, s) for x, s in zip(self.low, stops)]
        self.landed = list(self.low)
        return live

    def ready(self, r1: int, r2: int) -> bool:
        """Whether the walker at (r1, r2) may step without waiting."""
        return (r1 + r2 >= self.landed[0] and r1 >= self.landed[1]
                and r2 >= self.landed[2])

    def read(self, r1: int, r2: int):
        """(ring entry, graph-1 window entry, graph-2 window entry) that the
        walker's step at (r1, r2) loads, the ring column computed as the
        kernel does."""
        d = r1 + r2
        lo = max(0, d - self.V2 + 1)
        col = (self.bp_off + _diag_offset_lo(self.V1, self.V2, d) + r1
               - lo) % TB_COLS
        return (self.ring.get((d % TB_RING, col)),
                self.words[0].get(r1 % TB_NODES),
                self.words[1].get(r2 % TB_NODES))


def _lib(jitter: bool = False) -> ctypes.CDLL:
    lib = _build.load_library("popoa_dag", jitter)
    if not getattr(lib, "declared", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.popoa_dag_fill_launch.restype = i32
        lib.popoa_dag_fill_launch.argtypes = [vp, vp, vp, vp, vp, i32, i32,
                                              i32, i32, vp]
        lib.popoa_dag_traceback_launch.restype = i32
        lib.popoa_dag_traceback_launch.argtypes = [vp, vp, vp, vp, vp, i32,
                                                   i32, i32, vp]
        lib.declared = True
    return lib


def popoa_dag_fill_buffers(bp_size: int, sinkm_size: int,
                           scratch_size: int) -> list:
    """A fill launch's tensors: bp, zeroed (launch_sizes' spare entries
    included), sink M and the state of the jobs kept in global scratch."""
    return [("bp", (bp_size,), torch.int32, 0),
            ("sinkm", (sinkm_size,), torch.int32, None),
            ("scratch", (max(scratch_size, 1),), torch.int32, None)]


def popoa_dag_fill(table: torch.Tensor, data: torch.Tensor, bp_size: int,
                   sinkm_size: int, scratch_size: int, smem_bytes: int,
                   lanes=None):
    """Fill every job of `table`. Returns (bp int32 flat of bp_size,
    sink M int32 flat of sinkm_size). The sizes and, for a CUDA launch,
    `lanes` = (lanes per thread, threads per block) from `fill_lanes` are
    passed in so that a launch never reads the table back from the card."""
    bufs = allocate(popoa_dag_fill_buffers(bp_size, sinkm_size,
                                           scratch_size), table.device)
    return popoa_dag_fill_into(table, data, bp_size, sinkm_size,
                               scratch_size, smem_bytes, lanes, bufs)


def popoa_dag_fill_into(table: torch.Tensor, data: torch.Tensor,
                        bp_size: int, sinkm_size: int, scratch_size: int,
                        smem_bytes: int, lanes, bufs: dict,
                        jitter: bool = False):
    """popoa_dag_fill into `bufs` (popoa_dag_fill_buffers): returns its bp
    and sink M."""
    specs = popoa_dag_fill_buffers(bp_size, sinkm_size, scratch_size)
    if table.device.type == "cpu":
        check_buffers(bufs, specs, table.device)
        bp, sinkm = popoa_dag_fill_plain(table, data)
        bufs["bp"].copy_(bp)
        bufs["sinkm"].copy_(sinkm)
        return bufs["bp"], bufs["sinkm"]
    if table.device.type != "cuda":
        raise ValueError(f"no DAG fill for device {table.device}")
    global FILL_LAUNCHES
    dev = table.device
    n = table.shape[0]
    if table.shape != (n, N_COLS):
        raise ValueError(f"table must be (n, {N_COLS}), not "
                         f"{tuple(table.shape)}")
    if smem_bytes > SMEM_LIMIT - FILL_STATIC_SMEM:
        raise ValueError(f"{smem_bytes} B of shared memory is over the "
                         f"{SMEM_LIMIT - FILL_STATIC_SMEM} B a block of the "
                         f"fill can have")
    if lanes is None:
        raise ValueError("a CUDA fill needs its (lanes per thread, threads) "
                         "from fill_lanes")
    _check_cuda("table", table, torch.int32, dev)
    _check_cuda("data", data, torch.int32, dev)
    check_buffers(bufs, specs, dev)
    bp, sinkm, scratch = bufs["bp"], bufs["sinkm"], bufs["scratch"]
    if n == 0:
        return bp, sinkm
    lib = _lib(jitter)
    with torch.cuda.device(dev):
        err = lib.popoa_dag_fill_launch(
            table.data_ptr(), data.data_ptr(), bp.data_ptr(),
            sinkm.data_ptr(), scratch.data_ptr(), n, lanes[1], lanes[0],
            smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "popoa_dag_fill")
    FILL_LAUNCHES += 1
    return bp, sinkm


def popoa_dag_traceback_buffers(n: int, cap: int) -> list:
    """A traceback launch's rows for n jobs, zeroed."""
    return [("out", (n, cap + HEADER_ROWS, 2), torch.int32, 0)]


def popoa_dag_traceback(bp: torch.Tensor, sinkm: torch.Tensor,
                        table: torch.Tensor, data: torch.Tensor,
                        cap: int) -> torch.Tensor:
    """Walk every job from its best sink pair. Returns the (n, cap + 3, 2)
    int32 rows described in ops/popoa_dag.py. A CUDA launch runs one block
    of TRACEBACK_THREADS per job; `bp` comes from popoa_dag_fill (16-byte
    aligned, with launch_sizes' spare entries)."""
    bufs = allocate(popoa_dag_traceback_buffers(table.shape[0], cap),
                    table.device)
    return popoa_dag_traceback_into(bp, sinkm, table, data, cap, bufs)


def popoa_dag_traceback_into(bp: torch.Tensor, sinkm: torch.Tensor,
                             table: torch.Tensor, data: torch.Tensor,
                             cap: int, bufs: dict,
                             jitter: bool = False) -> torch.Tensor:
    """popoa_dag_traceback into `bufs` (popoa_dag_traceback_buffers):
    returns its rows."""
    specs = popoa_dag_traceback_buffers(table.shape[0], cap)
    if table.device.type == "cpu":
        check_buffers(bufs, specs, table.device)
        bufs["out"].copy_(popoa_dag_traceback_plain(bp, sinkm, table, data,
                                                    cap))
        return bufs["out"]
    if table.device.type != "cuda":
        raise ValueError(f"no DAG traceback for device {table.device}")
    global TRACEBACK_LAUNCHES
    dev = table.device
    n = table.shape[0]
    for name, x in (("bp", bp), ("sinkm", sinkm), ("table", table),
                    ("data", data)):
        _check_cuda(name, x, torch.int32, dev)
    check_buffers(bufs, specs, dev)
    out = bufs["out"]
    if n == 0:
        return out
    lib = _lib(jitter)
    with torch.cuda.device(dev):
        err = lib.popoa_dag_traceback_launch(
            bp.data_ptr(), sinkm.data_ptr(), table.data_ptr(),
            data.data_ptr(), out.data_ptr(), n, cap, TRACEBACK_THREADS,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "popoa_dag_traceback")
    TRACEBACK_LAUNCHES += 1
    return out


def dag_launch(jobs, device: torch.device):
    """(table, data) on `device` and the sizes of one launch over `jobs`:
    (bp entries, sink-M entries, scratch ints, shared bytes, cap, fill
    lanes)."""
    table, scratch, smem = dag_job_table(jobs)
    bp_size, sinkm_size, cap = launch_sizes(job_fields(table))
    return (_to_device(table, device), _to_device(pack_dag_jobs(jobs), device),
            (bp_size, sinkm_size, scratch, smem, cap, fill_lanes(jobs)))


def popoa_dag_align_jobs(jobs, device: torch.device) -> list:
    """One fill and one traceback launch over each of `jobs`'
    launch_groups on `device` (one group unless the jobs pass a launch's
    2^31 entries), each followed by one copy to the host. Returns each
    job's traceback rows (numpy)."""
    global DISPATCHED_JOBS
    DISPATCHED_JOBS += len(jobs)
    out = []
    for group in launch_groups(jobs):
        table, data, (bp_size, sinkm_size, scratch, smem, cap, lanes) = \
            dag_launch(group, device)
        bp, sinkm = popoa_dag_fill(table, data, bp_size, sinkm_size,
                                   scratch, smem, lanes)
        rows = popoa_dag_traceback(bp, sinkm, table, data, cap)
        out += list(rows.cpu().numpy())
    return out

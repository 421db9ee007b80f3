"""Chain-gap Gotoh tier: kernel wrappers and dispatch (twin of the dispatch
half of centrolign_tpu/ops/gotoh_pallas.py, :739-935).

`gotoh_align_device` is the single-problem entry (the counterpart of
gotoh_pallas.py::gotoh_align_pallas and gotoh_align_pallas_device_tb over
the Pallas kernel gotoh_fill_pallas, :177-328): one job through the same
dispatch.

A dispatch turns a list of jobs (seq1 int32[], seq2 int32[], swap_pref,
AlignmentParams) into one fill launch and one traceback launch on the
current stream of the given device, whatever the jobs' widths, and returns
without waiting; `gotoh_fetch` makes the one device-to-host copy and
unpacks per job (alignment (L, 2) int64 with GAP=-1, score int). The
kernels read each job's shape, orientation and parameters from its row of
the parameter table, so the JAX package's compile buckets and its
pack8 / packmulti / row-kernel split have no counterpart here.

A fill launch follows a plan (`fill_plan`, from the jobs' shapes on the
host): which block or cluster of blocks takes which job and which of its
lanes, how many lanes each thread holds and how many threads a block has.

Each launcher is two steps: `*_buffers` lists the output and scratch
tensors of a launch as (name, shape, dtype, init), init a number to fill
with or None for torch.empty, and `*_into` checks caller-given tensors of
those specs and launches into them (on the CPU it writes the plain
version's result into them). The plain wrappers (`gotoh_fill`,
`gotoh_traceback`) allocate the buffers (`allocate`) in between; a check
(ops/guard.py) places them inside guard bands instead, and passes
`jitter=True` to launch the library's jitter build (ops/_build.py).

On CUDA tensors the wrappers launch csrc/gotoh.cu or raise; on CPU tensors
they run the plain versions of ops/gotoh.py.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import metrics
from ..device import make_context, resolve_device
from . import _build
from .gotoh import (COL_BP_HI, COL_BP_LO, COL_GAPS, COL_LANE_IS_I, COL_NPW,
                    COL_SEQ_OFF, COL_SWAP, MAX_PW, N_COLS, gotoh_fill_plain,
                    gotoh_traceback_plain)

# kernel launches (CUDA only) and jobs dispatched, since the last reset
FILL_LAUNCHES = 0
TRACEBACK_LAUNCHES = 0
DISPATCHED_JOBS = 0

# a traceback block: one warp walks a job, one copies its rows
TRACEBACK_THREADS = 64
# cap on one launch's backpointer buffer; a dispatch over it splits
MAX_LAUNCH_BP_BYTES = 2 << 30

# the fill's launch plan. A job with more lanes (short side + 1) than
# CLUSTER_MIN_LANES is split over a cluster of CLUSTER blocks, and a launch
# that holds one runs all its blocks in clusters of that size; jobs are
# split, the most diagonals first, only while the launch's clusters fit
# the card at once (MAX_CLUSTERS: 16 clusters of 8 of an H100's 132 SMs),
# unless one block cannot hold the job.
CLUSTER = 8
CLUSTER_MIN_LANES = 128
MAX_CLUSTERS = 16
# lanes per thread -> most threads a block may have (csrc/gotoh.cu,
# max_threads)
FILL_THREADS = {1: 512, 2: 512, 4: 512, 8: 448}
# csrc/gotoh.cu: diagonals between two barriers (kChunk), ring entries per
# warp (kRing), ints per entry (kSlot) and the bytes before the rings
# (kMbarBytes)
FILL_CHUNK = 8
RING_ENTRIES = 4 * FILL_CHUNK
RING_SLOT_INTS = 1 + MAX_PW
MBAR_BYTES = 16 * (RING_ENTRIES // FILL_CHUNK) + 16
# other-side labels staged in shared memory (4 bytes each); past them the
# kernel reads device memory
STAGE_LABELS = 16384


def reset_counters() -> None:
    global FILL_LAUNCHES, TRACEBACK_LAUNCHES, DISPATCHED_JOBS
    FILL_LAUNCHES = TRACEBACK_LAUNCHES = DISPATCHED_JOBS = 0


def _bp_entries(V1: int, V2: int) -> int:
    return (V1 + V2 + 1) * (min(V1, V2) + 1)


def params_table(jobs) -> torch.Tensor:
    """One int32 row of 16 per job: [V1, V2, match, mismatch, go*, ge*]
    as gotoh_pallas.py:753-754 lays them out (zero-padded to column 10),
    then lane_is_i, swap_pref, npw, the offset of the job's sequences in
    `pack_seqs`, and the low and high 32 bits of its int64 offset in the
    backpointer buffer. The one place where the JAX package's parameters
    become what the kernels read."""
    tab = np.zeros((len(jobs), N_COLS), np.int64)
    seq_off = bp_off = 0
    for k, (s1, s2, swp, p) in enumerate(jobs):
        V1, V2 = len(s1), len(s2)
        npw = p.num_pw
        if npw > MAX_PW:
            raise ValueError(f"at most {MAX_PW} gap pieces, not {npw}")
        tab[k, :COL_GAPS + 2 * npw] = [V1, V2, p.match, p.mismatch,
                                       *p.gap_open, *p.gap_extend]
        tab[k, COL_LANE_IS_I] = V1 <= V2
        tab[k, COL_SWAP] = bool(swp)
        tab[k, COL_NPW] = npw
        tab[k, COL_SEQ_OFF] = seq_off
        tab[k, COL_BP_LO] = bp_off & 0xFFFFFFFF
        tab[k, COL_BP_HI] = bp_off >> 32
        seq_off += V1 + V2
        bp_off += _bp_entries(V1, V2)
    if seq_off >= 1 << 31:
        raise ValueError("sequences of one launch exceed 2^31 labels")
    # the low word is stored as its int32 bit pattern
    return torch.from_numpy(tab.astype(np.uint32).view(np.int32)
                            if len(jobs) else tab.astype(np.int32))


def pack_seqs(jobs) -> torch.Tensor:
    """seq1 then seq2 of every job, in table order, as one int32 buffer."""
    parts = [np.asarray(s, np.int32) for s1, s2, _, _ in jobs for s in (s1, s2)]
    return torch.from_numpy(np.concatenate(parts) if parts
                            else np.zeros(0, np.int32))


@dataclass(frozen=True)
class FillPlan:
    """One fill launch: `blocks` holds an int32 row per block (job, rank of
    the block in the job's group, group size, warps of the block holding
    lanes; job -1 for an empty block), in launch order; blocks run in
    clusters of `cluster`, each of `threads` threads holding
    `lanes_per_thread` lanes; `smem` bytes of shared memory hold the rings
    and `stage` labels of the other side."""
    blocks: np.ndarray
    cluster: int
    lanes_per_thread: int
    threads: int
    stage: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fill_plan(shapes, cluster_min_lanes: int = CLUSTER_MIN_LANES) -> FillPlan:
    """The launch plan for jobs of `shapes` ((V1, V2) each, table order).
    A job of more than `cluster_min_lanes` lanes takes a whole cluster, its
    lanes cut into CLUSTER contiguous slices, as long as the launch's
    clusters stay within MAX_CLUSTERS; every other job takes one block,
    packed CLUSTER to a cluster when the launch has clusters. The jobs with
    the most diagonals come first. Lanes per thread and threads per block
    follow from the widest slice a block holds."""
    lanes = [min(a, b) + 1 for a, b in shapes]
    one_block = max(r * n for r, n in FILL_THREADS.items())
    by_diagonals = sorted(range(len(shapes)),
                          key=lambda k: (-sum(shapes[k]), k))
    split = [False] * len(shapes)
    n_split = 0
    for k in by_diagonals:
        rest = len(shapes) - n_split - 1
        fits = n_split + 1 + _cdiv(rest, CLUSTER) <= MAX_CLUSTERS
        if lanes[k] > cluster_min_lanes and (fits or lanes[k] > one_block):
            split[k] = True
            n_split += 1
    C = CLUSTER if any(split) else 1
    per_block = [_cdiv(w, C) if s else w for w, s in zip(lanes, split)]
    widest = max(per_block, default=1)
    R = next((r for r, n in FILL_THREADS.items() if r * n >= widest), None)
    if R is None:
        raise ValueError(f"a block of the Gotoh fill holds at most "
                         f"{one_block} lanes; a job needs {widest} (short "
                         f"side too wide)")
    warps = [_cdiv(p, 32 * R) for p in per_block]
    order = sorted(by_diagonals, key=lambda k: not split[k])
    rows = []
    for k in order:
        if split[k]:
            rows += [(k, rank, C, warps[k]) for rank in range(C)]
        else:
            rows.append((k, 0, 1, warps[k]))
    rows += [(-1, 0, 1, 0)] * (-len(rows) % C)
    threads = 32 * max(warps, default=1)
    stage = min(max((max(a, b) for a, b in shapes), default=0), STAGE_LABELS)
    smem = MBAR_BYTES + 4 * ((threads // 32) * RING_ENTRIES * RING_SLOT_INTS
                             + stage)
    return FillPlan(np.asarray(rows, np.int32).reshape(-1, 4), C, R, threads,
                    stage, smem)


def _lib(jitter: bool = False) -> ctypes.CDLL:
    lib = _build.load_library("gotoh", jitter)
    if not getattr(lib, "declared", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gotoh_fill_launch.restype = i32
        lib.gotoh_fill_launch.argtypes = [vp, vp, vp, vp, vp, *[i32] * 6, vp]
        lib.gotoh_traceback_launch.restype = i32
        lib.gotoh_traceback_launch.argtypes = [vp, vp, vp, vp, i32, i32, i32, vp]
        lib.declared = True
    return lib


def _check_cuda(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def allocate(specs, device) -> dict:
    """Each (name, shape, dtype, init) of `specs` as a tensor on `device`:
    torch.empty for init None, else filled with init."""
    return {name: (torch.empty(shape, dtype=dtype, device=device)
                   if init is None else
                   torch.full(shape, init, dtype=dtype, device=device))
            for name, shape, dtype, init in specs}


def check_buffers(bufs: dict, specs, device) -> None:
    """Raise unless `bufs` holds a contiguous tensor on `device` for each
    spec, of its shape and dtype."""
    for name, shape, dtype, _ in specs:
        t = bufs.get(name)
        if t is None:
            raise ValueError(f"no buffer {name!r}")
        _check_cuda(name, t, dtype, device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, not "
                             f"{tuple(t.shape)}")


def gotoh_fill_buffers(n: int, bp_size: int) -> list:
    """A fill launch's tensors for n jobs of bp_size backpointers: bp,
    zeroed, with 8 entries of room past the end (the traceback copies whole
    16-byte chunks of the rows it reads), and the scores."""
    return [("bp", (bp_size + 8,), torch.int16, 0),
            ("score", (n,), torch.int32, None)]


def gotoh_fill(table: torch.Tensor, seqs: torch.Tensor, bp_size: int,
               plan: FillPlan):
    """Fill every job of `table`. Returns (bp flat uint16 of bp_size
    entries, score int32 (n,)). `bp_size` and the launch `plan` (from the
    jobs' shapes, `launch_sizes`) are passed in so a CUDA launch never reads
    the table back from the card."""
    bufs = allocate(gotoh_fill_buffers(table.shape[0], bp_size), table.device)
    return gotoh_fill_into(table, seqs, bp_size, plan, bufs)


def gotoh_fill_into(table: torch.Tensor, seqs: torch.Tensor, bp_size: int,
                    plan: FillPlan, bufs: dict, blocks=None,
                    jitter: bool = False):
    """gotoh_fill into `bufs` (gotoh_fill_buffers): returns its bp (as
    uint16, without the room) and score. `blocks`: the plan's block rows
    on the device, made from `plan` if not given."""
    n = table.shape[0]
    specs = gotoh_fill_buffers(n, bp_size)
    if table.device.type == "cpu":
        check_buffers(bufs, specs, table.device)
        bp, score = gotoh_fill_plain(table, seqs)
        bufs["bp"][:bp_size].copy_(bp.view(torch.int16))
        bufs["score"].copy_(score)
        return bufs["bp"][:bp_size].view(torch.uint16), bufs["score"]
    if table.device.type != "cuda":
        raise ValueError(f"no Gotoh fill for device {table.device}")
    global FILL_LAUNCHES
    dev = table.device
    if table.shape != (n, N_COLS):
        raise ValueError(f"table must be (n, {N_COLS}), not {tuple(table.shape)}")
    _check_cuda("table", table, torch.int32, dev)
    _check_cuda("seqs", seqs, torch.int32, dev)
    check_buffers(bufs, specs, dev)
    bp = bufs["bp"][:bp_size].view(torch.uint16)
    score = bufs["score"]
    if n == 0:
        return bp, score
    lib = _lib(jitter)
    if blocks is None:
        blocks = _to_device(torch.from_numpy(plan.blocks), dev)
    _check_cuda("blocks", blocks, torch.int32, dev)
    if tuple(blocks.shape) != plan.blocks.shape:
        raise ValueError(f"blocks must be {plan.blocks.shape}")
    with torch.cuda.device(dev):
        err = lib.gotoh_fill_launch(
            table.data_ptr(), seqs.data_ptr(), bp.data_ptr(),
            score.data_ptr(), blocks.data_ptr(), len(plan.blocks),
            plan.cluster, plan.lanes_per_thread, plan.threads, plan.stage,
            plan.smem, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "gotoh_fill")
    FILL_LAUNCHES += 1
    return bp, score


def gotoh_traceback_buffers(n: int, cap: int) -> list:
    """A traceback launch's rows for n jobs, zeroed."""
    return [("out", (n, cap + 1, 2), torch.int32, 0)]


def gotoh_traceback(bp: torch.Tensor, score: torch.Tensor,
                    table: torch.Tensor, cap: int) -> torch.Tensor:
    """Trace every job back from (V1, V2). Returns (n, cap+1, 2) int32:
    row 0 = (count, score), the pairs end at row cap, GAP = -1."""
    bufs = allocate(gotoh_traceback_buffers(table.shape[0], cap),
                    table.device)
    return gotoh_traceback_into(bp, score, table, cap, bufs)


def gotoh_traceback_into(bp: torch.Tensor, score: torch.Tensor,
                         table: torch.Tensor, cap: int, bufs: dict,
                         jitter: bool = False) -> torch.Tensor:
    """gotoh_traceback into `bufs` (gotoh_traceback_buffers): returns its
    rows. `bp` needs gotoh_fill_buffers' 8 entries of room past its end."""
    n = table.shape[0]
    specs = gotoh_traceback_buffers(n, cap)
    if table.device.type == "cpu":
        check_buffers(bufs, specs, table.device)
        bufs["out"].copy_(gotoh_traceback_plain(bp, score, table, cap))
        return bufs["out"]
    if table.device.type != "cuda":
        raise ValueError(f"no Gotoh traceback for device {table.device}")
    global TRACEBACK_LAUNCHES
    dev = table.device
    _check_cuda("bp", bp, torch.uint16, dev)
    _check_cuda("score", score, torch.int32, dev)
    _check_cuda("table", table, torch.int32, dev)
    check_buffers(bufs, specs, dev)
    out = bufs["out"]
    if n == 0:
        return out
    lib = _lib(jitter)
    with torch.cuda.device(dev):
        err = lib.gotoh_traceback_launch(
            bp.data_ptr(), score.data_ptr(), table.data_ptr(), out.data_ptr(),
            n, cap, TRACEBACK_THREADS,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "gotoh_traceback")
    TRACEBACK_LAUNCHES += 1
    return out


def launch_sizes(jobs):
    """(bp_size, fill plan, cap) of one launch over `jobs`."""
    lens = [(len(s1), len(s2)) for s1, s2, _, _ in jobs]
    return (sum(_bp_entries(a, b) for a, b in lens), fill_plan(lens),
            max((a + b for a, b in lens), default=0))


def gotoh_fill_tb(table: torch.Tensor, seqs: torch.Tensor, bp_size: int,
                  plan: FillPlan, cap: int) -> torch.Tensor:
    """Fill then traceback, on the tensors' device and stream."""
    bp, score = gotoh_fill(table, seqs, bp_size, plan)
    return gotoh_traceback(bp, score, table, cap)


def _split_launches(jobs):
    """Consecutive runs of jobs whose backpointers fit one launch."""
    out, cur, size = [], [], 0
    for job in jobs:
        nbytes = 2 * _bp_entries(len(job[0]), len(job[1]))
        if cur and size + nbytes > MAX_LAUNCH_BP_BYTES:
            out.append(cur)
            cur, size = [], 0
        cur.append(job)
        size += nbytes
    if cur:
        out.append(cur)
    return out


def _to_device(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        make_context(device)
        # pinned + non_blocking: the copy queues on the stream instead of
        # waiting for the fills already in flight
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def gotoh_dispatch(jobs, device: torch.device):
    """Launch fill + traceback for `jobs` on `device` without waiting.
    Returns a handle for gotoh_fetch."""
    global DISPATCHED_JOBS
    DISPATCHED_JOBS += len(jobs)
    handle = []
    for part in _split_launches(jobs):
        table = _to_device(params_table(part), device)
        seqs = _to_device(pack_seqs(part), device)
        handle.append((gotoh_fill_tb(table, seqs, *launch_sizes(part)),
                       len(part)))
    return handle


def gotoh_fetch(handle):
    """Wait for a gotoh_dispatch handle; returns the per-job list of
    (alignment (L,2) int64, score int)."""
    results = []
    for rows, n in handle:
        with metrics.span("device.wait"):
            rows = rows.cpu()
        packed = rows.numpy().astype(np.int64)
        for k in range(n):
            row = packed[k]
            count, sc = int(row[0, 0]), int(row[0, 1])
            results.append((row[len(row) - count:], sc))
    return results


def gotoh_align_batched(jobs, device: torch.device):
    """jobs: list of (seq1 int32[], seq2 int32[], swap_pref, params).
    Returns the per-job list of (alignment (L,2) int64, score int), each
    identical to centrolign_tpu.ops.gotoh.gotoh_align on that job."""
    return gotoh_fetch(gotoh_dispatch(jobs, device))


def gotoh_align_device(seq1, seq2, params, swap_pref: bool = False,
                       device: torch.device | None = None):
    """Global piecewise-affine alignment of one pair of encoded sequences
    on `device` (default: the one CENTROLIGN_TORCH_DEVICE names): one fill
    and one traceback launch on a card, the plain versions on the CPU.
    Returns (alignment (L,2) int64 with GAP=-1, score int), identical to
    centrolign_tpu.ops.gotoh.gotoh_align."""
    if device is None:
        device = resolve_device()
        if device is None:
            raise ValueError("gotoh_align_device needs a device, and "
                             "CENTROLIGN_TORCH_DEVICE is none")
    job = (np.asarray(seq1, np.int32), np.asarray(seq2, np.int32),
           bool(swap_pref), params)
    return gotoh_fetch(gotoh_dispatch([job], device))[0]

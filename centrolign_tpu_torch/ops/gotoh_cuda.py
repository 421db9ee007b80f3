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

On CUDA tensors the wrappers launch csrc/gotoh.cu or raise; on CPU tensors
they run the plain versions of ops/gotoh.py.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import resolve_device
from . import _build
from .gotoh import (COL_BP_HI, COL_BP_LO, COL_GAPS, COL_LANE_IS_I, COL_NPW,
                    COL_SEQ_OFF, COL_SWAP, MAX_PW, N_COLS, gotoh_fill_plain,
                    gotoh_traceback_plain)

# kernel launches (CUDA only) and jobs dispatched, since the last reset
FILL_LAUNCHES = 0
TRACEBACK_LAUNCHES = 0
DISPATCHED_JOBS = 0

FILL_THREADS = 512
TRACEBACK_THREADS = 64
# cap on one launch's backpointer buffer; a dispatch over it splits
MAX_LAUNCH_BP_BYTES = 2 << 30


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


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("gotoh")
    if not getattr(lib, "declared", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.gotoh_fill_launch.restype = i32
        lib.gotoh_fill_launch.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, vp]
        lib.gotoh_traceback_launch.restype = i32
        lib.gotoh_traceback_launch.argtypes = [vp, vp, vp, vp, i32, i32, i32, vp]
        lib.gotoh_scratch_rows.restype = i32
        lib.gotoh_scratch_rows.argtypes = []
        lib.declared = True
    return lib


def _check_cuda(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def gotoh_fill(table: torch.Tensor, seqs: torch.Tensor, bp_size: int,
               max_w: int):
    """Fill every job of `table`. Returns (bp flat uint16 of bp_size
    entries, score int32 (n,)). `bp_size` and `max_w` (the widest job's
    short side + 1) are passed in so a CUDA launch never reads the table
    back from the card."""
    if table.device.type == "cpu":
        return gotoh_fill_plain(table, seqs)
    if table.device.type != "cuda":
        raise ValueError(f"no Gotoh fill for device {table.device}")
    global FILL_LAUNCHES
    dev = table.device
    n = table.shape[0]
    if table.shape != (n, N_COLS):
        raise ValueError(f"table must be (n, {N_COLS}), not {tuple(table.shape)}")
    _check_cuda("table", table, torch.int32, dev)
    _check_cuda("seqs", seqs, torch.int32, dev)
    lib = _lib()
    stride = lib.gotoh_scratch_rows() * max_w
    bp = torch.zeros(bp_size, dtype=torch.int16, device=dev).view(torch.uint16)
    score = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(n * stride, dtype=torch.int32, device=dev)
    if n == 0:
        return bp, score
    with torch.cuda.device(dev):
        err = lib.gotoh_fill_launch(
            table.data_ptr(), seqs.data_ptr(), bp.data_ptr(),
            score.data_ptr(), scratch.data_ptr(), stride, n, FILL_THREADS,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "gotoh_fill")
    FILL_LAUNCHES += 1
    return bp, score


def gotoh_traceback(bp: torch.Tensor, score: torch.Tensor,
                    table: torch.Tensor, cap: int) -> torch.Tensor:
    """Trace every job back from (V1, V2). Returns (n, cap+1, 2) int32:
    row 0 = (count, score), the pairs end at row cap, GAP = -1."""
    if table.device.type == "cpu":
        return gotoh_traceback_plain(bp, score, table, cap)
    if table.device.type != "cuda":
        raise ValueError(f"no Gotoh traceback for device {table.device}")
    global TRACEBACK_LAUNCHES
    dev = table.device
    n = table.shape[0]
    _check_cuda("bp", bp, torch.uint16, dev)
    _check_cuda("score", score, torch.int32, dev)
    _check_cuda("table", table, torch.int32, dev)
    out = torch.zeros((n, cap + 1, 2), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.gotoh_traceback_launch(
            bp.data_ptr(), score.data_ptr(), table.data_ptr(), out.data_ptr(),
            n, cap, TRACEBACK_THREADS,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "gotoh_traceback")
    TRACEBACK_LAUNCHES += 1
    return out


def launch_sizes(jobs):
    """(bp_size, max_w, cap) of one launch over `jobs`."""
    if not jobs:
        return 0, 1, 0
    lens = [(len(s1), len(s2)) for s1, s2, _, _ in jobs]
    return (sum(_bp_entries(a, b) for a, b in lens),
            max(min(a, b) for a, b in lens) + 1,
            max(a + b for a, b in lens))


def gotoh_fill_tb(table: torch.Tensor, seqs: torch.Tensor, bp_size: int,
                  max_w: int, cap: int) -> torch.Tensor:
    """Fill then traceback, on the tensors' device and stream."""
    bp, score = gotoh_fill(table, seqs, bp_size, max_w)
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
        packed = rows.cpu().numpy().astype(np.int64)
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

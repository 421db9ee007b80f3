"""DAG x DAG tier: kernel wrappers and dispatch (twin of the batched entry
of centrolign_tpu/ops/popoa_dag.py, :552-710).

A list of prepared _DagJob becomes one table row per job
(`dag_job_table`) and one int32 data buffer (`pack_dag_jobs`); one fill
launch and one traceback launch then serve the whole list, whatever the
jobs' shapes, and one device-to-host copy brings back every job's
traceback rows. The kernels read each job's shape, envelope (K, S) and
parameters from its table row, so the JAX package's compile buckets and
its padded, reversed graph-2 arrays have no counterpart here.

On CUDA tensors the wrappers launch csrc/popoa_dag.cu or raise; on CPU
tensors they run the plain versions of ops/popoa_dag.py.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .gotoh_cuda import _check_cuda, _raise_on, _to_device
from .popoa_dag import (COL_BP_HI, COL_BP_LO, COL_G1, COL_G2, COL_GE, COL_GO,
                        COL_K1, COL_K2, COL_MATCH, COL_MISMATCH, COL_N1,
                        COL_N2, COL_NPW, COL_R, COL_SCRATCH_HI,
                        COL_SCRATCH_LO, COL_SINKM, COL_SINKPOS, COL_V1,
                        COL_V2, G1_DELTA, G2_DELTA, HEADER_ROWS, MAX_PW,
                        N_COLS, job_fields, launch_sizes,
                        popoa_dag_fill_plain, popoa_dag_traceback_plain)

# kernel launches (CUDA only) and jobs dispatched, since the last reset
FILL_LAUNCHES = 0
TRACEBACK_LAUNCHES = 0
DISPATCHED_JOBS = 0

FILL_THREADS = 256
TRACEBACK_THREADS = 64
# dynamic shared memory a block may have on sm_90 (227 KB)
SMEM_LIMIT = 232448
# gap penalties below this keep every DP value clear of int32's range
MAX_PENALTY = 1 << 28


def reset_counters() -> None:
    global FILL_LAUNCHES, TRACEBACK_LAUNCHES, DISPATCHED_JOBS
    FILL_LAUNCHES = TRACEBACK_LAUNCHES = DISPATCHED_JOBS = 0


def _ring_ints(job) -> int:
    """int32 state a fill keeps for `job`: R diagonals of V1 lanes of M,
    PM, PMk1, I[npw] and D[npw]."""
    return (3 + 2 * job.params.num_pw) * job.ring * job.t1.V


def _split64(x: int):
    """(low word as its int32 bit pattern, high word) of an int64."""
    lo = x & 0xFFFFFFFF
    return lo - (1 << 32) if lo >= 1 << 31 else lo, x >> 32


def dag_job_table(jobs, smem_limit: int = SMEM_LIMIT):
    """One int32 row of N_COLS per job (columns in ops/popoa_dag.py) and
    the launch's (scratch ints, shared-memory bytes). A job whose state
    rings fit `smem_limit` bytes keeps them in shared memory (scratch
    offset -1); the others get a slice of one global scratch buffer."""
    tab = np.zeros((len(jobs), N_COLS), np.int64)
    data_off = sinkm_off = bp_off = scratch_off = 0
    smem = 0
    for k, job in enumerate(jobs):
        t1, t2, p = job.t1, job.t2, job.params
        if p.num_pw > MAX_PW:
            raise ValueError(f"at most {MAX_PW} gap pieces, not {p.num_pw}")
        if max(p.gap_open) + max(p.gap_extend) >= MAX_PENALTY:
            raise ValueError("gap penalties must stay below 2^28")
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
        if ring_bytes <= smem_limit:
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


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("popoa_dag")
    if not getattr(lib, "declared", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.popoa_dag_fill_launch.restype = i32
        lib.popoa_dag_fill_launch.argtypes = [vp, vp, vp, vp, vp, i32, i32,
                                              i32, vp]
        lib.popoa_dag_traceback_launch.restype = i32
        lib.popoa_dag_traceback_launch.argtypes = [vp, vp, vp, vp, vp, i32,
                                                   i32, i32, vp]
        lib.declared = True
    return lib


def popoa_dag_fill(table: torch.Tensor, data: torch.Tensor, bp_size: int,
                   sinkm_size: int, scratch_size: int, smem_bytes: int):
    """Fill every job of `table`. Returns (bp int32 flat of bp_size,
    sink M int32 flat of sinkm_size). The sizes are passed in so that a
    CUDA launch never reads the table back from the card."""
    if table.device.type == "cpu":
        return popoa_dag_fill_plain(table, data)
    if table.device.type != "cuda":
        raise ValueError(f"no DAG fill for device {table.device}")
    global FILL_LAUNCHES
    dev = table.device
    n = table.shape[0]
    if table.shape != (n, N_COLS):
        raise ValueError(f"table must be (n, {N_COLS}), not "
                         f"{tuple(table.shape)}")
    if smem_bytes > SMEM_LIMIT:
        raise ValueError(f"{smem_bytes} B of shared memory is over the "
                         f"{SMEM_LIMIT} B a block can have")
    _check_cuda("table", table, torch.int32, dev)
    _check_cuda("data", data, torch.int32, dev)
    bp = torch.zeros(bp_size, dtype=torch.int32, device=dev)
    sinkm = torch.empty(sinkm_size, dtype=torch.int32, device=dev)
    scratch = torch.empty(max(scratch_size, 1), dtype=torch.int32,
                          device=dev)
    if n == 0:
        return bp, sinkm
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.popoa_dag_fill_launch(
            table.data_ptr(), data.data_ptr(), bp.data_ptr(),
            sinkm.data_ptr(), scratch.data_ptr(), n, FILL_THREADS,
            smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "popoa_dag_fill")
    FILL_LAUNCHES += 1
    return bp, sinkm


def popoa_dag_traceback(bp: torch.Tensor, sinkm: torch.Tensor,
                        table: torch.Tensor, data: torch.Tensor,
                        cap: int) -> torch.Tensor:
    """Walk every job from its best sink pair. Returns the (n, cap + 3, 2)
    int32 rows described in ops/popoa_dag.py."""
    if table.device.type == "cpu":
        return popoa_dag_traceback_plain(bp, sinkm, table, data, cap)
    if table.device.type != "cuda":
        raise ValueError(f"no DAG traceback for device {table.device}")
    global TRACEBACK_LAUNCHES
    dev = table.device
    n = table.shape[0]
    for name, x in (("bp", bp), ("sinkm", sinkm), ("table", table),
                    ("data", data)):
        _check_cuda(name, x, torch.int32, dev)
    out = torch.zeros((n, cap + HEADER_ROWS, 2), dtype=torch.int32,
                      device=dev)
    if n == 0:
        return out
    lib = _lib()
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
    (bp entries, sink-M entries, scratch ints, shared bytes, cap)."""
    table, scratch, smem = dag_job_table(jobs)
    bp_size, sinkm_size, cap = launch_sizes(job_fields(table))
    return (_to_device(table, device), _to_device(pack_dag_jobs(jobs), device),
            (bp_size, sinkm_size, scratch, smem, cap))


def popoa_dag_align_jobs(jobs, device: torch.device) -> list:
    """One fill and one traceback launch over `jobs` on `device`, then one
    copy to the host. Returns each job's traceback rows (numpy)."""
    global DISPATCHED_JOBS
    DISPATCHED_JOBS += len(jobs)
    if not jobs:
        return []
    table, data, (bp_size, sinkm_size, scratch, smem, cap) = dag_launch(
        jobs, device)
    bp, sinkm = popoa_dag_fill(table, data, bp_size, sinkm_size, scratch,
                               smem)
    rows = popoa_dag_traceback(bp, sinkm, table, data, cap)
    return list(rows.cpu().numpy())

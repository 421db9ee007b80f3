"""SparseAffine CDQ value scan: kernel wrapper (csrc/chain_cdq.cu).

`cdq_scan` takes the launch layout of ops/chain_cdq.py (`pack`) on one
device. On CUDA tensors it launches chain_cdq_level_kernel, one
cooperative launch of a block per SM that runs every level of the batch,
or raises (also when the blocks cannot all be resident); on CPU tensors it
runs the plain version, chain_cdq.cdq_scan_plain.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .chain_cdq import cdq_scan_plain
from .gotoh_cuda import _check_cuda, _raise_on

# kernel launches and the problems and anchors they took; problems and
# anchors the plain version took on the CPU; all since the last reset
LAUNCHES = 0
PROBLEMS = 0
ANCHORS = 0
PLAIN_PROBLEMS = 0
PLAIN_ANCHORS = 0

# rows a block stages into shared memory at a time, 48 bytes each
# (csrc/chain_cdq.cu): 196,608 B of the 232,448 a block may have
STAGE_ROWS = 4096
# queries of a level taken between two grid barriers: the partials buffer
# holds this many per block, 7 channels of 16 bytes each
PART_QUERIES = 2048


def reset_counters() -> None:
    global LAUNCHES, PROBLEMS, ANCHORS, PLAIN_PROBLEMS, PLAIN_ANCHORS
    LAUNCHES = PROBLEMS = ANCHORS = PLAIN_PROBLEMS = PLAIN_ANCHORS = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("chain_cdq")
    if not getattr(lib, "declared", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.chain_cdq_scan_launch.restype = i32
        lib.chain_cdq_scan_launch.argtypes = [
            *[vp] * 7, i32, vp, vp, i32, *[vp] * 6, i32, i32, i32, i32, vp]
        lib.declared = True
    return lib


def cdq_scan(key, step, wi, fc, cs, prefix, levels, anchors: int):
    """The scan over a packed batch (layout and level schedule `levels` in
    ops/chain_cdq.py), `anchors` of its rows real. Returns (dp f32, bp
    int32, tie uint8, struct uint8, stored f32), each (B, N), on the
    inputs' device."""
    global LAUNCHES, PROBLEMS, ANCHORS, PLAIN_PROBLEMS, PLAIN_ANCHORS
    B, N = key.shape[:2]
    if key.device.type == "cpu":
        PLAIN_PROBLEMS += B
        PLAIN_ANCHORS += anchors
        return cdq_scan_plain(key, step, wi, fc, cs, prefix)
    if key.device.type != "cuda":
        raise ValueError(f"no CDQ scan for device {key.device}")
    dev = key.device
    for name, t, dtype, shape in (
            ("key", key, torch.int32, (B, N, 4)),
            ("step", step, torch.int32, (B, N, 4)),
            ("wi", wi, torch.float32, (B, N, 2)),
            ("fc", fc, torch.float64, (B, N, 6)),
            ("cs", cs, torch.float64, (B, N, 3)),
            ("prefix", prefix, torch.int32, (B,)),
            ("levels", levels, torch.int32, (levels.shape[0], 4))):
        _check_cuda(name, t, dtype, dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, not {tuple(t.shape)}")
    # scratch: each problem's published rows, N float4s a side of the
    # shift; each block's partials; the grid barrier's counter
    # (csrc/chain_cdq.cu)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    table = torch.empty((B, N, 8), dtype=torch.float32, device=dev)
    part = torch.empty((blocks, PART_QUERIES, 7, 4), dtype=torch.int32,
                       device=dev)
    bar = torch.zeros(1, dtype=torch.int64, device=dev)
    dp = torch.empty((B, N), dtype=torch.float32, device=dev)
    bp = torch.empty((B, N), dtype=torch.int32, device=dev)
    tie = torch.empty((B, N), dtype=torch.uint8, device=dev)
    strct = torch.empty((B, N), dtype=torch.uint8, device=dev)
    stored = torch.empty((B, N), dtype=torch.float32, device=dev)
    if B == 0 or N == 0:
        return dp, bp, tie, strct, stored
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.chain_cdq_scan_launch(
            key.data_ptr(), step.data_ptr(), wi.data_ptr(), fc.data_ptr(),
            cs.data_ptr(), prefix.data_ptr(), levels.data_ptr(),
            levels.shape[0], table.data_ptr(), part.data_ptr(),
            PART_QUERIES, bar.data_ptr(), dp.data_ptr(), bp.data_ptr(),
            tie.data_ptr(), strct.data_ptr(), stored.data_ptr(), B, N,
            blocks, STAGE_ROWS, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "chain_cdq_level")
    LAUNCHES += 1
    PROBLEMS += B
    ANCHORS += anchors
    return dp, bp, tie, strct, stored

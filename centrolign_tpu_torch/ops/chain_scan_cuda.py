"""Free-gap sparse chaining's event scan: kernel wrapper
(csrc/chain_scan.cu).

`event_scan` takes the event layout and the level schedule of
ops/chain_scan.py on one device. On CUDA tensors it launches
chain_scan_level_kernel, one cooperative launch of a block per SM that
runs every level, or raises (also when the blocks cannot all be
resident); on CPU tensors it runs the plain version,
chain_scan.event_scan_plain.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .chain_scan import event_scan_plain
from .gotoh_cuda import _check_cuda, _raise_on

# kernel launches and the problems and anchors they took; problems and
# anchors the plain version took on the CPU; all since the last reset
LAUNCHES = 0
PROBLEMS = 0
ANCHORS = 0
PLAIN_PROBLEMS = 0
PLAIN_ANCHORS = 0

# slots a block stages into shared memory at a time, 8 bytes each
# (csrc/chain_scan.cu); even
STAGE_ROWS = 16384
# queries of a level taken between two grid barriers: the partials buffer
# holds this many per block, 8 bytes each
PART_QUERIES = 2048


def reset_counters() -> None:
    global LAUNCHES, PROBLEMS, ANCHORS, PLAIN_PROBLEMS, PLAIN_ANCHORS
    LAUNCHES = PROBLEMS = ANCHORS = PLAIN_PROBLEMS = PLAIN_ANCHORS = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("chain_scan")
    if not getattr(lib, "declared", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.chain_scan_event_launch.restype = i32
        lib.chain_scan_event_launch.argtypes = [
            vp, vp, i32, vp, vp, vp, vp, i32, vp, vp, i32, i32, i32, i32,
            vp]
        lib.declared = True
    return lib


def event_scan(ev, dp0, levels, anchors: int):
    """The scan over events `ev` (E, 4) int32 from the initial DP `dp0`
    (n,) f32 of `anchors` = n slots, by the level schedule `levels` =
    (steps (S, 4) int32, queries (Q,) int32) of chain_scan.event_steps.
    Returns (dp (n,) f32, winner (E,) int32)."""
    global LAUNCHES, PROBLEMS, ANCHORS, PLAIN_PROBLEMS, PLAIN_ANCHORS
    if ev.device.type == "cpu":
        PLAIN_PROBLEMS += 1
        PLAIN_ANCHORS += anchors
        return event_scan_plain(ev, dp0)
    if ev.device.type != "cuda":
        raise ValueError(f"no event scan for device {ev.device}")
    dev = ev.device
    steps, queries = levels
    _check_cuda("ev", ev, torch.int32, dev)
    _check_cuda("dp0", dp0, torch.float32, dev)
    _check_cuda("steps", steps, torch.int32, dev)
    _check_cuda("queries", queries, torch.int32, dev)
    E, n_slots = ev.shape[0], dp0.shape[0]
    if ev.shape != (E, 4):
        raise ValueError(f"ev must be (E, 4), not {tuple(ev.shape)}")
    if steps.dim() != 2 or steps.shape[1] != 4 or queries.dim() != 1:
        raise ValueError(f"steps must be (S, 4) and queries (Q,), not "
                         f"{tuple(steps.shape)} and {tuple(queries.shape)}")
    dp = dp0.clone()
    winner = torch.empty(E, dtype=torch.int32, device=dev)
    if E == 0:
        return dp, winner
    # scratch: the slots (value, insert event) and two spares; each
    # block's partials; the grid barrier's counter (csrc/chain_scan.cu)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    row = torch.empty((n_slots + 2, 2), dtype=torch.int32, device=dev)
    part = torch.empty((blocks, PART_QUERIES, 2), dtype=torch.int32,
                       device=dev)
    bar = torch.zeros(1, dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.chain_scan_event_launch(
            ev.data_ptr(), steps.data_ptr(), steps.shape[0],
            queries.data_ptr(), dp.data_ptr(), row.data_ptr(),
            part.data_ptr(), PART_QUERIES, bar.data_ptr(),
            winner.data_ptr(), E, n_slots, blocks, STAGE_ROWS,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "chain_scan_level")
    LAUNCHES += 1
    PROBLEMS += 1
    ANCHORS += anchors
    return dp, winner

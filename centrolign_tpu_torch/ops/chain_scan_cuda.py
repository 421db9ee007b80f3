"""Free-gap sparse chaining's event scan: kernel wrapper
(csrc/chain_scan.cu).

`event_scan` takes the event layout of ops/chain_scan.py on one device. On
CUDA tensors it launches chain_scan_event_kernel, one block, or raises; on
CPU tensors it runs the plain version, chain_scan.event_scan_plain.
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

# threads of the block (csrc/chain_scan.cu, kMaxThreads)
THREADS = 1024
# the value table lies in shared memory up to this many slots (4 bytes
# each, within the 232,448 B a block may have), else in device memory
SHARED_SLOTS = 32768


def reset_counters() -> None:
    global LAUNCHES, PROBLEMS, ANCHORS, PLAIN_PROBLEMS, PLAIN_ANCHORS
    LAUNCHES = PROBLEMS = ANCHORS = PLAIN_PROBLEMS = PLAIN_ANCHORS = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("chain_scan")
    if not getattr(lib, "declared", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.chain_scan_event_launch.restype = i32
        lib.chain_scan_event_launch.argtypes = [vp, vp, vp, vp, i32, i32,
                                                i32, i32, vp]
        lib.declared = True
    return lib


def event_scan(ev, dp0, anchors: int):
    """The scan over events `ev` (E, 4) int32 from the initial DP `dp0`
    (n,) f32 of `anchors` = n slots. Returns (dp (n,) f32, winner (E,)
    int32)."""
    global LAUNCHES, PROBLEMS, ANCHORS, PLAIN_PROBLEMS, PLAIN_ANCHORS
    if ev.device.type == "cpu":
        PLAIN_PROBLEMS += 1
        PLAIN_ANCHORS += anchors
        return event_scan_plain(ev, dp0)
    if ev.device.type != "cuda":
        raise ValueError(f"no event scan for device {ev.device}")
    dev = ev.device
    _check_cuda("ev", ev, torch.int32, dev)
    _check_cuda("dp0", dp0, torch.float32, dev)
    E, n_slots = ev.shape[0], dp0.shape[0]
    if ev.shape != (E, 4):
        raise ValueError(f"ev must be (E, 4), not {tuple(ev.shape)}")
    dp = dp0.clone()
    winner = torch.empty(E, dtype=torch.int32, device=dev)
    if E == 0:
        return dp, winner
    shared = n_slots <= SHARED_SLOTS
    val = (torch.empty(0, dtype=torch.float32, device=dev) if shared
           else torch.empty_like(dp0))
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.chain_scan_event_launch(
            ev.data_ptr(), dp.data_ptr(), val.data_ptr(), winner.data_ptr(),
            E, n_slots, int(shared), THREADS,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "chain_scan_event")
    LAUNCHES += 1
    PROBLEMS += 1
    ANCHORS += anchors
    return dp, winner

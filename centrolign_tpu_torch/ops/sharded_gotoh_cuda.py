"""The lane-sharded Gotoh fill's chunk: kernel wrapper
(csrc/sharded_gotoh.cu).

`chunk_fill` fills one shard's chunk of diagonals (layouts in
ops/sharded_gotoh.py). On CUDA tensors it launches
sharded_gotoh_chunk_kernel, one block a problem, or raises; on CPU tensors
it runs the plain version, sharded_gotoh.chunk_fill_plain.
parallel/sharded_gotoh.py drives the shards and moves the halos.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .gotoh_cuda import _check_cuda, _raise_on
from .sharded_gotoh import HALO_Q, MAX_PW, PLANES, chunk_fill_plain

# kernel launches, halo copies between two devices (parallel/
# sharded_gotoh.py) and problems filled (shard x problem, per fill) by the
# kernel, since the last reset; PLAIN_PROBLEMS counts the plain version's
LAUNCHES = 0
HALO_COPIES = 0
PROBLEMS = 0
PLAIN_PROBLEMS = 0

THREADS = 1024


def reset_counters() -> None:
    global LAUNCHES, HALO_COPIES, PROBLEMS, PLAIN_PROBLEMS
    LAUNCHES = HALO_COPIES = PROBLEMS = PLAIN_PROBLEMS = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("sharded_gotoh")
    if not getattr(lib, "declared", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sharded_gotoh_chunk_launch.restype = i32
        lib.sharded_gotoh_chunk_launch.argtypes = [
            vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, vp, vp, vp, vp, vp,
            i32, vp]
        lib.declared = True
    return lib


def chunk_fill(a, b, V1, V2, params, state, halo_in, halo_out, bp, score,
               *, L0: int, Wl: int, H: int, d0: int, nd: int,
               lane_is_i: bool, swap_pref: bool) -> None:
    """Fill diagonals d0 .. d0 + nd - 1 of one shard (arguments as for
    sharded_gotoh.chunk_fill_plain), in place."""
    global LAUNCHES, PROBLEMS, PLAIN_PROBLEMS
    kw = dict(L0=L0, Wl=Wl, H=H, d0=d0, nd=nd, lane_is_i=lane_is_i,
              swap_pref=swap_pref)
    if state.device.type == "cpu":
        chunk_fill_plain(a, b, V1, V2, params, state, halo_in, halo_out, bp,
                         score, **kw)
        if d0 == 0:
            PLAIN_PROBLEMS += a.shape[0]
        return
    if state.device.type != "cuda":
        raise ValueError(f"no sharded Gotoh fill for device {state.device}")
    dev = state.device
    Bl = a.shape[0]
    E = H + Wl
    for name, t in (("a", a), ("b", b), ("V1", V1), ("V2", V2),
                    ("state", state), ("score", score)):
        _check_cuda(name, t, torch.int32, dev)
    if state.shape != (Bl, PLANES, E):
        raise ValueError(f"state must be {(Bl, PLANES, E)}, not "
                         f"{tuple(state.shape)}")
    for name, h in (("halo_in", halo_in), ("halo_out", halo_out)):
        if h is not None:
            _check_cuda(name, h, torch.int32, dev)
            if h.shape != (Bl, HALO_Q, H):
                raise ValueError(f"{name} must be {(Bl, HALO_Q, H)}, not "
                                 f"{tuple(h.shape)}")
    if bp is not None:
        _check_cuda("bp", bp, torch.int16, dev)
        if bp.dim() != 3 or bp.shape[1:] != (Bl, Wl) or \
                bp.shape[0] < d0 + nd:
            raise ValueError(f"bp must be (>= {d0 + nd}, {Bl}, {Wl}), not "
                             f"{tuple(bp.shape)}")
    npw = params.num_pw
    go = [int(x) for x in params.gap_open] + [0] * (MAX_PW - npw)
    ge = [int(x) for x in params.gap_extend] + [0] * (MAX_PW - npw)
    threads = min(THREADS, -(-E // 32) * 32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = _lib().sharded_gotoh_chunk_launch(
            a.data_ptr(), b.data_ptr(), V1.data_ptr(), V2.data_ptr(), Bl,
            a.shape[1], b.shape[1], int(params.match), int(params.mismatch),
            *go, *ge, npw, int(lane_is_i), int(swap_pref), L0, Wl, H, d0,
            nd, state.data_ptr(), ptr(halo_in), ptr(halo_out), ptr(bp),
            score.data_ptr(), threads,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "sharded_gotoh_chunk")
    LAUNCHES += 1
    if d0 == 0:
        PROBLEMS += Bl

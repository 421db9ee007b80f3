"""The lane-sharded Gotoh fill: kernel wrapper (csrc/sharded_gotoh.cu).

`run_schedule` runs a whole fill's schedule
(parallel/sharded_gotoh.py::chunk_schedule) over its shards (layouts in
ops/sharded_gotoh.py). On shards on cards it queues it on the shards'
streams in one call into the kernel's library (sharded_gotoh_run): every
launch of sharded_gotoh_chunk_kernel, one thread block per block of a
shard's lanes and problem, every event record and wait and every peer
copy of a halo; the library checks each launch and stops at the first
error, and the wrapper raises. A launch costs the host a few
microseconds there, where one from Python costs tens. On CPU shards it
runs the plain version, sharded_gotoh.run_schedule_plain over
chunk_fill_plain.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .gotoh_cuda import _check_cuda, _raise_on
from .sharded_gotoh import HALO_Q, MAX_PW, run_schedule_plain

# kernel launches, halo copies between two devices, waits of a shard's
# stream on its left neighbour's event and problems filled (shard x
# problem, per fill) by the kernel, since the last reset; PLAIN_PROBLEMS
# counts the plain version's
LAUNCHES = 0
HALO_COPIES = 0
EVENT_WAITS = 0
PROBLEMS = 0
PLAIN_PROBLEMS = 0

# threads of a block at most (the kernel's __launch_bounds__)
MAX_THREADS = 256


def reset_counters() -> None:
    global LAUNCHES, HALO_COPIES, EVENT_WAITS, PROBLEMS, PLAIN_PROBLEMS
    LAUNCHES = HALO_COPIES = EVENT_WAITS = PROBLEMS = PLAIN_PROBLEMS = 0


def launch_shape(E: int) -> tuple:
    """(R, threads) for a block of E extended lanes: the fewest lanes a
    thread R in (1, 2, 4, 8) that hold them in at most four warps (one per
    scheduler of the SM), else R = 8 and more warps."""
    for R in (1, 2, 4, 8):
        if E <= 128 * R:
            return R, 32 * -(-E // (32 * R))
    threads = 32 * -(-E // 256)
    if threads > MAX_THREADS:
        raise ValueError(f"a block of {E} extended lanes is over "
                         f"{8 * MAX_THREADS}")
    return 8, threads


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("sharded_gotoh")
    if not getattr(lib, "declared", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sharded_gotoh_run.restype = i32
        lib.sharded_gotoh_run.argtypes = (
            [vp, i32, vp, i32] + [i32] * 20 + [vp, i32])
        lib.declared = True
    return lib


# op kinds of chunk_schedule, as the library numbers them
_KINDS = {"start": 0, "wait": 1, "copy": 2, "fill": 3, "record": 4,
          "join": 5}
_COLS = 13  # a shard's row in the library's table


def run_schedule(ops, shards, params, *, Wl: int, H: int, blocks: int,
                 num_diags: int, lane_is_i: bool, swap_pref: bool) -> None:
    """Run `ops` over `shards` (chunk_schedule's keys -> fill_shards' dicts
    of tensors). On cards each shard gets a stream of its own, which first
    waits for the caller's current stream of its device; at the joins
    every such current stream waits for every shard's last chunk. On the
    CPU the plain version runs them in order."""
    global LAUNCHES, HALO_COPIES, EVENT_WAITS, PROBLEMS, PLAIN_PROBLEMS
    types = {sh["state"].device.type for sh in shards.values()}
    if types == {"cpu"}:
        run_schedule_plain(ops, shards, params, Wl=Wl, H=H, blocks=blocks,
                           num_diags=num_diags, lane_is_i=lane_is_i,
                           swap_pref=swap_pref)
        PLAIN_PROBLEMS += sum(sh["a"].shape[0] for sh in shards.values())
        return
    if types != {"cuda"}:
        raise ValueError(f"no sharded Gotoh fill over devices {types}")
    keys = list(shards)
    index = {k: i for i, k in enumerate(keys)}
    first = shards[keys[0]]
    Bl = first["a"].shape[0]
    for k in keys:
        sh = shards[k]
        dev = sh["state"].device
        for name in ("a", "b", "V1", "V2", "state", "score"):
            _check_cuda(name, sh[name], torch.int32, dev)
        if sh["state"].shape != (2, Bl, HALO_Q, Wl):
            raise ValueError(f"state must be {(2, Bl, HALO_Q, Wl)}")
        for name in ("out", "in"):
            t = sh.get(name)
            if t is not None:
                _check_cuda(name, t, torch.int32, dev)
                if t.shape[1:] != (Bl, HALO_Q, H):
                    raise ValueError(f"{name} slots must be (chunks, "
                                     f"{Bl}, {HALO_Q}, {H})")
        if sh["bp"] is not None:
            _check_cuda("bp", sh["bp"], torch.int16, dev)
            if sh["bp"].shape != (num_diags, Bl, Wl):
                raise ValueError(f"bp must be {(num_diags, Bl, Wl)}")
    if blocks < 1 or Wl // blocks < H:
        raise ValueError(f"{blocks} blocks of {Wl} lanes own fewer than "
                         f"H = {H} each")
    R, threads = launch_shape(H + -(-Wl // blocks))
    streams = {k: torch.cuda.Stream(device=shards[k]["state"].device)
               for k in keys}
    callers = {}
    table = torch.zeros((len(keys), _COLS), dtype=torch.int64)
    for i, k in enumerate(keys):
        sh = shards[k]
        dev = sh["state"].device
        if dev not in callers:
            callers[dev] = torch.cuda.current_stream(dev).cuda_stream
        table[i] = torch.tensor([
            sh["a"].data_ptr(), sh["b"].data_ptr(), sh["V1"].data_ptr(),
            sh["V2"].data_ptr(), sh["state"].data_ptr(),
            0 if sh["out"] is None else sh["out"].data_ptr(),
            sh["in"].data_ptr() if "in" in sh else 0,
            0 if sh["bp"] is None else sh["bp"].data_ptr(),
            sh["score"].data_ptr(), streams[k].cuda_stream, dev.index,
            sh["L0"], callers[dev]])
    op_rows = torch.tensor([
        [_KINDS[op[0]], index[op[1]],
         index[op[2]] if op[0] == "wait" else -1,
         op[3] if op[0] == "wait" else op[2] if len(op) > 2 else 0]
        for op in ops], dtype=torch.int32)
    joins = torch.tensor(list(callers.values()), dtype=torch.int64)
    pad = [0] * (MAX_PW - params.num_pw)
    go = [int(x) for x in params.gap_open] + pad
    ge = [int(x) for x in params.gap_extend] + pad
    err = _lib().sharded_gotoh_run(
        table.data_ptr(), len(keys), op_rows.data_ptr(), len(ops), Bl,
        first["a"].shape[1], first["b"].shape[1], int(params.match),
        int(params.mismatch), *go, *ge, params.num_pw, int(lane_is_i),
        int(swap_pref), Wl, H, blocks, num_diags, R, threads,
        joins.data_ptr(), len(joins))
    _raise_on(err, "sharded_gotoh_run")
    kinds = [op[0] for op in ops]
    LAUNCHES += kinds.count("fill")
    HALO_COPIES += kinds.count("copy")
    EVENT_WAITS += kinds.count("wait")
    PROBLEMS += Bl * len(keys)

"""Lane-sharded anti-diagonal Gotoh fill over a list of devices (L5).

The multi-device realization of the reference's po_poa inner loop
(reference alignment.hpp:897-938): the skewed DP state (one anti-diagonal
of M/I/D rows, lanes = positions on the short side) is cut into lane
blocks, one per shard; independent gap matrices are batched on the gap
axis, which needs no communication until the final score gather. The
recurrence is the int32 piecewise-affine Gotoh of ops/gotoh.py, so scores
and alignments agree bit for bit with the single-device fill.

A "mesh" here is a grid of devices, gap rows x lane shards
(make_alignment_mesh), and devices may repeat: several shards on one card,
or on the CPU. One process drives every shard, as the JAX package's single
controller does. Each shard fills its lanes one chunk of H diagonals per
launch (ops/sharded_gotoh.py, csrc/sharded_gotoh.cu on a card, the plain
version on the CPU), its lanes cut into blocks of about BLOCK_LANES, and
publishes its last H lanes; its right neighbour reads them at its next
chunk. On a card every shard has a stream of its own (`chunk_schedule`,
queued by ops/sharded_gotoh_cuda.py::run_schedule): shard s's chunk c
waits only for the event after its left neighbour's chunk c - 1, so the
shards of one card run side by side; between two cards the halo is
copied on the destination's stream after that event. A halo slot per
chunk is never rewritten, and nothing spins between launches. Before
fill_shards returns, the callers' current streams wait for every shard's
stream.

`sharded_gotoh_align` fills one gap with backpointers streamed out of the
fill (uint16, (num_diags, W)), gathers them and walks them on the host;
`sharded_gotoh_scores` fills a batch, score only.

Copy of centrolign_tpu/parallel/sharded_gotoh.py on the port's devices.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import metrics
from ..device import make_context, resolve_device
from ..ops import sharded_gotoh_cuda
from ..ops.align_params import MININF
from ..ops.gotoh_cuda import allocate, check_buffers
from ..ops.gotoh import _build_skew_inputs, _traceback_bp
from ..ops.sharded_gotoh import HALO_Q, block_count, run_schedule_plain

# diagonals a shard fills per launch (at most a shard's lanes), and the
# lanes a block of a shard owns (fewer blocks where one would own fewer
# than H, so at most 2 H - 1: ops/sharded_gotoh.py::block_count); chosen
# by chip_smoke.py's phase 3f (PERF.md)
HALO = 128
BLOCK_LANES = 128


def _bucket(n: int, quantum: int) -> int:
    return max(quantum, -(-n // quantum) * quantum)


def make_alignment_mesh(n_devices: int | None = None,
                        gap_axis: int | None = None, devices=None) -> list:
    """A (gap, lane) grid, a list of gap rows of lane devices, over the
    first n_devices of `devices`. By default the devices of
    CENTROLIGN_TORCH_DEVICE: every card for cuda, n_devices copies of the
    CPU for cpu."""
    if devices is None:
        dev = resolve_device()
        if dev is None:
            raise RuntimeError("CENTROLIGN_TORCH_DEVICE=none has no devices "
                               "to shard over")
        devices = ([dev] * (n_devices or 1) if dev.type == "cpu" else
                   [torch.device("cuda", k)
                    for k in range(torch.cuda.device_count())])
    devs = list(devices)
    n = len(devs) if n_devices is None else n_devices
    if gap_axis is None:
        gap_axis = 2 if n % 2 == 0 and n > 2 else 1
    lane_axis = n // gap_axis
    return [devs[g * lane_axis:(g + 1) * lane_axis] for g in range(gap_axis)]


def _flat(mesh) -> list:
    return [d for row in mesh for d in row]


def chunk_schedule(gap_n: int, lane_n: int, chunks: int, peer) -> list:
    """The order in which fill_shards queues its work, as tuples over the
    shards k = (gap row, lane shard):
    ("start", k)          k's stream waits for the caller's stream;
    ("wait", k, j, c)     k's stream waits for the event after j's chunk c;
    ("copy", k, c)        the left neighbour's halo slot c into k's (peer);
    ("fill", k, c)        k's chunk c (reads the left halo slot c - 1,
                          writes its own slot c);
    ("record", k, c)      the event after k's chunk c;
    ("join", k)           the caller's streams wait for k's last event.
    `peer`: the shards that sit on another device than their left
    neighbour. Run in this order on one stream, or on the CPU, the work
    is also in order."""
    ops = []
    keys = [(g, s) for g in range(gap_n) for s in range(lane_n)]
    ops += [("start", k) for k in keys]
    for c in range(chunks):
        for g, s in keys:
            k = (g, s)
            if s and c:
                ops.append(("wait", k, (g, s - 1), c - 1))
                if k in peer:
                    ops.append(("copy", k, c - 1))
            ops.append(("fill", k, c))
            if (s + 1 < lane_n and c + 1 < chunks) or c + 1 == chunks:
                ops.append(("record", k, c))
    ops += [("join", k) for k in keys]
    return ops


def shard_layout(W: int, lane_n: int, num_diags: int) -> tuple:
    """(Wl, H, blocks, chunks) of a fill of W lanes over lane_n shards:
    a shard's lanes, the diagonals of a chunk, the blocks of a shard and
    the chunks of the fill."""
    Wl = W // lane_n
    H = min(HALO, Wl)
    return Wl, H, block_count(Wl, H, BLOCK_LANES), -(-num_diags // H)


def shard_buffers(mesh, B: int, W: int, num_diags: int,
                  emit_bp: bool) -> dict:
    """The tensors each shard's fill writes, per (gap row, lane shard) of
    `mesh`, as (name, shape, dtype, init) (ops/gotoh_cuda.py::allocate):
    "state" and "score" filled with MININF; "bp" with `emit_bp`; "out",
    one halo slot per chunk so that a slot is never rewritten, on every
    shard but a row's last; "in", its left neighbour's slots copied in,
    on a shard whose left neighbour is on another device."""
    gap_n, lane_n = len(mesh), len(mesh[0])
    if B % gap_n:
        raise ValueError(f"batch {B} must divide the gap axis {gap_n}")
    if W % lane_n:
        raise ValueError(f"{W} lanes do not split over {lane_n} shards")
    Bl = B // gap_n
    Wl, H, _, chunks = shard_layout(W, lane_n, num_diags)
    slots = (chunks, Bl, HALO_Q, H)
    out = {}
    for g, row in enumerate(mesh):
        for s, dev in enumerate(row):
            specs = [("state", (2, Bl, HALO_Q, Wl), torch.int32, MININF),
                     ("score", (Bl,), torch.int32, MININF)]
            if emit_bp:
                specs.append(("bp", (num_diags, Bl, Wl), torch.int16, None))
            if s + 1 < lane_n:
                specs.append(("out", slots, torch.int32, None))
            if s and row[s - 1] != dev:
                specs.append(("in", slots, torch.int32, None))
            out[(g, s)] = specs
    return out


def shard_inputs(a, b, V1, V2, mesh) -> dict:
    """Each shard's inputs, per (gap row, lane shard) of `mesh`: the rows
    of a, b, V1 and V2 (numpy) of its gap row."""
    Bl = a.shape[0] // len(mesh)
    return {(g, s): {name: np.ascontiguousarray(x[g * Bl:(g + 1) * Bl])
                     for name, x in (("a", a), ("b", b), ("V1", V1),
                                     ("V2", V2))}
            for g, row in enumerate(mesh) for s in range(len(row))}


def fill_shards(a, b, V1, V2, params, mesh, num_diags: int,
                lane_is_i: bool, swap_pref: bool, emit_bp: bool,
                chunk=None) -> list:
    """Fill every shard: a (B, W), b (B, Lb), V1, V2 (B,) int32 numpy; B
    split over the gap rows of `mesh`, W over each row's lane shards.
    Returns per gap row the list of its shards' tensors ("score", "bp") on
    their devices, the work queued and the callers' current streams
    waiting for it: shard_inputs and shard_buffers on each shard's device,
    then fill_shards_into."""
    specs = shard_buffers(mesh, *a.shape, num_diags, emit_bp)
    shards = {}
    for k, ins in shard_inputs(a, b, V1, V2, mesh).items():
        dev = mesh[k[0]][k[1]]
        make_context(dev)
        shards[k] = {**{name: torch.from_numpy(x).to(dev)
                        for name, x in ins.items()},
                     **allocate(specs[k], dev)}
    return fill_shards_into(shards, params, mesh, num_diags, lane_is_i,
                            swap_pref, chunk=chunk)


def fill_shards_into(shards: dict, params, mesh, num_diags: int,
                     lane_is_i: bool, swap_pref: bool, chunk=None,
                     jitter: bool = False) -> list:
    """fill_shards over caller-given tensors: `shards` maps each (gap row,
    lane shard) of `mesh` to a dict of its inputs (shard_inputs' names, on
    its device) and its buffers (shard_buffers). By default the schedule
    runs through ops/sharded_gotoh_cuda.py::run_schedule (the kernel on
    cards, or its jitter build with `jitter`; the plain version on the
    CPU); a `chunk` (such as the plain
    ops/sharded_gotoh.py::chunk_fill_plain, on any device) fills every
    chunk in the schedule's serial order instead."""
    gap_n, lane_n = len(mesh), len(mesh[0])
    Bl, W = shards[(0, 0)]["a"].shape
    emit_bp = "bp" in shards[(0, 0)]
    specs = shard_buffers(mesh, gap_n * Bl, W, num_diags, emit_bp)
    Wl, H, blocks, chunks = shard_layout(W, lane_n, num_diags)
    full = {}
    for (g, s), sh in shards.items():
        check_buffers(sh, specs[(g, s)], sh["a"].device)
        full[(g, s)] = {**sh, "L0": s * Wl, "bp": sh.get("bp"),
                        "out": sh.get("out")}
    ops = chunk_schedule(gap_n, lane_n, chunks,
                         {k for k, sh in full.items() if "in" in sh})
    kw = dict(Wl=Wl, H=H, blocks=blocks, num_diags=num_diags,
              lane_is_i=lane_is_i, swap_pref=swap_pref)
    if chunk is None:
        sharded_gotoh_cuda.run_schedule(ops, full, params, jitter=jitter,
                                        **kw)
    else:
        run_schedule_plain(ops, full, params, chunk=chunk, **kw)
    return [[full[(g, s)] for s in range(lane_n)] for g in range(gap_n)]


def gather(rows):
    """(scores (B,) int32, bp (num_diags, B, W) uint16 or None) on the
    host from fill_shards' rows: each problem's opt cell lies on exactly
    one shard, MININF on the others."""
    with_bp = rows[0][0]["bp"] is not None
    with metrics.span("device.wait"):
        scores = [[sh["score"].cpu() for sh in shards] for shards in rows]
        bps = [[sh["bp"].cpu() for sh in shards]
               for shards in rows] if with_bp else None
    scores = np.concatenate([torch.stack(s).amax(0).numpy() for s in scores])
    if not with_bp:
        return scores, None
    bp = torch.cat([torch.cat(s, 2) for s in bps], 1)
    return scores, bp.view(torch.uint16).numpy()


def _fill(a, b, V1, V2, params, mesh, num_diags: int, lane_is_i: bool,
          swap_pref: bool, emit_bp: bool):
    return gather(fill_shards(a, b, V1, V2, params, mesh, num_diags,
                              lane_is_i, swap_pref, emit_bp))


def sharded_gotoh_align(seq1, seq2, params, mesh, swap_pref: bool = False):
    """One gap matrix, lane-sharded over every device of `mesh` (a grid or
    a flat list), backpointers streamed out of the fill, traceback on the
    host over the gathered matrix. Alignment and score are bit-identical to
    the single-device ops/gotoh.py::gotoh_align."""
    devs = _flat(mesh) if mesh and isinstance(mesh[0], list) else list(mesh)
    s1 = np.asarray(seq1, dtype=np.int32)
    s2 = np.asarray(seq2, dtype=np.int32)
    V1, V2 = len(s1), len(s2)
    lane_is_i = V1 <= V2
    W = _bucket((V1 if lane_is_i else V2) + 1, 128 * len(devs))
    num_diags = V1 + V2 + 1
    a, b = _build_skew_inputs(s1, s2, lane_is_i, W, num_diags + 128)
    score, bp = _fill(a[None], b[None], np.array([V1], np.int32),
                      np.array([V2], np.int32), params, [devs], num_diags,
                      lane_is_i, swap_pref, emit_bp=True)
    aln = _traceback_bp(bp[:, 0, :], V1, V2, lane_is_i, params.num_pw)
    return aln, int(score[0])


def sharded_gotoh_scores(seqs1, seqs2, params, mesh) -> np.ndarray:
    """Global alignment scores for a batch of sequence pairs, lane-sharded
    over each gap row of `mesh`. Scores are bit-identical to
    ops/gotoh.py::gotoh_align."""
    B = len(seqs1)
    if B % len(mesh):
        raise ValueError(f"batch {B} must divide the gap axis {len(mesh)}")
    lane_n = len(mesh[0])
    V1s = np.array([len(s) for s in seqs1], dtype=np.int32)
    V2s = np.array([len(s) for s in seqs2], dtype=np.int32)
    lane_is_i = bool(np.max(V1s) <= np.max(V2s))
    short = V1s if lane_is_i else V2s
    W = _bucket(int(short.max()) + 1, 128 * lane_n)
    num_diags = int(np.max(V1s + V2s)) + 1
    b_cap = num_diags + 128
    a_all = np.empty((B, W), np.int32)
    b_all = np.empty((B, 2 * W + b_cap), np.int32)
    for k in range(B):
        a_all[k], b_all[k] = _build_skew_inputs(
            np.asarray(seqs1[k], dtype=np.int32),
            np.asarray(seqs2[k], dtype=np.int32), lane_is_i, W, b_cap)
    scores, _ = _fill(a_all, b_all, V1s, V2s, params, mesh, num_diags,
                      lane_is_i, False, emit_bp=False)
    return scores

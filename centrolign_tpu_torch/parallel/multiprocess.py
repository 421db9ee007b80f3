"""True multi-process execution: one process per "host" under
torch.distributed, completed subproblems exchanged between hosts THROUGH
collectives.

This is the counterpart of ``parallel.scheduler`` (which uses an
in-machine process pool and pickled arrays). Here every host is a separate
process, a rank of one process group:

 - every rank calls ``torch.distributed.init_process_group`` with the
   gloo backend, the address ``tcp://127.0.0.1:<port>``, the world size and
   its rank. The payload is host bytes (GFA text, pickled alignments), so
   gloo moves it on the CPU on a card's machine too: NCCL would copy it to
   the card and back, and refuses two ranks on one card.
 - each rank resolves its own device (device.resolve_device); with several
   cards, rank r takes card r mod the number of cards, so ranks may share
   a card, each with its own CUDA context.
 - all ranks parse the same FASTA + guide tree (and apply the same
   Parameters blob), so every rank derives the identical layer schedule
   (``Execution.independent_layers``) and the identical deterministic
   SIZE-BALANCED assignment: within a layer, pending subproblems are
   assigned heaviest-first (DP-cost proxy n1*n2 + n1 + n2) to the
   least-loaded rank, so one huge join does not serialize a layer the way
   positional round-robin can.
 - at the layer barrier, each completed subproblem's graph is serialized
   to GFA text — exactly the reference's checkpoint/restart contract
   (reference src/execution.cpp:223-279) — and all-gathered across ranks
   as a padded uint8 payload. Every rank (owners included) re-parses the
   exchanged GFA so all hosts hold bit-identical subproblem state. When
   side outputs need them (-s / 2-sequence CIGAR), the fused alignments
   ride the same payload.

Coverage matches the serial path and the pool scheduler: calibration
(size-balanced across ranks), cyclization (-c: per-leaf bonding rounds
distributed, bond alignments all-gathered in leaf order), checkpointing
(-S: rank 0 emits every subproblem in serial execution order plus the
bonds checkpoint), restart (-R: every rank replays the shared checkpoint
directory before scheduling), subalignments (-s) and induced pairwise
outputs on rank 0.

Determinism: emit -> parse -> continue reproduces the serial bytes, so the
multi-process output equals the serial run regardless of host count or
scheduling (tests/test_torch_multiprocess.py).

Each rank sends its kernel-launch counters back to the parent, which sums
them in counters.MERGED (parallel/counters.py) and returns them per rank.

Run via ``python -m centrolign_tpu_torch.parallel.multiprocess <n> <fasta>
[tree]`` (rank 0 writes the final GFA to stdout) or programmatically with
``run_multiprocess_msa``; the CLI routes here when
CENTROLIGN_TPU_EXECUTOR=jaxdist and more than one host is requested.

Copy of centrolign_tpu/parallel/multiprocess.py, with jax.distributed and
multihost_utils.process_allgather replaced by torch.distributed.
"""

from __future__ import annotations

import io
import multiprocessing as mp
import os
import pickle
import queue
import sys

import numpy as np
import torch
import torch.distributed as dist

from . import counters


def balanced_assignment(weights, n_procs):
    """Deterministic size-balanced assignment: heaviest item first to the
    least-loaded rank (ties -> lowest rank). Every rank computes the same
    mapping from the same replicated state."""
    order = sorted(range(len(weights)), key=lambda i: (-weights[i], i))
    load = [0.0] * n_procs
    rank_of = [0] * len(weights)
    for i in order:
        r = min(range(n_procs), key=lambda x: (load[x], x))
        rank_of[i] = r
        load[r] += weights[i]
    return rank_of


def _rank_device(rank: int):
    """This rank's device: resolve_device(), and with several cards card
    rank mod the number of cards."""
    from ..device import resolve_device
    device = resolve_device()
    if device is not None and device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device


def _rank_main(rank: int, n_procs: int, port: int, fasta: str,
               tree_path: str | None, out_path: str | None,
               params_blob: bytes | None, results) -> None:
    # ranks inherit the parent CLI's stdout, which may be the user's GFA
    # destination, so move fd 1 onto stderr for the whole rank (keeping the
    # original for the out_path=None stdout-writing case)
    orig_stdout_fd = os.dup(1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n_procs, rank=rank)
    assert dist.get_world_size() == n_procs
    device = _rank_device(rank)
    counters.reset()
    counters.DEVICE = str(device)

    from ..core import (Core, pairwise_align_step, fuse_step,
                        leaf_intrinsic_scale, leaf_bond_alignments)
    from ..io.fasta import parse_fasta
    from ..io.gfa import write_gfa, read_gfa
    from ..modify_graph import add_sentinels
    from ..tree import Tree, in_order_newick_string

    with open(fasta) as f:
        seqs = parse_fasta(f)
    if tree_path:
        with open(tree_path) as f:
            tree = Tree(f.read())
    else:
        tree = Tree(in_order_newick_string([n for n, _ in seqs]))
    core = Core(seqs, tree, device)
    if params_blob is not None:
        params = pickle.loads(params_blob)
        params.apply(core)
        do_restart = params.get("restart")
    else:
        do_restart = False
    if len(seqs) == 2:
        core.preserve_subproblems = True
    if do_restart:
        # every rank replays the shared checkpoint directory, so the
        # completed-subproblem state (and any bonds checkpoint) is
        # replicated without a collective
        core.restart()
    ex = core.main_execution
    cyclic = core.cyclize_tandem_duplications
    restarted = core._restarted_bond_alignments is not None
    bond_alignments = core._restarted_bond_alignments if restarted else []
    want_alignments = bool(core.subalignments_filepath
                           or core.preserve_subproblems)
    # -S/-s need child graphs alive for rank 0's deferred emit loop;
    # cyclization needs the root graph for apply_bonds; otherwise drop
    # each layer's consumed children (mirrors the pool scheduler)
    keep_graphs = bool(core.preserve_subproblems
                       or core.subalignments_filepath
                       or core.subproblems_prefix
                       or cyclic)

    def exchange_bytes(local: bytes) -> list[bytes]:
        """All-gather one byte payload per rank (padded to the global max
        so shapes agree across processes)."""
        n = torch.tensor([len(local)], dtype=torch.int64)
        sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(n_procs)]
        dist.all_gather(sizes, n)
        sizes = [int(x) for x in sizes]
        buf = torch.zeros(max(max(sizes), 1), dtype=torch.uint8)
        buf[:len(local)] = torch.frombuffer(bytearray(local),
                                            dtype=torch.uint8)
        gathered = [torch.empty_like(buf) for _ in range(n_procs)]
        dist.all_gather(gathered, buf)
        return [gathered[r][:sizes[r]].numpy().tobytes()
                for r in range(n_procs)]

    def exchange_items(mine: list) -> list:
        """Allgather a list of picklable items from every rank, returned
        concatenated in rank order."""
        out = []
        for blob in exchange_bytes(pickle.dumps(
                mine, protocol=pickle.HIGHEST_PROTOCOL)):
            if blob:
                out.extend(pickle.loads(blob))
        return out

    # ---- calibration: leaves size-balanced across hosts, scales (and,
    # under -c, each leaf's bonding-round alignments) allgathered.
    # Restart semantics mirror the serial path (core.execute,
    # core.py:230-241): a restarted run RE-runs the scale calibration
    # (bonds come from the restored checkpoint) unless -skip-calibration.
    leaves = list(ex.leaf_subproblems())
    scales = {}
    run_calibration = ((restarted and not core.skip_calibration)
                       or (not restarted
                           and (not core.skip_calibration or cyclic)))
    if run_calibration:
        from .. import logging as logmod
        logmod.log(logmod.Basic,
                   "Calibrating scale of anchoring parameters."
                   if not cyclic else
                   "Calibrating scale of anchoring parameters and "
                   "identifying tandem duplications.")
        rank_of = balanced_assignment(
            [s.graph.node_size for s in leaves], n_procs)
        mine = []
        leaf_state = {}
        for i, sub in enumerate(leaves):
            if rank_of[i] == rank:
                scale, matches, chain = leaf_intrinsic_scale(
                    sub, core.max_count, core.score_function, core.anchorer)
                leaf_state[i] = (matches, chain)
                # repr() round-trips floats exactly
                mine.append((i, repr(float(scale))))
        for i, s in exchange_items(mine):
            scales[i] = float(s)
        assert len(scales) == len(leaves)
        if not core.skip_calibration and scales:
            core.score_function.score_scale = float(
                np.mean([scales[i] for i in range(len(leaves))]))

        if cyclic and not restarted:
            mine = []
            for i, (matches, chain) in sorted(leaf_state.items()):
                alns, raw = leaf_bond_alignments(
                    leaves[i], scales[i], matches, chain, core.anchorer,
                    core.bonder, core.stitcher,
                    core.max_tandem_duplication_search_rounds,
                    collect_raw=bool(core.bonds_prefix))
                mine.append((i, alns, raw))
            gathered = sorted(exchange_items(mine))
            for i, alns, raw in gathered:
                if core.bonds_prefix and rank == 0:
                    for k, raw_aln in enumerate(raw):
                        core.output_bond_alignment(
                            raw_aln, leaves[i].graph, 0, k)
                bond_alignments.extend(alns)
            if core.subproblems_prefix and rank == 0:
                core.emit_restart_bonds(bond_alignments)

    # ---- layer-wise MSA with GFA payload exchange at each barrier
    from .. import logging as logmod
    logmod.log(logmod.Minimal, "Beginning MSA.")
    computed = set()
    layers = ex.independent_layers()
    for li, layer in enumerate(layers):
        pending = [n for n in layer if not ex.subproblems[n].complete]
        logmod.log(logmod.Basic,
                   f"Executing layer {li + 1} of {len(layers)} "
                   f"({len(pending)} subproblem(s)) across {n_procs} "
                   "host(s).")
        weights = []
        for node_id in pending:
            c1, c2 = ex.tree.get_children(node_id)
            n1 = ex.subproblems[c1].graph.node_size
            n2 = ex.subproblems[c2].graph.node_size
            weights.append(float(n1) * float(n2) + n1 + n2)
        rank_of = balanced_assignment(weights, n_procs)
        mine = []
        for pos, node_id in enumerate(pending):
            computed.add(node_id)
            if rank_of[pos] != rank:
                continue
            c1, c2 = ex.tree.get_children(node_id)
            s1, s2 = ex.subproblems[c1], ex.subproblems[c2]
            alignment = pairwise_align_step(
                s1, s2, core.max_count, core.score_function,
                core.anchorer, core.partitioner, core.stitcher,
                memory_restraint_size=core.memory_restraint_size)
            graph, tableau = fuse_step(s1, s2, alignment,
                                       preserve=keep_graphs)
            buf = io.StringIO()
            write_gfa(graph, tableau, buf)
            mine.append((pos, buf.getvalue(),
                         alignment if want_alignments else None))
        for pos, text, alignment in exchange_items(mine):
            node_id = pending[pos]
            sub = ex.subproblems[node_id]
            # every rank — owner included — adopts the exchanged GFA,
            # so all hosts hold bit-identical graphs
            sub.graph = read_gfa(io.StringIO(text))
            sub.tableau = add_sentinels(sub.graph, 5, 6)
            sub.alignment = alignment
            sub.complete = True
        if not keep_graphs:
            for node_id in layer:
                for c in ex.tree.get_children(node_id):
                    ex.subproblems[c].graph = None

    if rank == 0:
        # ---- side outputs in serial execution order (byte-identical
        # files), then the cyclization epilogue, then the final GFA
        if core.subalignments_filepath or core.subproblems_prefix:
            for node_id in ex.execution_order:
                if node_id not in computed:
                    continue
                parent = ex.subproblems[node_id]
                if core.subalignments_filepath:
                    c1, c2 = ex.tree.get_children(node_id)
                    core.emit_subalignment(parent, ex.subproblems[c1],
                                           ex.subproblems[c2])
                if core.subproblems_prefix:
                    core.emit_subproblem(parent)
        if core.induced_pairwise_prefix:
            core.output_pairwise_alignments(False)
        if cyclic:
            core.apply_bonds(bond_alignments)
            if core.induced_pairwise_prefix:
                core.output_pairwise_alignments(True)
        root = core.root_subproblem()
        out = (open(out_path, "w") if out_path
               else os.fdopen(os.dup(orig_stdout_fd), "w"))
        write_gfa(root.graph, root.tableau, out)
        out.close()
    results.put((rank, counters.snapshot()))
    dist.barrier()
    dist.destroy_process_group()


def run_multiprocess_msa(n_procs: int, fasta: str, tree_path: str | None,
                         out_path: str, port: int = 0,
                         params=None) -> list:
    """Spawn `n_procs` ranks and run the MSA across them; rank 0 writes the
    final GFA to `out_path`. `params` (a Parameters object) is pickled to
    every rank and applied to its Core — this carries -S/-R/-c/-s/--bonds
    configuration into the distributed run. Returns each rank's counters
    (parallel/counters.py), which are also summed in counters.MERGED."""
    if port == 0:
        import socket
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
    blob = pickle.dumps(params) if params is not None else None
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_procs, port, fasta, tree_path, out_path
                               if r == 0 else None, blob, results))
             for r in range(n_procs)]
    for p in procs:
        p.start()
    snaps = {}
    while len(snaps) < n_procs:
        try:
            rank, snap = results.get(timeout=1.0)
            snaps[rank] = snap
        except queue.Empty:
            if not any(p.is_alive() for p in procs):
                break
    for p in procs:
        p.join()
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad or len(snaps) < n_procs:
        raise RuntimeError(f"multiprocess ranks failed: exit codes "
                           f"{[p.exitcode for p in procs]}")
    for r in range(n_procs):
        counters.merge(snaps[r])
    return [snaps[r] for r in range(n_procs)]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    n = int(argv[0])
    fasta = argv[1]
    tree = argv[2] if len(argv) > 2 else None
    # None -> rank 0 writes to its original stdout (fd 1 itself is moved
    # to stderr inside the ranks to keep gloo's output out of the GFA)
    out = argv[3] if len(argv) > 3 and argv[3] else None
    run_multiprocess_msa(n, fasta, tree, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

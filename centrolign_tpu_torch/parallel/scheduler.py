"""Multi-host subproblem scheduler: layer-wise data parallelism over the
guide tree.

The reference executes subproblems strictly serially (reference
src/execution.cpp:83-124); sibling subtrees are independent, so the guide
tree decomposes into dependency layers (Execution.independent_layers) whose
members can run on different hosts concurrently. This module dispatches each
layer over a pool of worker processes and gathers the fused parent graphs
for the next layer.

Process model / transport: one OS process per "host", started by `spawn`
(a forked child cannot use a CUDA context made in its parent). Each worker
resolves its own device through device.resolve_device(), so it runs the
kernels on the card unless CENTROLIGN_TORCH_DEVICE says otherwise; several
workers may share one card, each with its own CUDA context (the kernels
built under _build/ are cached and the build is locked). What is pickled
to a worker carries a torch.device at most, never a tensor. The unit of
exchange (a completed subproblem's graph) is exactly the reference's
checkpoint contract (GFA per subproblem, reference
src/execution.cpp:223-279). In-process transport uses pickled graph arrays
so distributed results are bit-identical to the serial path (GFA text is
the durable on-disk form; -S files written by the main process match the
serial run byte-for-byte).

Determinism: every subproblem's result depends only on its two children and
the calibrated parameters, so the distributed output is byte-identical to
the serial run regardless of worker count or completion order.

Coverage: the colinear pipeline (calibration + progressive MSA + all of
-s/-S/-A/CIGAR outputs), cyclization (-c, bonding rounds dispatched per
layer with cross-round mask state carried in the main process), and
checkpoint restart (-R resumes into the layered schedule); see
distributed_execute() below and tests/test_torch_scheduler.py.

Each worker task returns its kernel-launch counters with its result, and
the parent sums them in counters.MERGED (parallel/counters.py). A failed
worker is recomputed in the parent, on the parent's device.

Copy of centrolign_tpu/parallel/scheduler.py.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from .. import logging as logmod
from . import counters


def _test_failure_hook() -> None:
    """Failure injection for the recovery tests: '1' raises in the worker
    (the future carries the exception), '2' kills the worker process
    outright (the pool breaks and must be rebuilt)."""
    mode = os.environ.get("CENTROLIGN_TPU_TEST_WORKER_FAIL", "0")
    if mode == "1":
        raise RuntimeError("injected worker failure (test hook)")
    if mode == "2":
        os._exit(1)


def _on_own_device(anchorer, stitcher=None) -> None:
    """Place the unpickled anchorer's (and stitcher's) device tier on this
    worker's device, and zero its counters for the task."""
    from ..device import resolve_device
    device = resolve_device()
    anchorer.device = device
    if stitcher is not None:
        stitcher.device = device
    counters.reset()
    counters.DEVICE = str(device)


def _worker_align(cfg_bytes, payload1, payload2):
    """Run one pairwise subproblem: returns pickled ((graph, tableau,
    alignment) of the fused parent, kernel counters)."""
    _test_failure_hook()
    from ..core import pairwise_align_step, fuse_step
    from ..execution import Subproblem
    (max_count, score_function, anchorer, partitioner, stitcher,
     memory_restraint_size) = pickle.loads(cfg_bytes)
    _on_own_device(anchorer, stitcher)
    sub1, sub2 = Subproblem(), Subproblem()
    sub1.graph, sub1.tableau = pickle.loads(payload1)
    sub2.graph, sub2.tableau = pickle.loads(payload2)
    alignment = pairwise_align_step(
        sub1, sub2, max_count, score_function, anchorer, partitioner,
        stitcher, memory_restraint_size=memory_restraint_size)
    graph, tableau = fuse_step(sub1, sub2, alignment)
    return pickle.dumps(((graph, tableau, alignment), counters.snapshot()),
                        protocol=pickle.HIGHEST_PROTOCOL)


def _worker_scale(cfg_bytes, payload):
    """Per-leaf intrinsic-scale estimate (calibration)."""
    _test_failure_hook()
    from ..core import leaf_intrinsic_scale
    from ..execution import Subproblem
    max_count, score_function, anchorer = pickle.loads(cfg_bytes)
    _on_own_device(anchorer)
    sub = Subproblem()
    sub.graph, sub.tableau = pickle.loads(payload)
    scale, _matches, _chain = leaf_intrinsic_scale(
        sub, max_count, score_function, anchorer)
    return float(scale), counters.snapshot()


def _worker_leaf_bonds(cfg_bytes, payload):
    """One leaf's full tandem-duplication bonding rounds (-c). The worker
    re-derives the leaf's self-matches (cheaper than shipping them) and runs
    the round loop with the already-calibrated global scale baked into the
    pickled anchorer, so results are byte-identical to the serial pass."""
    _test_failure_hook()
    from ..core import leaf_intrinsic_scale, leaf_bond_alignments
    from ..execution import Subproblem
    (max_count, score_function, anchorer, bonder, stitcher, max_rounds,
     collect_raw) = pickle.loads(cfg_bytes)
    _on_own_device(anchorer, stitcher)
    sub = Subproblem()
    sub.graph, sub.tableau, sub.name, scale = pickle.loads(payload)
    _scale, matches, chain = leaf_intrinsic_scale(
        sub, max_count, score_function, anchorer)
    bond_alns, raw_alns = leaf_bond_alignments(
        sub, scale, matches, chain, anchorer, bonder, stitcher, max_rounds,
        collect_raw=collect_raw)
    return pickle.dumps(((bond_alns, raw_alns), counters.snapshot()),
                        protocol=pickle.HIGHEST_PROTOCOL)


_pool = None
_pool_hosts = 0
# worker failures recomputed in the parent, over the process's life
RECOVERED = 0


def _worker_pool(n_hosts: int) -> ProcessPoolExecutor:
    """Process pool reused across calls: spawn + package import (torch,
    and a CUDA context at first use) in a fresh worker costs seconds,
    which would otherwise land on every run's first layer."""
    global _pool, _pool_hosts
    if _pool is None or _pool_hosts != n_hosts:
        if _pool is not None:
            _pool.shutdown(wait=False)
        _pool = ProcessPoolExecutor(max_workers=n_hosts,
                                    mp_context=mp.get_context("spawn"))
        _pool_hosts = n_hosts
    return _pool


def _rebuild_pool(n_hosts: int) -> ProcessPoolExecutor:
    """Discard a (possibly broken) pool and spawn a fresh one: after a
    worker dies (OOM kill, CUDA fault) the executor refuses further
    submissions, but the scheduler can keep going — failed subproblems are
    recomputed inline and later layers get new workers."""
    global _pool
    if _pool is not None:
        _pool.shutdown(wait=False)
        _pool = None
    return _worker_pool(n_hosts)


def distributed_execute(core, n_hosts: int) -> None:
    """Drive Core's pipeline with layer-parallel subproblem dispatch across
    `n_hosts` worker processes — including cyclization (-c, whose per-leaf
    bonding rounds fan out one leaf per worker) and checkpoint restarts
    (already-complete subproblems are skipped layer by layer)."""
    ex = core.main_execution
    tree = ex.tree
    cyclic = core.cyclize_tandem_duplications
    restarted = core._restarted_bond_alignments is not None
    bond_alignments = core._restarted_bond_alignments if restarted else []
    # -S needs every computed graph alive for the deferred emit loop below;
    # cyclization needs the root graph for apply_bonds
    keep_graphs = bool(core.preserve_subproblems
                       or core.subalignments_filepath
                       or core.subproblems_prefix
                       or cyclic
                       or len(ex.execution_order) == 1)

    pool = _worker_pool(n_hosts)
    failed = [False]

    def _recover(what: str, exc: BaseException):
        """Worker-failure path: log, remember to rebuild the pool before the
        next fan-out, and let the caller recompute inline. Failure of a
        worker is never fatal — the main process holds every input."""
        global RECOVERED
        RECOVERED += 1
        logmod.log(logmod.Minimal,
                   f"Worker failed during {what} ({type(exc).__name__}: "
                   f"{exc}); recomputing locally.")
        failed[0] = True

    def _fresh_pool():
        nonlocal pool
        if failed[0]:
            pool = _rebuild_pool(n_hosts)
            failed[0] = False
        return pool

    def _submit(what, fn, *args):
        """submit() itself can raise once a worker has died (broken pool);
        a None future tells the gather site to recompute inline."""
        try:
            return pool.submit(fn, *args)
        except Exception as e:  # BrokenProcessPool, RuntimeError on shutdown
            _recover(what, e)
            return None

    def _gather_scales(futs, scale_leaves):
        from ..core import leaf_intrinsic_scale
        out = []
        for f, s in zip(futs, scale_leaves):
            try:
                if f is None:
                    raise RuntimeError("submission failed")
                scale, snap = f.result()
                counters.merge(snap)
                out.append(float(scale))
            except Exception as e:
                _recover(f"calibration of {s.name}", e)
                out.append(float(leaf_intrinsic_scale(
                    s, core.max_count, core.score_function,
                    core.anchorer)[0]))
        return out

    # ---- calibration: per-leaf scale estimates, embarrassingly
    # parallel (reference src/core.cpp:122-175 runs them serially).
    # The main process overlaps calibration with the first layer's
    # scale-INDEPENDENT work (match finding + reachability for the
    # subproblem it will run inline, core.prepare_pair_step) — the
    # calibrated scale is only read at anchoring. When there is no
    # first-layer work to overlap, the last leaf runs inline instead of
    # idling while workers spawn.
    layers = ex.independent_layers()
    inline_prepared = None
    inline_node = None
    if not cyclic and not restarted and layers:
        first_pending = [n for n in layers[0]
                         if not ex.subproblems[n].complete]
        if first_pending:
            inline_node = first_pending[-1]
    scales = []
    leaves = list(ex.leaf_subproblems())
    if not core.skip_calibration or cyclic:
        logmod.log(logmod.Basic,
                   "Calibrating scale of anchoring parameters."
                   if not cyclic else
                   "Calibrating scale of anchoring parameters and "
                   "identifying tandem duplications.")
        cfg0 = pickle.dumps(
            (core.max_count, core.score_function, core.anchorer))
        from ..core import leaf_intrinsic_scale, prepare_pair_step
        inline_leaves = leaves if inline_node is not None else leaves[:-1]
        futs = [_submit(f"calibration of {s.name}", _worker_scale, cfg0,
                        pickle.dumps((s.graph, s.tableau)))
                for s in inline_leaves]
        if inline_node is not None:
            c1, c2 = tree.get_children(inline_node)
            inline_prepared = prepare_pair_step(
                ex.subproblems[c1], ex.subproblems[c2], core.max_count,
                core.score_function,
                memory_restraint_size=core.memory_restraint_size)
            scales = _gather_scales(futs, inline_leaves)
        else:
            inline_scale = (float(leaf_intrinsic_scale(
                leaves[-1], core.max_count, core.score_function,
                core.anchorer)[0]) if leaves else 0.0)
            scales = _gather_scales(futs, inline_leaves) + (
                [inline_scale] if leaves else [])
        for sub, scale in zip(leaves, scales):
            logmod.log(logmod.Debug,
                       f"Computed intrinsic scale of {scale} for "
                       f"sequence {sub.name}")
        if not core.skip_calibration and scales:
            core.score_function.score_scale = float(np.mean(scales))

    # ---- cyclization: the per-leaf bonding rounds are independent
    # once the global scale is fixed — one leaf per worker
    if cyclic and not restarted:
        cfg1 = pickle.dumps(
            (core.max_count, core.score_function, core.anchorer,
             core.bonder, core.stitcher,
             core.max_tandem_duplication_search_rounds,
             bool(core.bonds_prefix)))
        _fresh_pool()
        futs = [_submit(f"bonding rounds of {s.name}",
                        _worker_leaf_bonds, cfg1,
                        pickle.dumps((s.graph, s.tableau, s.name,
                                      scales[i])))
                for i, s in enumerate(leaves)]
        for i, (sub, fut) in enumerate(zip(leaves, futs)):
            try:
                if fut is None:
                    raise RuntimeError("submission failed")
                (alns, raw), snap = pickle.loads(fut.result())
                counters.merge(snap)
            except Exception as e:
                _recover(f"bonding rounds of {sub.name}", e)
                from ..core import (leaf_intrinsic_scale,
                                    leaf_bond_alignments)
                _s, matches, chain = leaf_intrinsic_scale(
                    sub, core.max_count, core.score_function, core.anchorer)
                alns, raw = leaf_bond_alignments(
                    sub, scales[i], matches, chain, core.anchorer,
                    core.bonder, core.stitcher,
                    core.max_tandem_duplication_search_rounds,
                    collect_raw=bool(core.bonds_prefix))
            if core.bonds_prefix:
                for k, raw_aln in enumerate(raw):
                    core.output_bond_alignment(raw_aln, sub.graph, 0, k)
            bond_alignments.extend(alns)
        if core.subproblems_prefix:
            core.emit_restart_bonds(bond_alignments)

    # ---- layer-wise progressive MSA
    logmod.log(logmod.Minimal, "Beginning MSA.")
    cfg = pickle.dumps((core.max_count, core.score_function,
                        core.anchorer, core.partitioner, core.stitcher,
                        core.memory_restraint_size))
    computed = set()
    for li, layer in enumerate(layers):
        logmod.log(logmod.Basic,
                   f"Executing layer {li + 1} of {len(layers)} "
                   f"({len(layer)} subproblem(s)) across {n_hosts} "
                   "host(s).")
        pending = [node_id for node_id in layer
                   if not ex.subproblems[node_id].complete]
        # the last subproblem of every layer runs inline in the main
        # process: no pickling round-trip, and its CUDA context and
        # kernels are already warm
        _fresh_pool()
        futs = {}
        for node_id in pending[:-1]:
            c1, c2 = tree.get_children(node_id)
            s1, s2 = ex.subproblems[c1], ex.subproblems[c2]
            futs[node_id] = _submit(
                f"subproblem {node_id}", _worker_align, cfg,
                pickle.dumps((s1.graph, s1.tableau)),
                pickle.dumps((s2.graph, s2.tableau)))
        if pending:
            from ..core import pairwise_align_step, fuse_step
            node_id = pending[-1]
            c1, c2 = tree.get_children(node_id)
            s1, s2 = ex.subproblems[c1], ex.subproblems[c2]
            parent = ex.subproblems[node_id]
            prepared = (inline_prepared
                        if li == 0 and node_id == inline_node else None)
            parent.alignment = pairwise_align_step(
                s1, s2, core.max_count, core.score_function,
                core.anchorer, core.partitioner, core.stitcher,
                memory_restraint_size=core.memory_restraint_size,
                prepared=prepared)
            # preserve=keep_graphs: the deferred emit loop below may
            # still need the child graphs the in-place fuse would
            # otherwise consume (workers operate on pickled copies, so
            # only the inline node needs this)
            parent.graph, parent.tableau = fuse_step(
                s1, s2, parent.alignment, preserve=keep_graphs)
            parent.complete = True
            computed.add(node_id)
        for node_id, fut in futs.items():
            try:
                if fut is None:
                    raise RuntimeError("submission failed")
                (graph, tableau, alignment), snap = pickle.loads(
                    fut.result())
                counters.merge(snap)
            except Exception as e:
                _recover(f"subproblem {node_id}", e)
                from ..core import pairwise_align_step, fuse_step
                c1, c2 = tree.get_children(node_id)
                s1, s2 = ex.subproblems[c1], ex.subproblems[c2]
                alignment = pairwise_align_step(
                    s1, s2, core.max_count, core.score_function,
                    core.anchorer, core.partitioner, core.stitcher,
                    memory_restraint_size=core.memory_restraint_size)
                graph, tableau = fuse_step(s1, s2, alignment,
                                           preserve=keep_graphs)
            parent = ex.subproblems[node_id]
            parent.graph = graph
            parent.tableau = tableau
            parent.alignment = alignment
            parent.complete = True
            computed.add(node_id)
        if not keep_graphs:
            for node_id in layer:
                for c in tree.get_children(node_id):
                    ex.subproblems[c].graph = None

    # ---- side outputs, emitted in the serial execution order so the
    # files are byte-identical to a serial run
    if core.subalignments_filepath or core.subproblems_prefix:
        for node_id in ex.execution_order:
            if node_id not in computed:
                continue
            parent = ex.subproblems[node_id]
            if core.subalignments_filepath:
                c1, c2 = tree.get_children(node_id)
                core.emit_subalignment(parent, ex.subproblems[c1],
                                       ex.subproblems[c2])
            if core.subproblems_prefix:
                core.emit_subproblem(parent)

    if core.induced_pairwise_prefix:
        core.output_pairwise_alignments(False)

    # ---- cyclization epilogue (reference src/core.cpp:594-648): merge the
    # bond alignments into the root graph and polish, exactly as the serial
    # path does after its MSA
    if cyclic:
        core.apply_bonds(bond_alignments)
        if core.induced_pairwise_prefix:
            logmod.log(logmod.Verbose,
                       "Outputting non-colinear pairwise alignments")
            core.output_pairwise_alignments(True)

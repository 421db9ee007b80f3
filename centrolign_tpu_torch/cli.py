"""Command-line interface of the port (reference src/main.cpp:23-315): the
options, outputs and config files of centrolign_tpu/cli.py (CIGAR for
exactly two sequences, GFA otherwise), with the device tier on the device
that CENTROLIGN_TORCH_DEVICE names (cuda by default; see device.py).

    python -m centrolign_tpu_torch.cli [options] seqs.fasta > out

Not ported yet: --hosts N > 1 (the pool and jax.distributed executors).
"""

from __future__ import annotations

import argparse
import os
import sys

from . import logging as logmod
from .alignment import explicit_cigar
from .core import Core
from .device import resolve_device
from .io.fasta import parse_fasta
from .io.gfa import write_gfa
from .params import Parameters
from .tree import Tree, in_order_newick_string
from .utils.memory import format_memory_usage, max_memory_usage


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="centrolign_tpu_torch",
        description="MSA of megabase tandem-repeat DNA on an NVIDIA GPU")
    ap.add_argument("fasta", nargs="?", default="")
    ap.add_argument("-T", "--tree", default="")
    ap.add_argument("-A", "--all-pairs", default="")
    ap.add_argument("-S", "--all-subprobs", default="")
    ap.add_argument("-s", "--subalignments", default="")
    ap.add_argument("-c", "--cyclize", action="store_true")
    ap.add_argument("-y", "--cyclizing-size", type=int, default=None)
    ap.add_argument("-m", "--max-count", type=int, default=None)
    ap.add_argument("-a", "--max-anchors", type=int, default=None)
    ap.add_argument("-p", "--count-power", type=float, default=None)
    ap.add_argument("-g", "--chain-alg", type=int, default=None)
    ap.add_argument("-u", "--no-unaln", action="store_true")
    ap.add_argument("-v", "--verbosity", type=int, default=None)
    ap.add_argument("-C", "--config", default="")
    ap.add_argument("-G", "--generate-config", action="store_true")
    ap.add_argument("-R", "--restart", action="store_true")
    ap.add_argument("-t", "--threads", type=int, default=None)
    ap.add_argument("--skip-calibration", action="store_true")
    ap.add_argument("--force-gfa-output", action="store_true")
    ap.add_argument("--bond-prefix", default="")
    # extension over the reference CLI: layer-parallel subproblem dispatch
    # across worker processes/hosts (not ported yet: main() refuses N > 1)
    ap.add_argument("--hosts", type=int, default=None)
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    params = Parameters()
    if args.fasta:
        params.set("fasta_name", args.fasta)
    if args.tree:
        params.set("tree_name", args.tree)
    if args.all_pairs:
        params.set("all_pairs_prefix", args.all_pairs)
    if args.all_subprobs:
        params.set("subproblems_prefix", args.all_subprobs)
    if args.subalignments:
        params.set("subalignments_filepath", args.subalignments)
    if args.cyclize:
        params.set("cyclize_tandem_duplications", True)
    if args.cyclizing_size is not None:
        params.set("min_cyclizing_length", args.cyclizing_size)
    if args.max_count is not None:
        params.set("max_count", args.max_count)
    if args.max_anchors is not None:
        params.set("max_num_match_pairs", args.max_anchors)
    if args.count_power is not None:
        params.set("pair_count_power", args.count_power)
    if args.chain_alg is not None:
        params.set("chaining_algorithm", args.chain_alg)
    if args.no_unaln:
        # reference -u/--no-unaln (main.cpp:131-133): disable the
        # alignability partition, treat everything as alignable
        params.set("constraint_method", 0)
    if args.verbosity is not None:
        params.set("logging_level", args.verbosity)
    if args.restart:
        params.set("restart", True)
    if args.threads is not None:
        params.set("threads", args.threads)
    if args.skip_calibration:
        params.set("skip_calibration", True)
    if args.bond_prefix:
        params.set("bonds_prefix", args.bond_prefix)

    if args.generate_config:
        sys.stdout.write(params.generate_config())
        return 0

    if args.config:
        if params != Parameters():
            print("warning: All other command-line arguments are being "
                  "overridden by config file parameters.\n",
                  file=sys.stderr)
        try:
            with open(args.config) as f:
                params = Parameters(f.read())
        except (OSError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1

    try:
        params.validate()
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    logmod.level = params.get("logging_level")

    n_hosts = args.hosts if args.hosts is not None else int(
        os.environ.get("CENTROLIGN_TPU_HOSTS", "1"))
    if n_hosts > 1 or os.environ.get("CENTROLIGN_TPU_EXECUTOR") == "jaxdist":
        print("error: multi-host execution (--hosts > 1, "
              "CENTROLIGN_TPU_EXECUTOR=jaxdist) is not yet ported",
              file=sys.stderr)
        return 1
    try:
        device = resolve_device()
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    try:
        with open(params.get("fasta_name")) as f:
            parsed = parse_fasta(f)
    except OSError as e:
        print(f"error: could not open FASTA file "
              f"{params.get('fasta_name')}: {e.strerror}", file=sys.stderr)
        return 1
    if len(parsed) < 2:
        print(f"error: FASTA input contains {len(parsed)} sequence(s), "
              "cannot form an alignment", file=sys.stderr)
        return 1
    seq_names = [name for name, _ in parsed]

    if params.get("tree_name"):
        with open(params.get("tree_name")) as f:
            newick = f.read()
    else:
        if len(seq_names) > 2:
            print("warning: it is highly recommended to provide a guide tree "
                  "(-T) when aligning > 2 sequences", file=sys.stderr)
        newick = in_order_newick_string(seq_names)
    tree = Tree(newick)

    core = Core(parsed, tree, device)
    if len(seq_names) == 2:
        params.set("preserve_subproblems", True)
    params.apply(core)
    if params.get("restart"):
        core.restart()
    core.execute()

    if len(seq_names) == 2 and not args.force_gfa_output:
        root = core.root_subproblem()
        leaf1 = core.leaf_subproblem(seq_names[0])
        leaf2 = core.leaf_subproblem(seq_names[1])
        sys.stdout.write(explicit_cigar(
            root.alignment, leaf1.graph.labels, leaf2.graph.labels) + "\n")
    else:
        root = core.root_subproblem()
        write_gfa(root.graph, root.tableau, sys.stdout)

    max_mem = max_memory_usage()
    if max_mem < 0:
        logmod.log(logmod.Basic, "Failed to measure memory usage.")
    else:
        logmod.log(logmod.Basic,
                   "Maximum memory usage: " + format_memory_usage(max_mem)
                   + ".")
    logmod.log(logmod.Minimal, "Run completed successfully, exiting.")
    return 0


if __name__ == "__main__":
    sys.exit(main())

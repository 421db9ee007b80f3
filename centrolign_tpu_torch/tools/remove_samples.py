"""Remove samples from a (root-subproblem) GFA, optionally regrafting the
guide tree (reference src/scripts/remove_samples.cpp).

Usage: python -m centrolign_tpu_torch.tools.remove_samples [options]
           -s sample [-s sample2 ...] -p output_prefix graph.gfa

 --prefix / -p PREF      Prefix for graph output (required)
 --sample / -s SAMP      Sample to remove from the graph (may repeat)
 --tree-in / -t FILE     Guide tree for the graph in Newick format
 --tree-out / -T FILE    Output for the tree with the removed sample(s)
                         regrafted to outer branches (requires --tree-in)
 --fasta-pref / -f PREF  Prefix for FASTAs containing the removed samples

The pruned graph lands at the -S checkpoint filename the REMAINING sample
set's root subproblem would use (the reference builds a dummy Core for
the name; the digest scheme is shared, so a restarted centrolign run can
pick the file up directly), with uncovered nodes purged.

Copy of centrolign_tpu/tools/remove_samples.py, run with the port's Core
(on the card unless CENTROLIGN_TORCH_DEVICE=cpu).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(add_help=True)
    ap.add_argument("-p", "--prefix", required=True)
    ap.add_argument("-s", "--sample", action="append", default=[])
    ap.add_argument("-t", "--tree-in", default="")
    ap.add_argument("-T", "--tree-out", default="")
    ap.add_argument("-f", "--fasta-pref", default="")
    ap.add_argument("gfa")
    args = ap.parse_args(argv)

    if not args.sample:
        print("error: at least one --sample is required", file=sys.stderr)
        return 1
    if args.tree_out and not args.tree_in:
        print("error: --tree-out requires --tree-in to be provided",
              file=sys.stderr)
        return 1
    if args.tree_in and not args.tree_out:
        print("warning: --tree-in is unused without --tree-out",
              file=sys.stderr)

    import numpy as np

    from ..core import Core
    from ..graph import BaseGraph
    from ..io.gfa import read_gfa, write_gfa
    from ..modify_graph import add_sentinels, purge_uncovered_nodes
    from ..tree import Tree, in_order_newick_string

    removed = set(args.sample)
    try:
        with open(args.gfa) as f:
            graph = read_gfa(f)
    except OSError:
        print(f"error: failed to open {args.gfa}", file=sys.stderr)
        return 1

    pruned = BaseGraph()
    pruned.add_nodes(np.asarray(graph.labels))
    ef, et = graph.edges()
    if len(ef):
        pruned.add_edges(np.asarray(ef, dtype=np.int64),
                         np.asarray(et, dtype=np.int64))

    retained = []
    removed_seen = []
    for pid in range(graph.path_size):
        name = graph.path_name(pid)
        if name in removed:
            removed_seen.append(name)
            if args.fasta_pref:
                from ..utils.encoding import decode_seq
                path = np.asarray(graph.path(pid))
                seq = decode_seq(np.asarray(graph.labels)[path])
                fasta = f"{args.fasta_pref}_{name}.fasta"
                with open(fasta, "w") as f:
                    f.write(f">{name}\n")
                    for i in range(0, len(seq), 80):
                        f.write(seq[i:i + 80] + "\n")
        else:
            new_pid = pruned.add_path(name)
            pruned.extend_path_array(new_pid, np.asarray(graph.path(pid)))
            retained.append(name)

    if len(removed_seen) != len(removed):
        print("error: not all samples provided were in the graph",
              file=sys.stderr)
        return 1

    tableau = add_sentinels(pruned, 5, 6)
    pruned = purge_uncovered_nodes(pruned, tableau)

    # the output filename is the -S checkpoint name the retained sample
    # set's ROOT subproblem would get (reference CoreNamer; shared digest
    # scheme — restart interop tests prove the filenames match)
    namer = Core([(s, "N") for s in retained],
                 Tree(in_order_newick_string(retained)))
    namer.subproblems_prefix = args.prefix
    out_path = namer._subproblem_path(namer.main_execution.tree.get_root())

    try:
        with open(out_path, "w") as f:
            write_gfa(pruned, tableau, f)
    except OSError:
        print(f"error: failed to write to {out_path}", file=sys.stderr)
        return 1

    if args.tree_out:
        try:
            with open(args.tree_in) as f:
                newick = f.read()
        except OSError:
            print(f"error: failed to read from {args.tree_in}",
                  file=sys.stderr)
            return 1
        tree = Tree(newick)
        keep_ids = [v for v in range(tree.node_size)
                    if tree.is_leaf(v) and tree.label(v) not in removed]
        tree.prune(keep_ids)
        tree.compact()
        retained_newick = tree.to_newick()

        num_parens = len(removed)
        if tree.node_size == 0 and len(retained) == 1:
            num_parens = 0
        ordered = sorted(removed)
        out = ["(" * num_parens]
        i = 0
        while retained_newick[i] != ";":
            out.append(retained_newick[i])
            i += 1
        for k, name in enumerate(ordered):
            if k < num_parens:
                out.append(",")
            out.append(f'"{name}":0')
            if k < num_parens:
                out.append(")")
        out.append(";\n")
        with open(args.tree_out, "w") as f:
            f.write("".join(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

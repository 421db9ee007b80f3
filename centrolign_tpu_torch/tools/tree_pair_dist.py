"""All leaf-pair tree distances (reference src/scripts/tree_pair_dist.cpp).

Usage: python -m centrolign_tpu_torch.tools.tree_pair_dist tree.nwk > pair_dists.tsv

Output: "sample1\tsample2\tdistance" per unordered leaf pair, leaves in
node-id order, exactly the reference's iteration and formatting.

Copy of centrolign_tpu/tools/tree_pair_dist.py.
"""

from __future__ import annotations

import sys


def fmt(x: float) -> str:
    """C++ default ostream double formatting (6 significant digits)."""
    return f"{x:.6g}"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("usage:\ntree_pair_dist tree.nwk > pair_dists.tsv",
              file=sys.stderr)
        return 1
    try:
        with open(argv[0]) as f:
            newick = f.read()
    except OSError:
        print(f"error: could not open tree file {argv[0]}", file=sys.stderr)
        return 1

    from ..tree import Tree
    from ..utils.queries import TreeDistanceOracle

    tree = Tree(newick)
    oracle = TreeDistanceOracle(tree)
    leaves = [n for n in range(tree.node_size) if tree.is_leaf(n)]
    out = sys.stdout
    out.write("sample1\tsample2\tdistance\n")
    for i in range(len(leaves)):
        for j in range(i + 1, len(leaves)):
            out.write(f"{tree.label(leaves[i])}\t{tree.label(leaves[j])}"
                      f"\t{fmt(oracle.distance(leaves[i], leaves[j]))}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

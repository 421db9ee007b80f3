"""Subtree-correctness comparison of two guide trees (reference
src/scripts/tree_compare.cpp).

Usage: python -m centrolign_tpu_torch.tools.tree_compare truth.nwk compare.nwk
       > subtree_correctness.tsv

For every non-trivial bipartition of the truth tree (an internal node with
total degree > 2), prints "height\tsize\tfound" where height is the node's
min leaf distance (ultrametric-robust two-pass DP), size is the smaller
side of the bipartition, and found is 1 iff the comparison tree contains
the same bipartition (label sets normalized to the side containing the
lexicographically first leaf, deduplicated along non-branching paths
keeping the smallest height). Output rows follow the truth tree's
(label-set, height)-sorted, deduplicated table order — byte-identical to
the reference tool.

Copy of centrolign_tpu/tools/tree_compare.py.
"""

from __future__ import annotations

import sys


def _fmt(x: float) -> str:
    return f"{x:.6g}"


def partition_table(tree):
    """(height, sorted label set) per non-trivial bipartition, normalized,
    sorted by (label set, height), deduplicated by label set — the exact
    construction of tree_compare.cpp::partition_table."""
    n = tree.node_size
    INF = float("inf")
    height = [INF] * n
    for node_id in tree.postorder():
        if tree.is_leaf(node_id):
            height[node_id] = 0.0
        if node_id != tree.get_root():
            p = tree.get_parent(node_id)
            height[p] = min(height[p],
                            height[node_id] + tree.distance(node_id))
    for node_id in tree.preorder():
        if node_id != tree.get_root():
            p = tree.get_parent(node_id)
            height[node_id] = min(height[node_id],
                                  height[p] + tree.distance(node_id))

    labels = sorted(tree.label(v) for v in range(n) if tree.is_leaf(v))
    first = labels[0]
    label_all = set(labels)

    # NB: the reference assigns label_sets ONLY at leaves and at nodes
    # with total degree > 2 (tree_compare.cpp:96-119) — an internal node
    # of degree <= 2 (unary chains, a binary root) keeps an EMPTY set, so
    # its leaves are silently absent from every ancestor's set. Parity
    # requires replicating that, not "fixing" it.
    rows = []
    label_sets = [[] for _ in range(n)]
    for node_id in tree.postorder():
        if tree.is_leaf(node_id):
            label_sets[node_id] = [tree.label(node_id)]
            continue
        children = tree.get_children(node_id)
        degree = len(children) + (0 if node_id == tree.get_root() else 1)
        if degree <= 2:
            continue
        merged = []
        for c in children:
            merged.extend(label_sets[c])
            label_sets[c] = []
        merged.sort()
        label_sets[node_id] = merged
        if merged and merged[0] == first:
            rows.append((height[node_id], list(merged)))
        else:
            inside = set(merged)
            rows.append((height[node_id],
                         [x for x in labels if x not in inside]))
    assert label_all  # non-empty tree
    rows.sort(key=lambda r: (r[1], r[0]))
    dedup = []
    for h, s in rows:
        if dedup and dedup[-1][1] == s:
            continue
        dedup.append((h, s))
    return dedup


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 2:
        print("usage:\ntree_compare truth_tree.nwk compare_tree.nwk "
              "> subtree_correctness.tsv", file=sys.stderr)
        return 1
    trees = []
    for path in argv:
        try:
            with open(path) as f:
                newick = f.read()
        except OSError:
            print(f"error: could not open tree file {path}",
                  file=sys.stderr)
            return 1
        from ..tree import Tree
        trees.append(Tree(newick))
    truth, compare = trees

    num_leaves = 0
    for v in range(truth.node_size):
        if truth.is_leaf(v):
            lbl = truth.label(v)
            assert lbl and compare.has_label(lbl) \
                and compare.is_leaf(compare.get_id(lbl))
            num_leaves += 1
    for v in range(compare.node_size):
        if compare.is_leaf(v):
            lbl = compare.label(v)
            assert lbl and truth.has_label(lbl) \
                and truth.is_leaf(truth.get_id(lbl))

    truth_table = partition_table(truth)
    compare_rows = {tuple(s) for _h, s in partition_table(compare)}
    out = sys.stdout
    for h, s in truth_table:
        found = 1 if tuple(s) in compare_rows else 0
        out.write(f"{_fmt(h)}\t{min(len(s), num_leaves - len(s))}"
                  f"\t{found}\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

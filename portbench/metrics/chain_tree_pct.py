"""chain_tree_pct: the share of the SparseAffine-chained anchors that the tree engine chained, 100 x (chain.tree + chain.tree_fallback) over those and chain.cdq, over the window's jobs (the program's metrics.summary() counters); None where no job has them."""

TREE = ("chain.tree", "chain.tree_fallback")


def read(run):
    tree = cdq = 0
    for j in run["jobs"]:
        dp = j.get("dp", {})
        tree += sum(dp[t]["cells"] for t in TREE if t in dp)
        cdq += dp["chain.cdq"]["cells"] if "chain.cdq" in dp else 0
    return 100.0 * tree / (tree + cdq) if tree + cdq else None

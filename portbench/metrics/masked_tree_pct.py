"""masked_tree_pct: the share of -c's masked chainings' anchors that the tree engine chained, 100 x chain.masked_tree over chain.masked_tree and chain.masked_cdq, over the window's jobs (the program's metrics.summary() counters); None where no job has either."""

TAGS = ("chain.masked_tree", "chain.masked_cdq")


def read(run):
    tree = cdq = 0
    for j in run["jobs"]:
        dp = j.get("dp", {})
        tree += dp[TAGS[0]]["cells"] if TAGS[0] in dp else 0
        cdq += dp[TAGS[1]]["cells"] if TAGS[1] in dp else 0
    return 100.0 * tree / (tree + cdq) if tree + cdq else None

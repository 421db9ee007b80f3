"""chain_ms_per_kbp: reachability and chaining (path_merge.py, anchorer.py, chain_ties.py, native chaining), ms a kbp."""

from portbench import measures


def read(run):
    return measures.stage_ms_per_kbp(run, ("reach_chain",))

"""device_cell_pct: the share of the stitch's DP cells that went to the card (the program's metrics.summary() counters)."""

from portbench import measures


def read(run):
    return measures.device_cell_pct(run)

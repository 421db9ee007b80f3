"""partition_ms_per_kbp: partition (partitioner.py), ms a kbp."""

from portbench import measures


def read(run):
    return measures.stage_ms_per_kbp(run, ("partition",))

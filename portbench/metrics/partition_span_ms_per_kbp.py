"""partition_span_ms_per_kbp: self time of the program's partition span, partition (partitioner.partition_anchors), ms a kbp."""

from portbench import spans


def read(run):
    return spans.self_ms_per_kbp(run, ("partition",))

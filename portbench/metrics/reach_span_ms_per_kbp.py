"""reach_span_ms_per_kbp: self time of the program's reach span, reachability (PathMerge or PackedPathMerge of both graphs), ms a kbp."""

from portbench import spans


def read(run):
    return spans.self_ms_per_kbp(run, ("reach",))

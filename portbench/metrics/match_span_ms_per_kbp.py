"""match_span_ms_per_kbp: self time of the program's match span, match finding (sentinel reassignment and find_matches), ms a kbp."""

from portbench import spans


def read(run):
    return spans.self_ms_per_kbp(run, ("match",))

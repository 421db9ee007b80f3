"""stitch_span_ms_per_kbp: self time of the program's stitch span, the stitch's host work outside its aligners and device waits: extraction, classification, translation, dispatch, ms a kbp."""

from portbench import spans


def read(run):
    return spans.self_ms_per_kbp(run, ("stitch",))

"""host_align_span_ms_per_kbp: self time of the program's stitch.align span, the stitch's deferred host aligners, ms a kbp."""

from portbench import spans


def read(run):
    return spans.self_ms_per_kbp(run, ("stitch.align",))

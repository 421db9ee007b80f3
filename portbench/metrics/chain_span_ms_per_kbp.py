"""chain_span_ms_per_kbp: self time of the program's chain span, chaining (anchorer.anchor_chain), ms a kbp."""

from portbench import spans


def read(run):
    return spans.self_ms_per_kbp(run, ("chain",))

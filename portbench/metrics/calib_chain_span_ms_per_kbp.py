"""calib_chain_span_ms_per_kbp: self time of the program's calibration.chain span, calibration's gap-free chain (ChainMerge and estimate_score_scale), ms a kbp."""

from portbench import spans


def read(run):
    return spans.self_ms_per_kbp(run, ("calibration.chain",))

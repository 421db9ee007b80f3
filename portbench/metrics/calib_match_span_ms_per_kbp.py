"""calib_match_span_ms_per_kbp: self time of the program's calibration.match span, calibration's self-match finding (find_matches of each leaf against itself), ms a kbp."""

from portbench import spans


def read(run):
    return spans.self_ms_per_kbp(run, ("calibration.match",))

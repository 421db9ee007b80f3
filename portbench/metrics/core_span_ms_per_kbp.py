"""core_span_ms_per_kbp: self time of the program's job, setup, calibration, subproblem, fuse and output spans, the CLI and core outside the stages, ms a kbp."""

from portbench import spans


def read(run):
    return spans.self_ms_per_kbp(run, ("job", "setup", "calibration",
                                       "subproblem", "fuse", "output"))

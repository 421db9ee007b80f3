"""calibration_ms_per_kbp: calibration (core.py's leaf scale), ms a kbp."""

from portbench import measures


def read(run):
    return measures.stage_ms_per_kbp(run, ("calibration",))

"""match_ms_per_kbp: match finding (match_finder.py, native esa.cpp), ms a kbp."""

from portbench import measures


def read(run):
    return measures.stage_ms_per_kbp(run, ("match",))

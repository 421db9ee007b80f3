"""stitch_ms_per_kbp: stitch (stitcher.py, native popoa.cpp and wfa.cpp, the chain tier), ms a kbp."""

from portbench import measures


def read(run):
    return measures.stage_ms_per_kbp(run, ("stitch",))

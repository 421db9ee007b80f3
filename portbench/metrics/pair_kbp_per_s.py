"""pair_kbp_per_s: input kbp of the window's pairwise jobs over the time from the window's start to the end of its last job (host clock)."""

from portbench import measures


def read(run):
    return measures.kbp_per_s(run)

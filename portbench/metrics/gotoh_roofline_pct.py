"""gotoh_roofline_pct: the chain tier's Gotoh kernels (csrc/gotoh.cu): the least time their jobs need over their device time (profiler trace)."""

from portbench import measures


def read(run):
    return measures.gotoh_roofline_pct(run)

"""device_idle_pct: the share of the traced window in which no kernel or copy ran on the card (profiler trace)."""

from portbench import measures


def read(run):
    return measures.device_idle_pct(run)

"""peak_rss_mib: the client's ru_maxrss, read at the end of its first window job (host)."""

from portbench import measures


def read(run):
    return measures.peak_rss_mib(run)

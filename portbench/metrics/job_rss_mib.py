"""job_rss_mib: the median over the window's jobs of each job's growth of the client's resident set, sampled every 20 ms by the harness (host)."""

from portbench import measures


def read(run):
    return measures.job_rss_mib(run)

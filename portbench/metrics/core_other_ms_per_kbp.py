"""core_other_ms_per_kbp: CLI and core (cli.py, core.py): the stage split's setup, fuse and end, ms a kbp."""

from portbench import measures


def read(run):
    return measures.stage_ms_per_kbp(run, measures.CORE_OTHER)

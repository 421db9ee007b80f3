"""load_s: seconds of the client's once-per-process spans (load.native, load.cuda, device.init) as its first window job reports them."""

from portbench import spans


def read(run):
    return spans.load_s(run)

"""device_wait_ms_per_kbp: self time of the program's device.wait span, the host blocked on the card, at every copy that waits for its kernels, ms a kbp."""

from portbench import spans


def read(run):
    return spans.self_ms_per_kbp(run, ("device.wait",))

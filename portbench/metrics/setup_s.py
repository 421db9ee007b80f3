"""setup_s: seconds from the harness's start to the window's: imports, the card's contexts, the client's warm-up, and the simulated inputs made meanwhile (host clock)."""


def read(run):
    return run["setup_s"]

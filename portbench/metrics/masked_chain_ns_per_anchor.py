"""masked_chain_ns_per_anchor: nanoseconds a chained anchor of -c's masked chainings, the program's chain.masked counter's seconds over its anchors, summed over the window's jobs (the tree engine's cost apart from the number of rounds); None where no job has the counter."""


def read(run):
    anchors = seconds = 0
    for j in run["jobs"]:
        c = j.get("dp", {}).get("chain.masked")
        if c:
            anchors += c["cells"]
            seconds += c["seconds"]
    return seconds * 1e9 / anchors if anchors else None

"""bond_internal_stitch_ms_per_kbp: -c's internal stitches, the whole time of the program's stitch spans whose parent is bond.stitch (their aligners and device waits included), ms a kbp; None where no job has one."""


def read(run):
    jobs = [j for j in run["jobs"] if j["dp"].get("spans")]
    ns, found = 0, False
    for j in jobs:
        spans = j["dp"]["spans"]
        for name, parent, start, end in spans:
            if (name == "stitch" and parent >= 0
                    and spans[parent][0] == "bond.stitch"):
                ns += end - start
                found = True
    if not found:
        return None
    return ns / 1e6 / sum(j["kbp"] for j in jobs)

"""bond_host_span_ms_per_kbp: self time of the program's bond.chain, bond.identify and bond.stitch spans, -c's host work around chaining and stitching (the mask's generation and update, identify_bonds and deduplicate_self_bonds, the internal stitches' step translation), ms a kbp; None where no job has bond.identify, which splits the bond identification from bond.chain."""

from portbench import spans


def read(run):
    if not any(s[0] == "bond.identify" for j in run["jobs"]
               for s in j["dp"].get("spans", ())):
        return None
    return spans.self_ms_per_kbp(run, ("bond.chain", "bond.identify",
                                       "bond.stitch"))

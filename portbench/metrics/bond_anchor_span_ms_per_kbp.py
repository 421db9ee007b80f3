"""bond_anchor_span_ms_per_kbp: self time of the program's bond.anchor span, -c's masked self-chaining (anchorer.anchor_chain of a leaf against itself), ms a kbp; None where no job has the span."""

from portbench import spans


def read(run):
    if not any(s[0] == "bond.anchor" for j in run["jobs"]
               for s in j["dp"].get("spans", ())):
        return None
    return spans.self_ms_per_kbp(run, ("bond.anchor",))

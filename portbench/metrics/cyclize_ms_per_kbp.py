"""cyclize_ms_per_kbp: self time of the program's cyclize span and its children cyclize.fuse (the bonds fused into the root graph) and cyclize.simplify (its bubbles simplified), and of its polish span (a realignment subproblem inside it counts to the subproblem's stems), ms a kbp; None where no job has cyclize."""

from portbench import spans


def read(run):
    if not any(s[0] == "cyclize" for j in run["jobs"]
               for s in j["dp"].get("spans", ())):
        return None
    return spans.self_ms_per_kbp(
        run, ("cyclize", "cyclize.fuse", "cyclize.simplify", "polish"))

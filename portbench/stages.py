"""Frozen copy of chip_smoke.py's stage split: the seconds of each stage
of a CLI run, from the elapsed stamps of its own log at -v 3
(centrolign_tpu_torch/logging.py, 0.1 s resolution).

Copied unchanged from chip_smoke.py (STAMP through `stage_split`, with
STAGE_MARKS and the messages they name). `stamps` is added: each stamp's
seconds and the stage it starts, which the traced run uses to say what the
client was doing during the card's idle gaps. Later PRs do not edit this
file; a program whose log changes its messages is refused by
`stage_split`, not measured wrong.
"""

from __future__ import annotations

import re

STAMP = re.compile(r"^\[centrolign_tpu\] elapsed: (\d+):(\d\d):(\d\d\.\d) "
                   r"(.*)$")
NEXT_SUBPROBLEM = "Next subproblem contains sequences"
# -c: each bonding round of a leaf (core.py::leaf_bond_alignments) chains
# the leaf against itself with its self-matches masked, then stitches each
# tandem duplication it found; after the MSA the root is cyclized and
# polished (core.py::apply_bonds)
BOND_ROUND = "Beginning round "
BOND_FOUND = "Found "
CYCLIZE = "Cyclizing the final graph"
POLISH = "Polishing inconsistencies"
ROUND = re.compile(r"Beginning round (\d+) of tandem duplication detection "
                   r"for sequence (.*)\.$")
FOUND = re.compile(r"Found (\d+) tandem duplications in this round\.$")
# a message that starts a stage (its prefix) -> the stage; an unlisted
# message continues the stage before it
STAGE_MARKS = (
    ("Initializing leaf subproblems", "setup"),
    ("Calibrating scale of anchoring parameters", "calibration"),
    (BOND_ROUND, "bond_chain"),
    (BOND_FOUND, "bond_stitch"),
    ("Beginning MSA", "setup"),
    # sentinel reassignment, then match finding (core.py::prepare_pair_step)
    (NEXT_SUBPROBLEM, "match"),
    ("Finding matches", "match"),
    ("Computing reachability", "reach_chain"),
    ("Chained ", "partition"),
    ("Partitioned into ", "stitch"),
    ("Fusing MSAs", "fuse"),
    (CYCLIZE, "cyclize"),
    (POLISH, "polish"),
    ("Peak memory usage", "end"),
    ("Maximum memory usage", "end"),
    ("Run completed", "end"),
)
SUBPROBLEM_STAGES = ("match", "reach_chain", "partition", "stitch", "fuse")
# the messages every subproblem logs (core.py), one starting each of its
# stages: a log that lacks one (a message renamed) is refused, as its time
# would go to the stage before it
SUBPROBLEM_MARKS = tuple(p for p, name in STAGE_MARKS
                         if name in SUBPROBLEM_STAGES and p != NEXT_SUBPROBLEM)
# the -c messages whose loss stage_split refuses: a round's start and the
# count that ends its chaining, the cyclizing and the polish after it
CYCLIZE_MARKS = (BOND_ROUND, BOND_FOUND, CYCLIZE, POLISH)


def stage_split(log):
    """Seconds of each stage in a CLI log written at -v 3: "setup" (leaf
    subproblems, up to calibration and between calibration and the first
    subproblem), "calibration", with -c one dict per bonding round
    ("bonding": its "sequence", "round", the tandem duplications "found",
    and the seconds of its masked self-chaining, "chain", and of its
    internal stitches, "stitch"), one dict per subproblem ("sequences":
    its leaves, and the SUBPROBLEM_STAGES: match finding, reachability
    plus chaining, partition, stitch, fuse), with -c "cyclize" (the bonds
    fused into the root) and "polish", and "end" (from the memory report
    on). Each interval between two stamps goes to the stage the first of
    them started. The stamps have 0.1 s resolution. Raises ValueError
    when a subproblem lacks one of the SUBPROBLEM_MARKS, a bonding round
    its start or its count, cyclizing its polish, or a run whose rounds
    found tandem duplications its cyclizing."""
    events = []  # [tenths of a second, message, continuation lines]
    for line in log.splitlines():
        m = STAMP.match(line)
        if m:
            h, mi, s, msg = m.groups()
            tenths = (int(h) * 60 + int(mi)) * 600 + int(s.replace(".", ""))
            events.append([tenths, msg, []])
        elif events and line.startswith("\t"):
            events[-1][2].append(line.strip())
    split = {"setup": 0, "calibration": 0, "bonding": [], "subproblems": [],
             "cyclize": 0, "polish": 0, "end": 0}
    seen = []  # the SUBPROBLEM_MARKS each subproblem logged
    stage = "setup"
    for k, (t, msg, names) in enumerate(events):
        for prefix, name in STAGE_MARKS:
            if msg.startswith(prefix):
                if stage == "bond_chain" and name != "bond_stitch":
                    raise ValueError(f"bonding round {len(split['bonding'])} "
                                     f"of the log has no message starting "
                                     f"with {BOND_FOUND!r}")
                if stage == "cyclize" and name != "polish":
                    raise ValueError(f"the log has no message starting with "
                                     f"{POLISH!r} after {CYCLIZE!r}")
                if prefix == NEXT_SUBPROBLEM:
                    split["subproblems"].append(
                        {"sequences": names,
                         **{s_: 0 for s_ in SUBPROBLEM_STAGES}})
                    seen.append(set())
                elif prefix == BOND_ROUND:
                    rnd, seq = ROUND.match(msg).groups()
                    split["bonding"].append(
                        {"sequence": seq, "round": int(rnd), "found": 0,
                         "chain": 0, "stitch": 0})
                elif prefix == BOND_FOUND:
                    if stage != "bond_chain":
                        raise ValueError(f"{msg!r} in the log follows no "
                                         f"message starting with "
                                         f"{BOND_ROUND!r}")
                    split["bonding"][-1]["found"] = int(FOUND.match(msg)[1])
                elif seen:
                    seen[-1].add(prefix)
                stage = name
                break
        if k + 1 == len(events):
            break
        dt = events[k + 1][0] - t
        if stage in SUBPROBLEM_STAGES and split["subproblems"]:
            split["subproblems"][-1][stage] += dt
        elif stage in ("bond_chain", "bond_stitch"):
            split["bonding"][-1][stage[5:]] += dt
        else:
            split[stage] += dt
    if stage == "bond_chain":
        raise ValueError(f"bonding round {len(split['bonding'])} of the log "
                         f"has no message starting with {BOND_FOUND!r}")
    if stage == "cyclize":
        raise ValueError(f"the log has no message starting with {POLISH!r} "
                         f"after {CYCLIZE!r}")
    if any(r["found"] for r in split["bonding"]) and not any(
            msg.startswith(CYCLIZE) for _, msg, _ in events):
        raise ValueError(f"the log's bonding rounds found tandem "
                         f"duplications but it has no message starting "
                         f"with {CYCLIZE!r}")
    for k, marks in enumerate(seen):
        missing = [p for p in SUBPROBLEM_MARKS if p not in marks]
        if missing:
            raise ValueError(f"subproblem {k + 1} of the log has no message "
                             f"starting with {missing}")
    for part in (split, *split["bonding"], *split["subproblems"]):
        for key, v in part.items():
            if isinstance(v, int) and key not in ("round", "found"):
                part[key] = v / 10
    return split


def stamps(log):
    """[(seconds since the log's clock started, stage)] for each stamp of
    the log that starts a stage (STAGE_MARKS), in order; a subproblem's
    stages as named in SUBPROBLEM_STAGES."""
    out = []
    for line in log.splitlines():
        m = STAMP.match(line)
        if not m:
            continue
        h, mi, s, msg = m.groups()
        for prefix, name in STAGE_MARKS:
            if msg.startswith(prefix):
                out.append(((int(h) * 60 + int(mi)) * 60 + float(s), name))
                break
    return out

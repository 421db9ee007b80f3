"""The one generator of every traffic mix: simulated cohorts of centromeric
HOR arrays, turned into CLI jobs in an order drawn from the run's seed.

A configuration fixes the deployment: its "mode" ("pairs": every pair of
a cohort's haplotypes, one CIGAR each; "msa": the whole cohort down the
configuration's guide tree, one GFA), the cohort's "tree" (the simulator's
generations on each branch; its leaves are the haplotypes), the
"ancestor" and its "annotation" under portbench/, the simulator's
"rates" (the tool's defaults where unset), the "cli_args" every job
adds, and optionally "params", upstream parameters that a parameter file
written for each job sets (`jobs_of`). A traffic mix fixes the load:

- "cohorts": cohorts simulated for a run, all from the mix's
  "data_seed", so that every run has the same work (runs whose cohorts
  came from their own seeds differed by up to a fifth, PERF.md);
- "jobs_per_run" (optional): only that many of the cohorts' jobs, the
  same ones in every run, drawn from the data seed.

A run has one closed-loop client, a process on the card that starts its
next job when its last one ends: the jobs in an order drawn from the
run's seed, cycled.

`cohorts` simulates the cohorts, `jobs_of` writes the run's jobs' inputs
under a directory and `order` orders them. The warm-up pair
(`warmup_fasta`) is made from the ancestor and the run's seed.
"""

from __future__ import annotations

import itertools
import os

import numpy as np

from . import simulate
from .reference import paramfile

HERE = os.path.dirname(os.path.abspath(__file__))


def _seed_words(seed: int) -> list:
    """A seed of any sign and size as the non-negative words numpy's
    SeedSequence takes."""
    seed = int(seed)
    words = [1 if seed < 0 else 0]
    seed = abs(seed)
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            return words


def rng(seed: int, *streams: int) -> np.random.Generator:
    return np.random.default_rng([*_seed_words(seed), *streams])


def write_fasta(path: str, records) -> None:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                f.write(seq[i:i + 80] + "\n")


def ancestor(config: dict, base: str = HERE) -> simulate.EvSeq:
    """The configuration's annotated ancestor; its files are named
    relative to `base`, the benchmark's directory."""
    return simulate.initialize_sequence(
        os.path.join(base, config["ancestor"]),
        os.path.join(base, config["annotation"]))


def cohorts(config: dict, traffic: dict, root) -> list:
    """[{leaf label: sequence}] of the mix's cohorts, in simulation order,
    from the annotated ancestor `root`."""
    out = []
    for c in range(traffic["cohorts"]):
        cohort_seed = int(rng(traffic["data_seed"], 1, c).integers(0, 2 ** 63))
        out.append(simulate.evolve_tree(root, config["tree"],
                                        config.get("rates", {}), cohort_seed))
    return out


def job_sets(config: dict, groups: list) -> list:
    """(cohort index, leaf labels) of each job of the cohorts: every pair
    of a cohort's leaves ("pairs"), or the whole cohort ("msa")."""
    mode = config["mode"]
    if mode not in ("pairs", "msa"):
        raise ValueError(f"unknown mode {mode!r}")
    sets = []
    for c, cohort in enumerate(groups):
        labels = list(cohort)
        if mode == "pairs":
            sets += [(c, pair) for pair in itertools.combinations(labels, 2)]
        else:
            sets.append((c, tuple(labels)))
    return sets


def chosen(n_sets: int, traffic: dict) -> list:
    """The indices of the jobs a run sends, in job order: all of them, or
    "jobs_per_run" of them drawn from the data seed."""
    k = traffic.get("jobs_per_run")
    if k is None or k >= n_sets:
        return list(range(n_sets))
    perm = rng(traffic["data_seed"], 4).permutation(n_sets)
    return sorted(int(x) for x in perm[:k])


def jobs_of(config: dict, groups: list, out_dir: str, traffic: dict,
            trace: bool = False) -> list:
    """The run's jobs of the cohorts: {"id", "fasta", "argv", "kbp",
    "output", "params"} each, their inputs written under out_dir. A job's
    argv is the configuration's "cli_args", then "-T <tree>" in msa mode,
    then the FASTA; where the configuration states "params" (upstream
    parameters, reference/paramfile.py) it is the "cli_args", then
    "-C <file>", the job's parameter file beside its FASTA, which carries
    logging level 3 when `trace` (the traced run's stage split reads the
    -v 3 log), and the job's "params" is true."""
    jobs = []
    mode = config["mode"]
    params = config.get("params")
    sets = job_sets(config, groups)
    for s in chosen(len(sets), traffic):
        c, names = sets[s]
        cohort = groups[c]
        k = len(jobs)
        fasta = os.path.join(out_dir, f"job{k}.fasta")
        write_fasta(fasta, [(n, cohort[n]) for n in names])
        argv = [*config.get("cli_args", [])]
        tree = None
        if mode == "msa":
            tree = os.path.join(out_dir, f"job{k}.nwk")
            with open(tree, "w") as f:
                f.write(config["tree"].strip() + "\n")
        if params is None:
            argv += [*(["-T", tree] if tree else []), fasta]
        else:
            cfg = os.path.join(out_dir, f"job{k}.cfg")
            paramfile.write(cfg, params, fasta, tree, 3 if trace else None)
            argv += ["-C", cfg]
        jobs.append({"id": k, "cohort": c, "names": list(names),
                     "fasta": fasta, "argv": argv,
                     "kbp": sum(len(cohort[n]) for n in names) / 1000,
                     "output": config["output"],
                     "params": params is not None})
    return jobs


def order(jobs: list, seed: int) -> list:
    """The job ids in an order drawn from the run's seed."""
    return [int(k) for k in rng(seed, 2).permutation(len(jobs))]


def warmup_fasta(seed: int, path: str, root) -> list:
    """Write the warm-up pair and return the CLI arguments that align it.
    Both sides are 12 kbp of the ancestor with 5,000-5,600 replaced, on
    one side by 560 bases of A and C, on the other by 600 of G and T, so
    no match falls inside: with -u (every gap alignable) the 600 x 560 gap
    of 336,000 cells is a chain-tier job, over the stitcher's threshold of
    160,000 cells, and its neighbours go to the host aligners."""
    anc = root.base[:12000].tobytes().decode()
    g = rng(seed, 3)
    left = "".join("AC"[k] for k in g.integers(0, 2, 560))
    right = "".join("GT"[k] for k in g.integers(0, 2, 600))
    write_fasta(path, [("warm_a", anc[:5000] + left + anc[5600:]),
                       ("warm_b", anc[:5000] + right + anc[5600:])])
    return ["-v", "0", "-u", path]

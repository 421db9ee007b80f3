"""Centromere evolution simulator with truth alignments — repo-native
equivalent of the reference's sim_centromere tool (reference
src/scripts/sim_centromere.cpp, options at its print_help).

Model (same as the reference's):
 - the root sequence is annotated base-by-base with (origin position,
   alpha-monomer family, position within the monomer consensus) from an
   alpha-satellite BED annotation; each monomer is aligned to the alphoid
   consensus with the O(ND) aligner to get in-monomer register;
 - each generation applies, in order: small HOR indels (geometric size in
   HOR units), heavy-tailed HOR indels (discrete Pareto), monomer indels
   (geometric in monomer units), point indels (geometric in bp), and
   substitutions — HOR/monomer events land on register-consistent
   boundaries found by walking the monomer annotation;
 - sequences evolve down a generations-labeled guide tree; outputs per
   leaf: FASTA, an identity file (root origin of every base), and pairwise
   truth CIGARs from the LCS over origin ids (Hunt-Szymanski).

The state is held in numpy arrays (base, origin, idx_in_monomer,
monomer_idx) rather than a linked list; mutation sites are Bernoulli-sampled
per pass like the reference (bases inserted during a pass are not re-drawn
within it). Streams differ from the C++ (different PRNG), so datasets are
model-equivalent, not byte-equal, to reference-generated ones.

Copy of centrolign_tpu/tools/sim_centromere.py.
"""

from __future__ import annotations

import argparse
import math
import re
import sys

import numpy as np

from ..alignment import align_ond, cigar, GAP
from ..induced import align_hs
from ..io.fasta import parse_fasta
from ..tree import Tree

ALPHA_CONSENSUS = (
    "AATCTGCAAGTGGACATTTGGAGCGCTTTGAGGCCTATGGTGGAAAAGGAAATATCTTCACATAAAAAC"
    "TAGACAGAAGCATTCTCAGAAACTTCTTTGTGATGTGTGCATTCAACTCACAGAGTTGAACCTTTCTTT"
    "TGATAGAGCAGTTTTGAAACACTCTTTTTGTAG")

_NONE = -1


class EvSeq:
    """Struct-of-arrays evolved sequence: bases (bytes), root origin,
    index within the monomer consensus, monomer family index."""

    __slots__ = ("base", "origin", "idx_in_mon", "mon_idx")

    def __init__(self, base, origin, idx_in_mon, mon_idx):
        self.base = np.asarray(base, dtype=np.uint8)
        self.origin = np.asarray(origin, dtype=np.int64)
        self.idx_in_mon = np.asarray(idx_in_mon, dtype=np.int64)
        self.mon_idx = np.asarray(mon_idx, dtype=np.int64)

    def __len__(self):
        return len(self.base)

    def copy(self):
        return EvSeq(self.base.copy(), self.origin.copy(),
                     self.idx_in_mon.copy(), self.mon_idx.copy())

    def slice_cat(self, pieces):
        """New EvSeq from a list of (begin, end) ranges and/or EvSeq
        fragments, concatenated."""
        base, origin, idx, mon = [], [], [], []
        for p in pieces:
            if isinstance(p, tuple):
                b, e = p
                base.append(self.base[b:e])
                origin.append(self.origin[b:e])
                idx.append(self.idx_in_mon[b:e])
                mon.append(self.mon_idx[b:e])
            else:
                base.append(p.base)
                origin.append(p.origin)
                idx.append(p.idx_in_mon)
                mon.append(p.mon_idx)
        return EvSeq(np.concatenate(base), np.concatenate(origin),
                     np.concatenate(idx), np.concatenate(mon))


def parse_bed(stream):
    intervals = []
    for line in stream:
        line = line.rstrip("\n")
        if not line or line.startswith("track name"):
            continue
        tok = line.split()
        assert len(tok) >= 4
        intervals.append((tok[0], int(tok[1]), int(tok[2]), tok[3]))
    return sorted(intervals)


_TYPE_RE = re.compile(r"S\d+C[XYM0-9/]+H\d-?[dLAB].(\d+)")


def parse_alpha_type(name: str) -> int:
    m = _TYPE_RE.search(name)
    return int(m.group(1)) if m else _NONE


def initialize_sequence(fasta_path: str, bed_path: str) -> EvSeq:
    """(reference sim_centromere.cpp initialize_sequence)"""
    with open(fasta_path) as f:
        seqs = parse_fasta(f)
    assert len(seqs) == 1
    name, seq = seqs[0]
    with open(bed_path) as f:
        intervals = parse_bed(f)
    for iv in intervals:
        assert iv[0] == name and iv[2] <= len(seq)

    cons = ALPHA_CONSENSUS
    base, origin, idxm, monm = [], [], [], []
    last_monomer = _NONE
    seq_idx = 0
    ii = 0
    while seq_idx < len(seq):
        next_begin = intervals[ii][1] if ii < len(intervals) else len(seq)
        while seq_idx < next_begin:
            base.append(ord(seq[seq_idx]))
            origin.append(seq_idx)
            idxm.append(len(cons))
            monm.append(last_monomer)
            seq_idx += 1
        if ii < len(intervals):
            _, b, e, tname = intervals[ii]
            ii += 1
            monomer = seq[b:e]
            mtype = parse_alpha_type(tname)
            aln = align_ond(monomer, cons)
            cons_pos = 0
            for a, c in aln:
                if c != GAP:
                    cons_pos = int(c)
                if a == GAP:
                    continue
                base.append(ord(monomer[a]))
                origin.append(seq_idx + int(a))
                idxm.append(cons_pos)
                monm.append(mtype)
            if mtype != _NONE:
                last_monomer = mtype
            seq_idx += len(monomer)
    return EvSeq(base, origin, idxm, monm)


# ---------------------------------------------------------------------------
# size distributions (reference sim_centromere.cpp:200-375)


def sample_geom(rng, mean: float, from_0: bool) -> int:
    mu = mean if from_0 else mean - 1.0
    if mu == 0.0:
        return 0 if from_0 else 1
    lam = math.log((mu + 1.0) / mu)
    geom = int(rng.exponential(1.0 / lam))
    return geom if from_0 else geom + 1


def zeta(x: float, q: float) -> float:
    """Hurwitz zeta (Euler-Maclaurin, as in scipy/cephes)."""
    A = [12.0, -720.0, 30240.0, -1209600.0, 47900160.0,
         -1.8924375803183791606e9, 7.47242496e10, -2.950130727918164224e12,
         1.1646782814350067249e14, -4.5979787224074726105e15,
         1.8152105401943546773e17, -7.1661652561756670113e18]
    if x == 1.0:
        return math.inf
    if x < 1.0:
        return math.nan
    if q <= 0.0:
        if q == math.floor(q):
            return math.inf
        if x != math.floor(x):
            return math.nan
    if q > 1e8:
        return (1 / (x - 1) + 1 / (2 * q)) * q ** (1 - x)
    s = q ** -x
    a = q
    i = 0
    b = 0.0
    done = False
    while not done and (i < 9 or a <= 9.0):
        i += 1
        a += 1.0
        b = a ** -x
        s += b
        if abs(b / s) < np.finfo(float).eps:
            done = True
    if not done:
        w = a
        s += b * w / (x - 1.0)
        s -= 0.5 * b
        a = 1.0
        k = 0.0
        for i in range(12):
            a *= x + k
            b /= w
            t = a * b / A[i]
            s += t
            if abs(t / s) < np.finfo(float).eps:
                break
            k += 1.0
            a *= x + k
            b /= w
            k += 1.0
    return s


def discrete_pareto_expected_value(beta, sigma):
    return sigma ** beta * zeta(beta, sigma)


def discrete_pareto_quantile(q, beta, sigma):
    q_term = (1.0 - q) ** (1.0 / beta)
    return math.ceil(sigma * (1.0 - q_term) / q_term)


def sample_discrete_pareto(rng, beta, sigma):
    return discrete_pareto_quantile(rng.random(), beta, sigma)


def choose_discrete_pareto_sigma(expected_val, beta):
    assert expected_val > 1.0 and beta > 1.0

    def f(s):
        if s == 0.0:
            return 1.0 - expected_val
        return discrete_pareto_expected_value(beta, s) - expected_val

    hi = 1.0
    while True:
        ev = discrete_pareto_expected_value(beta, hi)
        if not (ev < expected_val or math.isnan(ev)):
            break
        hi *= 2.0
    lo = 0.0
    flo = f(lo)
    while abs(hi - lo) >= 1e-6:
        mid = (hi + lo) / 2.0
        fmid = f(mid)
        if (fmid > 0.0) == (flo > 0.0):
            lo, flo = mid, fmid
        else:
            hi = mid
    return (hi + lo) / 2.0


# ---------------------------------------------------------------------------
# evolution (reference sim_centromere.cpp Evolver)


class Summary:
    def __init__(self):
        self.num_generations = 0
        self.counts = {k: [0, 0] for k in
                       ("small_hor", "large_hor", "monomer", "point")}
        self.num_substitutions = 0

    def __str__(self):
        c = self.counts
        return (f"\tgenerations: {self.num_generations}\n"
                f"\tsubstitutions: {self.num_substitutions}\n"
                f"\tpoint indels: {c['point'][0]}, {c['point'][1]} bases\n"
                f"\tmonomer indels: {c['monomer'][0]}, {c['monomer'][1]} "
                "monomers\n"
                f"\tsmall HOR indels: {c['small_hor'][0]}, "
                f"{c['small_hor'][1]} HORs\n"
                f"\tlarge HOR indels: {c['large_hor'][0]}, "
                f"{c['large_hor'][1]} HORs\n")


class Evolver:
    def __init__(self):
        self.small_hor_indel_rate = 1.0 / 1000000.0
        self.large_hor_indel_rate = 1.0 / 5000000.0
        self.monomer_indel_rate = 1.0 / 25000000.0
        self.point_indel_rate = 1.0 / 2000000.0
        self.subs_rate = 1.0 / 500000.0
        self.exp_small_hor_indel = 1.25
        self.exp_monomer_indel = 3.0
        self.exp_point_indel = 1.5
        self.large_hor_indel_beta = 1.5
        self.large_hor_indel_sigma = 5.0
        self.monomers_increasing = True
        self.hor_size = _NONE

    def determine_hor(self, seq: EvSeq):
        mon = seq.mon_idx
        has = mon != _NONE
        if not has.any():
            raise RuntimeError("no annotated monomers")
        mx = int(mon[has].max())
        mn = int(mon[has].min())
        vals = mon[has]
        prev, cur = vals[:-1], vals[1:]
        inc = int(((prev == cur - 1) | ((prev == mx) & (cur == mn))).sum())
        dec = int(((prev == cur + 1) | ((prev == mn) & (cur == mx))).sum())
        self.monomers_increasing = inc > dec
        self.hor_size = mx - mn + 1

    # -- walking helpers ------------------------------------------------

    def advance_hors(self, seq: EvSeq, pos: int, num_hors: int, rng):
        """Index of the register-consistent base `num_hors` HOR units
        forward of pos, or None past the end (reference
        sim_centromere.cpp advance_hors)."""
        mon = seq.mon_idx
        idxm = seq.idx_in_mon
        L = len(seq)
        assert mon[pos] != _NONE and num_hors > 0
        hor = self.hor_size
        src_mon = int(mon[pos])
        num_passed = 0
        prev_idx = int(idxm[pos])
        prev_mon = src_mon
        prev_adv = src_mon
        final_begin = final_end = None
        it = pos
        while it < L:
            mi = int(mon[it])
            xi = int(idxm[it])
            if prev_mon != mi or (prev_mon == mi and prev_idx > xi):
                if prev_adv < mi:
                    fwd = mi - prev_adv
                    rev = hor - mi + prev_adv
                else:
                    fwd = hor - prev_adv + mi
                    rev = prev_adv - mi
                if self.monomers_increasing:
                    if fwd <= rev and fwd > 0:
                        if ((prev_adv < mi and prev_adv < src_mon <= mi)
                                or (mi < prev_adv
                                    and (src_mon > prev_adv
                                         or src_mon <= mi))):
                            num_passed += 1
                            if num_passed == num_hors:
                                final_begin = it
                            elif num_passed > num_hors:
                                final_end = it
                                break
                        prev_adv = mi
                else:
                    if rev <= fwd and rev > 0:
                        if ((prev_adv > mi and mi <= src_mon < prev_adv)
                                or (mi > prev_adv
                                    and (src_mon >= mi
                                         or src_mon < prev_adv))):
                            num_passed += 1
                            if num_passed == num_hors:
                                final_begin = it
                            elif num_passed > num_hors:
                                final_end = it
                                break
                        prev_adv = mi
            prev_idx = xi
            if mi != _NONE:
                prev_mon = mi
                if prev_adv == _NONE:
                    prev_adv = mi
            it += 1
        if final_begin is None:
            return None
        if final_end is None:
            final_end = L

        # parse the final HOR into monomers
        monomer_begins = []
        prev_idx = _NONE
        for it in range(final_begin, final_end):
            xi = int(idxm[it])
            if prev_idx == _NONE or prev_idx > xi:
                monomer_begins.append(it)
            prev_idx = xi

        candidates = []
        for i, mb in enumerate(monomer_begins):
            if int(mon[mb]) == src_mon:
                end = (monomer_begins[i + 1]
                       if i + 1 < len(monomer_begins) else final_end)
                candidates.append((mb, end))
        if not candidates:
            if final_end == L:
                mons = [int(mon[b]) for b in monomer_begins]
                front, back = mons[0], mons[-1]
                if self.monomers_increasing:
                    if front < back:
                        if src_mon > back or src_mon < front:
                            return None
                    else:
                        if back > src_mon > front:
                            return None
                else:
                    if front > back:
                        if src_mon > front or src_mon < back:
                            return None
                    else:
                        if front < src_mon < back:
                            return None
            closest_i = None
            closest_d = None
            for i, mb in enumerate(monomer_begins):
                mi = int(mon[mb])
                if mi == _NONE:
                    continue
                if mi < src_mon:
                    fwd = src_mon - mi
                    rev = num_hors - src_mon + mi
                else:
                    fwd = num_hors - mi + src_mon
                    rev = mi - src_mon
                d = min(fwd, rev)
                if closest_i is None or d < closest_d:
                    closest_i, closest_d = i, d
            if closest_i is None:
                closest_i = 0
            i = closest_i
            j = closest_i + 1
            while i != 0 and int(mon[monomer_begins[i - 1]]) == _NONE:
                i -= 1
            while (j != len(monomer_begins)
                   and int(mon[monomer_begins[j]]) == _NONE):
                j += 1
            for k in range(i, j):
                end = (monomer_begins[k + 1]
                       if k + 1 < len(monomer_begins) else final_end)
                candidates.append((monomer_begins[k], end))

        mb, me = candidates[int(rng.integers(0, len(candidates)))]
        # closest-to-in-register bases in the chosen monomer
        src_idx = int(idxm[pos])
        cand_bases = []
        best = None
        for it in range(mb, me):
            d = abs(int(idxm[it]) - src_idx)
            if best is None or d <= best:
                if best is None or d < best:
                    cand_bases = []
                    best = d
                cand_bases.append(it)
        return cand_bases[int(rng.integers(0, len(cand_bases)))]

    def advance_monomers(self, seq: EvSeq, pos: int, num: int, rng):
        idxm = seq.idx_in_mon
        L = len(seq)
        passed = 0
        prev_idx = _NONE
        it = pos
        src_idx = int(idxm[pos])
        while it < L:
            xi = int(idxm[it])
            if prev_idx != _NONE and prev_idx > xi:
                passed += 1
            if (passed == num and xi >= src_idx) or passed > num:
                break
            prev_idx = xi
            it += 1
        # aligned positions within the last monomer, walking back
        equal = []
        pi = it
        while pi > pos:
            pi -= 1
            if pi == pos:
                break
            xi = int(idxm[pi])
            if xi == src_idx:
                equal.append(pi)
            elif xi < src_idx:
                break
        if not equal:
            return it if it < L else None
        return equal[int(rng.integers(0, len(equal)))]

    # -- one generation ---------------------------------------------------

    def evolve(self, parent: EvSeq, num_generations: int, rng,
               summary: Summary | None = None) -> EvSeq:
        if self.hor_size == _NONE:
            raise RuntimeError("must determine HOR size before evolving")
        if summary is not None:
            summary.num_generations = num_generations
        seq = parent.copy()
        for gen in range(1, num_generations + 1):
            if gen % 10 == 0:
                print(f"generation {gen} of {num_generations}",
                      file=sys.stderr)
            seq = self._hor_indel_pass(
                seq, rng, self.small_hor_indel_rate,
                lambda: sample_geom(rng, self.exp_small_hor_indel, False),
                summary, "small_hor")
            seq = self._hor_indel_pass(
                seq, rng, self.large_hor_indel_rate,
                lambda: sample_discrete_pareto(
                    rng, self.large_hor_indel_beta,
                    self.large_hor_indel_sigma),
                summary, "large_hor")
            seq = self._monomer_indel_pass(seq, rng, summary)
            seq = self._point_indel_pass(seq, rng, summary)
            seq = self._substitution_pass(seq, rng, summary)
        return seq

    def _sample_sites(self, rng, L, rate, mask=None):
        hits = rng.random(L) < rate
        if mask is not None:
            hits &= mask
        return np.flatnonzero(hits)

    def _apply_indels(self, seq, events):
        """events: list of (kind, begin, end) with kind 'dup'|'del'|EvSeq
        insert, non-overlapping, sorted. Rebuilds the arrays once."""
        if not events:
            return seq
        pieces = []
        cur = 0
        for kind, b, e in events:
            if kind == "dup":
                # the reference inserts the copy before the range begin;
                # [cur,b) [b,e) [b,e) is the same content
                pieces.append((cur, b))
                pieces.append((b, e))
                pieces.append((b, e))
                cur = e
            elif kind == "del":
                pieces.append((cur, b))
                cur = e
            else:  # insertion of a fragment before position b
                pieces.append((cur, b))
                pieces.append(kind)
                cur = b
        pieces.append((cur, len(seq)))
        return seq.slice_cat(pieces)

    def _hor_indel_pass(self, seq, rng, rate, size_fn, summary, tag):
        sites = self._sample_sites(rng, len(seq), rate,
                                   seq.mon_idx != _NONE)
        if not len(sites):
            return seq
        events = []
        last_end = -1
        for pos in sites:
            pos = int(pos)
            if pos < last_end:
                continue  # overlapping a previous event this pass
            size = size_fn()
            end = self.advance_hors(seq, pos, size, rng)
            if end is None:
                continue
            if summary is not None:
                summary.counts[tag][0] += 1
                summary.counts[tag][1] += size
            if rng.random() < 0.5:
                events.append(("dup", pos, end))
            else:
                events.append(("del", pos, end))
            last_end = end
        return self._apply_indels(seq, events)

    def _monomer_indel_pass(self, seq, rng, summary):
        sites = self._sample_sites(rng, len(seq), self.monomer_indel_rate)
        if not len(sites):
            return seq
        events = []
        last_end = -1
        for pos in sites:
            pos = int(pos)
            if pos < last_end:
                continue
            size = sample_geom(rng, self.exp_monomer_indel, False)
            end = self.advance_monomers(seq, pos, size, rng)
            if end is None:
                continue
            if summary is not None:
                summary.counts["monomer"][0] += 1
                summary.counts["monomer"][1] += size
            if rng.random() < 0.5:
                events.append(("dup", pos, end))
            else:
                events.append(("del", pos, end))
            last_end = end
        return self._apply_indels(seq, events)

    def _point_indel_pass(self, seq, rng, summary):
        sites = self._sample_sites(rng, len(seq), self.point_indel_rate)
        if not len(sites):
            return seq
        alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
        events = []
        last_end = -1
        for pos in sites:
            pos = int(pos)
            if pos < last_end:
                continue
            size = sample_geom(rng, self.exp_point_indel, False)
            if summary is not None:
                summary.counts["point"][0] += 1
                summary.counts["point"][1] += size
            if rng.random() < 0.5:
                frag = EvSeq(
                    alphabet[rng.integers(0, 4, size)],
                    np.full(size, seq.origin[pos]),
                    np.full(size, seq.idx_in_mon[pos]),
                    np.full(size, seq.mon_idx[pos]))
                events.append((frag, pos, pos))
                last_end = pos
            else:
                end = pos + size
                if end >= len(seq):
                    continue
                events.append(("del", pos, end))
                last_end = end
        return self._apply_indels(seq, events)

    def _substitution_pass(self, seq, rng, summary):
        sites = self._sample_sites(rng, len(seq), self.subs_rate)
        if not len(sites):
            return seq
        if summary is not None:
            summary.num_substitutions += len(sites)
        alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
        cur = seq.base[sites]
        # draw uniformly among the 3 other bases
        shift = rng.integers(1, 4, len(sites))
        cur_idx = np.searchsorted(alphabet, cur)
        # non-ACGT bases (e.g. N) map like the reference's rejection loop:
        # any of the 4 letters different from the original
        new = alphabet[(cur_idx + shift) % 4]
        seq = seq.copy()
        seq.base[sites] = new
        return seq


# ---------------------------------------------------------------------------


def dummy_newick(num_generations: int) -> str:
    return f"(seq1:{num_generations},seq2:{num_generations});"


def write_fasta(seq: EvSeq, name: str, out):
    out.write(f">{name}\n")
    data = seq.base.tobytes().decode()
    for i in range(0, len(data), 80):
        out.write(data[i:i + 80] + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sim_centromere")
    ap.add_argument("fasta")
    ap.add_argument("bed")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-g", "--generations", type=int, default=100)
    ap.add_argument("-T", "--tree", default="")
    ap.add_argument("-h2", "--hor-indel-small-rate", type=float,
                    default=1.0 / 1000000.0, dest="hsr")
    ap.add_argument("-H", "--hor-indel-small-size", type=float,
                    default=1.25, dest="hss")
    ap.add_argument("-r", "--hor-indel-large-rate", type=float,
                    default=1.0 / 5000000.0, dest="hlr")
    ap.add_argument("-R", "--hor-indel-large-size", type=float,
                    default=8.0, dest="hls")
    ap.add_argument("-t", "--hor-indel-heaviness", type=float, default=10.0)
    ap.add_argument("-m", "--monomer-indel-rate", type=float,
                    default=1.0 / 25000000.0)
    ap.add_argument("-M", "--monomer-indel-size", type=float, default=3.0)
    ap.add_argument("-p", "--point-indel-rate", type=float,
                    default=1.0 / 2000000.0)
    ap.add_argument("-P", "--point-indel-size", type=float, default=1.5)
    ap.add_argument("-s", "--substitution-rate", type=float,
                    default=1.0 / 500000.0)
    ap.add_argument("-z", "--seed", type=int, default=None)
    ap.add_argument("--skip-pairwise", action="store_true",
                    help="skip truth pairwise CIGARs (quadratic in leaves)")
    args = ap.parse_args(argv)

    ev = Evolver()
    ev.small_hor_indel_rate = args.hsr
    ev.exp_small_hor_indel = args.hss
    ev.large_hor_indel_rate = args.hlr
    ev.monomer_indel_rate = args.monomer_indel_rate
    ev.exp_monomer_indel = args.monomer_indel_size
    ev.point_indel_rate = args.point_indel_rate
    ev.exp_point_indel = args.point_indel_size
    ev.subs_rate = args.substitution_rate
    ev.large_hor_indel_beta = 1.0 + 1.0 / args.hor_indel_heaviness
    ev.large_hor_indel_sigma = choose_discrete_pareto_sigma(
        args.hls, ev.large_hor_indel_beta)

    seed = args.seed if args.seed is not None else np.random.SeedSequence(
    ).entropy
    print(f"seed is {seed}", file=sys.stderr)
    rng = np.random.default_rng(seed)

    info_lines = [f"seed: {seed}"]

    if args.tree:
        with open(args.tree) as f:
            newick = f.read()
    else:
        newick = dummy_newick(args.generations)
    tree = Tree(newick)
    for node_id in range(tree.node_size):
        if tree.is_leaf(node_id) and not tree.label(node_id):
            raise RuntimeError("leaf node in tree does not have a label")

    sequences = [None] * tree.node_size
    for node_id in tree.preorder():
        if node_id == tree.get_root():
            print(f"initializing root sequence (id {node_id})",
                  file=sys.stderr)
            sequences[node_id] = initialize_sequence(args.fasta, args.bed)
            ev.determine_hor(sequences[node_id])
        else:
            num_gens = tree.distance(node_id)
            assert num_gens == float(int(num_gens))
            parent = sequences[tree.get_parent(node_id)]
            label = tree.label(node_id) if tree.is_leaf(node_id) else ""
            print(f"mutating {num_gens:g} generations from id "
                  f"{tree.get_parent(node_id)} to id {node_id}"
                  + (f" ({label})" if label else ""), file=sys.stderr)
            summary = Summary()
            sequences[node_id] = ev.evolve(parent, int(num_gens), rng,
                                           summary)
            info_lines.append(
                f"evolution from seq id {tree.get_parent(node_id)} to seq "
                f"id {node_id}" + (f" ({label})" if label else "") + ":")
            info_lines.append(str(summary).rstrip("\n"))
            print(summary, file=sys.stderr, end="")

    print("writing sequences and base identities", file=sys.stderr)
    for node_id in range(tree.node_size):
        if tree.is_leaf(node_id):
            label = tree.label(node_id)
            with open(f"{args.output}_{label}.fasta", "w") as f:
                write_fasta(sequences[node_id], label, f)
            with open(f"{args.output}_{label}_identity.txt", "w") as f:
                f.write("\n".join(str(int(o))
                                  for o in sequences[node_id].origin))
                f.write("\n")

    leaves = [t for t in range(tree.node_size) if tree.is_leaf(t)]
    if args.skip_pairwise:
        leaves = []
    else:
        print("doing pairwise alignments", file=sys.stderr)
    for ai in range(len(leaves)):
        for bi in range(ai + 1, len(leaves)):
            na, nb = leaves[ai], leaves[bi]
            aln = align_hs(sequences[na].origin.tolist(),
                           sequences[nb].origin.tolist())
            arr = np.array(aln, dtype=np.int64).reshape(-1, 2)
            with open(f"{args.output}_{tree.label(na)}_{tree.label(nb)}"
                      "_cigar.txt", "w") as f:
                f.write(cigar(arr) + "\n")

    with open(f"{args.output}_info.txt", "w") as f:
        f.write("\n".join(info_lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

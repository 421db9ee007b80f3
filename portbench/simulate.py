"""Frozen copy of the port's centromere simulator, the benchmark's input
generator.

Copied from centrolign_tpu_torch/tools/sim_centromere.py (the classes and
functions from ALPHA_CONSENSUS through Evolver, unchanged but for the
progress lines `Evolver.evolve` printed), with `align_ond` from
centrolign_tpu_torch/alignment.py and `parse_fasta` from
centrolign_tpu_torch/io/fasta.py (validation left out: the only FASTA it
reads is portbench/data/anc.fasta). The newick reader and `evolve_tree`
below stand in for the tool's `Tree` and `main`: the same preorder (a
stack, so the last child first), one generator for the whole tree, and
main's defaults for the heavy-tailed HOR indels (beta 1 + 1/10, sigma
from an expected size of 8). The pairwise truth CIGARs and identity files
the tool writes are not made: nothing here reads them.

Later PRs do not edit this file: a change to the generator is a new
traffic mix, not a change of the old ones.
"""

from __future__ import annotations

import math
import re

import numpy as np

GAP = -1
_I64 = np.int64


def align_ond(seq1, seq2) -> np.ndarray:
    """Myers O(ND) unit-cost edit alignment (reference alignment.hpp:262-634,
    align_ond): matches are free, substitutions/insertions/deletions cost 1,
    the total edit distance is minimized. Accepts any indexable sequences of
    comparable elements; returns an (L, 2) pair array with GAP = -1.

    Time O((n+m)·D), memory O(D²) for the traceback frontier stack — the
    same regime the reference targets (near-identical sequences, small D).
    Used by the sim_centromere tool's monomer annotation; the reference also
    exposes it only as a test oracle / script helper."""
    n, m = len(seq1), len(seq2)

    def snake(a: int, k: int) -> int:
        # extend free matches along diagonal k from anti-diagonal a
        i = (a + k) // 2
        j = (a - k) // 2
        while i < n and j < m and seq1[i] == seq2[j]:
            i += 1
            j += 1
        return i + j

    frontiers = []
    V = {0: snake(0, 0)}
    frontiers.append(V)
    k_final = n - m
    a_final = n + m
    d = 0
    while V.get(k_final, -1) != a_final:
        d += 1
        nv = {}
        for k, a in V.items():
            # substitution (both advance), insertion (seq1), deletion (seq2)
            for nk, na in ((k, a + 2), (k + 1, a + 1), (k - 1, a + 1)):
                i = (na + nk) // 2
                j = (na - nk) // 2
                if 0 <= i <= n and 0 <= j <= m and na > nv.get(nk, -1):
                    nv[nk] = na
        V = {k: snake(a, k) for k, a in nv.items()}
        frontiers.append(V)

    # traceback: at (k, a) with d edits, find a predecessor whose op +
    # snake reaches exactly a
    pairs = []

    def emit_snake(a_hi: int, a_lo: int, k: int) -> None:
        i = (a_hi + k) // 2
        j = (a_hi - k) // 2
        while i + j > a_lo:
            pairs.append((i - 1, j - 1))
            i -= 1
            j -= 1

    k, a = k_final, a_final
    for d in range(len(frontiers) - 1, 0, -1):
        prev = frontiers[d - 1]
        found = False
        for pk, cost_adv, pair in ((k, 2, (0, 0)), (k - 1, 1, (1, GAP)),
                                   (k + 1, 1, (GAP, 1))):
            pa = prev.get(pk)
            if pa is None:
                continue
            op_a = pa + cost_adv
            if op_a > a or snake(op_a, k) < a:
                continue
            emit_snake(a, op_a, k)
            i = (op_a + k) // 2
            j = (op_a - k) // 2
            if cost_adv == 2:
                pairs.append((i - 1, j - 1))
            elif pair[0] == 1:
                pairs.append((i - 1, GAP))
            else:
                pairs.append((GAP, j - 1))
            k, a = pk, pa
            found = True
            break
        assert found, "O(ND) traceback failed"
    emit_snake(a, 0, k)
    pairs.reverse()
    return np.array(pairs, dtype=_I64).reshape(-1, 2)





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


# ---------------------------------------------------------------------------
# the tool's input handling and main, reduced to what the benchmark uses


def parse_fasta(stream) -> list:
    """[(name, sequence)] of a FASTA stream."""
    parsed = []
    for line in stream:
        line = line.rstrip("\n")
        if line.startswith(">"):
            parsed.append((line[1:].split(" ")[0], []))
        elif parsed:
            parsed[-1][1].append(line)
    return [(name, "".join(chunks)) for name, chunks in parsed]


class Newick:
    """A rooted tree from a newick string: `children`, `label` and
    `length` by node id, ids in the order the nodes open."""

    _TOKEN = re.compile(r"\s*([(),;])\s*|\s*([^(),;]+)")

    def __init__(self, text: str):
        self.children: list = []
        self.label: list = []
        self.length: list = []
        stack = []
        last = None
        for m in self._TOKEN.finditer(text.strip()):
            punct, word = m.groups()
            if punct == "(":
                node = self._new()
                if stack:
                    self.children[stack[-1]].append(node)
                stack.append(node)
                last = None
            elif punct in (",", ")"):
                if last is None:
                    raise ValueError(f"empty subtree in {text!r}")
                if punct == ")":
                    last = stack.pop()
                else:
                    last = None
            elif punct == ";":
                break
            else:
                if last is None:
                    last = self._new()
                    if stack:
                        self.children[stack[-1]].append(last)
                name, _, dist = word.partition(":")
                self.label[last] = name.strip()
                self.length[last] = float(dist) if dist else 0.0
        if stack or not self.children:
            raise ValueError(f"unbalanced newick {text!r}")

    def _new(self) -> int:
        self.children.append([])
        self.label.append("")
        self.length.append(0.0)
        return len(self.children) - 1

    def preorder(self) -> list:
        order, stack = [], [0]
        while stack:
            top = stack.pop()
            order.append(top)
            stack.extend(self.children[top])
        return order

    def parents(self) -> list:
        par = [-1] * len(self.children)
        for node, kids in enumerate(self.children):
            for c in kids:
                par[c] = node
        return par


def evolver(rates: dict) -> Evolver:
    """An Evolver with the tool's command-line defaults (main), each
    overridden by `rates`: small_hor_indel_rate, exp_small_hor_indel,
    large_hor_indel_rate, large_hor_indel_size, hor_indel_heaviness,
    monomer_indel_rate, exp_monomer_indel, point_indel_rate,
    exp_point_indel, subs_rate."""
    r = {"small_hor_indel_rate": 1.0 / 1000000.0, "exp_small_hor_indel": 1.25,
         "large_hor_indel_rate": 1.0 / 5000000.0, "large_hor_indel_size": 8.0,
         "hor_indel_heaviness": 10.0,
         "monomer_indel_rate": 1.0 / 25000000.0, "exp_monomer_indel": 3.0,
         "point_indel_rate": 1.0 / 2000000.0, "exp_point_indel": 1.5,
         "subs_rate": 1.0 / 500000.0}
    unknown = set(rates) - set(r)
    if unknown:
        raise ValueError(f"unknown simulator rates {sorted(unknown)}")
    r.update(rates)
    ev = Evolver()
    for key in ("small_hor_indel_rate", "exp_small_hor_indel",
                "large_hor_indel_rate", "monomer_indel_rate",
                "exp_monomer_indel", "point_indel_rate", "exp_point_indel",
                "subs_rate"):
        setattr(ev, key, r[key])
    ev.large_hor_indel_beta = 1.0 + 1.0 / r["hor_indel_heaviness"]
    ev.large_hor_indel_sigma = choose_discrete_pareto_sigma(
        r["large_hor_indel_size"], ev.large_hor_indel_beta)
    return ev


def evolve_tree(root: EvSeq, newick: str, rates: dict, seed: int) -> dict:
    """{leaf label: evolved sequence (str)} for the root evolved down the
    tree, each edge its length in generations, all from one generator of
    `seed` (the tool's main with -T and -z)."""
    tree = Newick(newick)
    ev = evolver(rates)
    ev.determine_hor(root)
    rng = np.random.default_rng(seed)
    parent = tree.parents()
    seqs = {}
    for node in tree.preorder():
        if parent[node] < 0:
            seqs[node] = root
            continue
        gens = tree.length[node]
        if gens != int(gens):
            raise ValueError(f"branch of {gens} generations")
        seqs[node] = ev.evolve(seqs[parent[node]], int(gens), rng)
    leaves = {}
    for node, kids in enumerate(tree.children):
        if not kids:
            if not tree.label[node]:
                raise ValueError("leaf node in tree does not have a label")
            leaves[tree.label[node]] = seqs[node].base.tobytes().decode()
    return leaves

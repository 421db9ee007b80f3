"""The plain reference against the port's own plain versions, its output
checks on good and broken outputs, its sample, and its control."""

import numpy as np
import pytest

from portbench.reference import check, expected, gotoh, outputs


def _jobs(rng, n, longest=40):
    jobs = []
    for t in range(n):
        L1, L2 = (int(x) for x in rng.integers(0, longest, 2))
        s1 = rng.integers(0, 4, L1).astype(np.int32)
        s2 = np.concatenate([s1, rng.integers(0, 4, max(0, L2 - L1))])[:L2]
        s2 = s2.astype(np.int32)
        if L2:
            idx = rng.integers(0, L2, max(1, L2 // 5))
            s2[idx] = rng.integers(0, 4, len(idx))
        npw = 1 + t % 3
        if t % 5 == 0:
            go = tuple(int(x) for x in rng.integers(1, 100, npw))
            ge = tuple(int(x) for x in rng.integers(1, 40, npw))
            match, mismatch = (int(x) for x in rng.integers(1, 90, 2))
        else:
            go, ge = (60, 800, 2500)[:npw], (30, 5, 1)[:npw]
            match, mismatch = 20, 80
        jobs.append((s1, s2, bool(t % 2), match, mismatch, go, ge))
    return jobs


@pytest.mark.parametrize("block", range(4))
def test_reference_is_the_ports_plain_gotoh(block):
    port = pytest.importorskip("centrolign_tpu_torch.ops.gotoh")
    from centrolign_tpu_torch.ops.align_params import AlignmentParams
    for s1, s2, swap, match, mismatch, go, ge in _jobs(
            np.random.default_rng(100 + block), 60):
        want, wscore = port.gotoh_align(
            s1, s2, AlignmentParams(match, mismatch, go, ge), swap)
        got, score = gotoh.align((s1, s2, swap, match, mismatch, go, ge))
        assert np.array_equal(got, want) and score == wscore
        assert gotoh.score_of(got, s1, s2, match, mismatch, go, ge) == score


def test_score_of_refuses_what_is_no_alignment():
    s1 = np.array([0, 1, 2], np.int32)
    s2 = np.array([0, 2], np.int32)
    good = np.array([[0, 0], [1, -1], [2, 1]])
    assert gotoh.score_of(good, s1, s2, 20, 80, (60,), (30,)) == 40 - 90
    assert gotoh.score_of(good[:2], s1, s2, 20, 80, (60,), (30,)) is None
    assert gotoh.score_of(good[[0, 2, 1]], s1, s2, 20, 80, (60,),
                          (30,)) is None
    assert gotoh.score_of(np.vstack([good, [[-1, -1]]]), s1, s2, 20, 80,
                          (60,), (30,)) is None


def test_the_control_at_int16_is_caught():
    rng = np.random.default_rng(4)
    s1 = rng.integers(0, 4, 2200).astype(np.int32)
    s2 = s1.copy()
    s2[::25] = (s2[::25] + 1) % 4
    job = (s1, s2, False, 20, 80, (60, 800, 2500), (30, 5, 1))
    ref, score = gotoh.align(job)
    low, low_score = gotoh.align(job, dtype=np.int16)
    assert score > 2 ** 15
    assert low_score != score
    got = gotoh.score_of(low, s1, s2, *job[3:])
    assert got is None or got < score


def test_cigar_check():
    a, b = "ACGTACGT", "ACTTACGGT"
    assert outputs.cigar_problem("2=1X5=1I", a, b) is not None
    assert outputs.cigar_problem("2=1X4=1I1=", a, b) is None
    assert outputs.cigar_problem("3=5=1I", a, b) is not None
    assert outputs.cigar_problem("2=1X5=", a, b) is not None
    assert outputs.cigar_problem("2=1X5=2I", a, b) is not None
    assert outputs.cigar_problem("", a, b) is not None
    assert outputs.cigar_problem("2=1Q5=1I", a, b) is not None
    assert outputs.cigar_problem("8D9I", a, b) is None


def test_gfa_check():
    records = [("s1", "ACGTTT"), ("s2", "ACAAA")]
    gfa = ("H\tVN:Z:1.0\nS\t1\tAC\nS\t2\tGTTT\nS\t3\tTTT\n"
           "P\ts1\t1+,2+\t*\nP\ts2\t1+,3-\t*\n")
    assert outputs.gfa_problem(gfa, records) is None
    assert outputs.gfa_problem(gfa.replace("GTTT", "GTTA"), records)
    assert outputs.gfa_problem(gfa.replace("P\ts2\t1+,3-\t*\n", ""),
                               records)
    assert outputs.gfa_problem(gfa.replace("3-", "3+"), records)
    assert outputs.gfa_problem(gfa + "P\ts1\t1+,2+\t*\n", records)


def test_outputs_are_judged_against_their_expected_bytes(tmp_path):
    fasta = tmp_path / "p.fasta"
    fasta.write_text(">a\nACGTACGT\n>b\nACTTACGGT\n")
    argv = [str(fasta)]
    base = str(tmp_path / "expected")
    key = expected.key("cigar", argv)
    assert key == expected.key("cigar", [str(fasta)])
    assert key != expected.key("gfa", argv)
    assert expected.load(key, base) is None
    expected.store(key, b"2=1X4=1I1=\n", base)
    with open(expected.path(key, base), "rb") as f:
        first = f.read()
    expected.store(key, b"2=1X4=1I1=\n", base)
    with open(expected.path(key, base), "rb") as f:
        assert f.read() == first
    jobs = []
    for n, text in enumerate(["2=1X4=1I1=\n", "8D9I\n", "2=1X5=1I\n"]):
        out = tmp_path / f"o{n}"
        out.write_text(text)
        jobs.append({"id": n, "mode": "cigar", "argv": argv,
                     "fasta": str(fasta), "output": str(out)})
    wrong, differ = check.judge_outputs(jobs, base)
    assert [w["n"] for w in wrong] == [2]
    assert [d["n"] for d in differ] == [1, 2]
    assert "at byte 0" in differ[0]["why"]
    # a different input is another job, with no expected output
    fasta.write_text(">a\nACGTACGT\n>b\nACTTACGGA\n")
    assert expected.key("cigar", argv) != key
    wrong, differ = check.judge_outputs(jobs[:1], base)
    assert differ[0]["why"] == "no expected output"

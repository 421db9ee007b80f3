"""The key of a job's expected output (reference/expected.py): the
benchmark's cells keep their committed keys, and a job with a parameter
file (a configuration with `params`) keeps its key wherever its inputs are
written and whether or not the run is traced, and changes it when a
parameter does."""

import hashlib
import json
import os

import pytest

from portbench import spec, traffic
from portbench.reference import expected

# the committed files of portbench/expected/, by cell: a change to the key
# or to the jobs' arguments would leave them unread
COMMITTED = {
    "pair_185k": {"1c1affdf5c4ee6f310a5f48d4fce6774",
                  "24c60a6dcf385cc43ea07e1bb8e08d03",
                  "41b3bbe0c54ec1b17952813735130cf3",
                  "58991194ae9d8b2ff48e4fe86d3db2b5",
                  "6e5815daea5fc6726785e7e43d3cdd35",
                  "7c45de89b882c377f0eeb1e6c916ef83",
                  "85a70d7e971ead9be3bb6e4b8ca466a9",
                  "a51c68fe44e77fb2cd4ac82ccd6b2c3d",
                  "bd7d35543ed60cf1da61082901b1d9c1",
                  "c88799ebb325de4781e7435d1f5e0afa"},
    "msa4_185k": {"0d97c1534577e61abe7754f8282f8785",
                  "f37e362ad2fcd3d1266af866aa3a176e"},
}
PARAMS = {"cyclize_tandem_duplications": True, "min_cyclizing_length": 2500,
          "max_realignment_cycle_size": 0, "inconsistent_indel_window": 0,
          "anchor_gap_open": [1.25, 50, 5000]}


@pytest.mark.parametrize("cell", sorted(COMMITTED))
def test_the_cells_jobs_give_their_committed_keys(tmp_path, cell):
    c = spec.cell(cell)
    anc = traffic.ancestor(c["config"])
    groups = traffic.cohorts(c["config"], c["traffic"], anc)
    for trace in (False, True):
        d = tmp_path / f"trace{int(trace)}"
        d.mkdir()
        jobs = traffic.jobs_of(c["config"], groups, str(d), c["traffic"],
                               trace)
        assert not any(j["params"] for j in jobs)
        # the arguments as before parameter files: the FASTA last
        assert all(j["argv"][-1] == j["fasta"] for j in jobs)
        assert {expected.key(j["output"], j["argv"])
                for j in jobs} == COMMITTED[cell]


def _old_key(mode, argv):
    """The key before parameter files had one of their own."""
    def digest(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    words = [mode] + [f"file:{digest(a)}" if os.path.isfile(a)
                      else f"arg:{a}" for a in argv]
    return hashlib.sha256(json.dumps(words).encode()).hexdigest()[:32]


def _jobs(tmp_path, name, params=PARAMS, mode="pairs", trace=False,
          cohort=None):
    config = {"mode": mode, "output": "gfa", "tree": "(a:1,b:1,c:1):0;",
              "cli_args": ["--force-gfa-output"], "params": params}
    if params is None:
        del config["params"]
    cohort = cohort or {"a": "ACGTTGCA" * 40, "b": "ACGTAGCA" * 41,
                        "c": "TTGCAACG" * 39}
    d = tmp_path / name
    d.mkdir()
    return traffic.jobs_of(config, [cohort], str(d),
                           {"cohorts": 1, "data_seed": 1}, trace)


def _keys(jobs):
    return [expected.key(j["output"], j["argv"]) for j in jobs]


@pytest.mark.parametrize("mode", ["pairs", "msa"])
def test_a_params_key_holds_across_directories_and_trace(tmp_path, mode):
    first = _jobs(tmp_path, "one", mode=mode)
    again = _jobs(tmp_path, "two", mode=mode, trace=True)
    assert all(j["params"] for j in first + again)
    assert first[0]["argv"][:2] == ["--force-gfa-output", "-C"]
    assert first[0]["argv"] != again[0]["argv"]
    with open(first[0]["argv"][-1]) as f, open(again[0]["argv"][-1]) as g:
        untraced, traced = f.read(), g.read()
    assert "logging_level" not in untraced
    assert " logging_level: 3\n" in traced
    assert ("tree_name" in traced) == (mode == "msa")
    assert _keys(first) == _keys(again)
    assert len(set(_keys(first))) == len(first)
    # the old key took the file's bytes, paths and logging level included
    assert _old_key("gfa", first[0]["argv"]) != _old_key("gfa",
                                                         again[0]["argv"])


@pytest.mark.parametrize("change", [
    {"min_cyclizing_length": 2501},
    {"cyclize_tandem_duplications": False},
    {"anchor_gap_open": [1.25, 50, 5001]},
])
def test_a_params_key_changes_with_a_parameter(tmp_path, change):
    base = _keys(_jobs(tmp_path, "base"))
    changed = _keys(_jobs(tmp_path, "changed", params={**PARAMS, **change}))
    assert all(a != b for a, b in zip(base, changed))


def test_a_params_key_changes_with_the_input(tmp_path):
    base = _keys(_jobs(tmp_path, "base"))
    other = _keys(_jobs(tmp_path, "other", cohort={
        "a": "ACGTTGCA" * 40, "b": "ACGTAGCA" * 41, "c": "TTGCAACG" * 38}))
    assert base[0] == other[0] and base[1:] != other[1:]


def test_a_job_without_params_keeps_the_old_key(tmp_path):
    for mode in ("pairs", "msa"):
        jobs = _jobs(tmp_path, mode, params=None, mode=mode)
        assert not any(j["params"] for j in jobs)
        assert _keys(jobs) == [_old_key("gfa", j["argv"]) for j in jobs]

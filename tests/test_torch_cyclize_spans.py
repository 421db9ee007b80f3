"""The spans and counters inside -c's bonding and cyclization
(centrolign_tpu_torch/core.py, anchorer.py; the tree in metrics.py's
docstring).

On the CPU, with the device tier on its plain versions: the tandem input
of test_torch_spans.py::test_cyclize_gives_bonding_spans (two sequences of
three 1.5 kbp copies, tests/test_torch_cyclize.py's config with the polish
off), run once in this process at -v 3. Each round's bond.chain holds its
bond.anchor and bond.identify, cyclize holds cyclize.fuse and
cyclize.simplify, the self times still sum to the job, chain.masked counts
every round's masked chaining, chain.masked_cdq or chain.masked_tree each
by the engine that answered it, and bond.found every bond the log reports.
A run without -c (test_torch_spans.py's pair and MSA) records none of
them. The C heap's free pages go back to the system at each round's
start, before each masked chaining's fill-in and once after bonding.
"""

import pytest

from centrolign_tpu_torch import core, metrics
from centrolign_tpu_torch.utils import memory
from portbench import stages
from test_torch_spans import _names, _self_ns, jobs, run_job  # noqa: F401

NEW_SPANS = {"bond.anchor", "bond.identify", "cyclize.fuse",
             "cyclize.simplify"}
NEW_TAGS = {"chain.masked", "chain.masked_cdq", "chain.masked_tree",
            "bond.found"}


@pytest.fixture(scope="module")
def cyc(tmp_path_factory):
    """(-v 3 log, metrics.summary(), [(tag, indices of the spans open)]
    of each counter record and, under the tag "release", each call of
    release_free_heap) of the -c job."""
    from test_torch_cyclize import CPU_TIER as CYC_TIER
    from test_torch_cyclize import _config, _tandem_fasta
    d = tmp_path_factory.mktemp("cyc")
    fasta = _tandem_fasta(d / "in.fa", 1500, seed=5)
    cfg, _ = _config(d, "port", fasta, 1200)
    records = []
    record = metrics.record

    def spy(tag, *args, **kwargs):
        records.append((tag, tuple(metrics._open)))
        return record(tag, *args, **kwargs)

    def release():
        records.append(("release", tuple(metrics._open)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(metrics, "record", spy)
        mp.setattr(core, "release_free_heap", release)
        mp.setattr(memory, "release_free_heap", release)
        rc, log, summary, _ = run_job(["-C", cfg, "--force-gfa-output"],
                                      CYC_TIER, mp)
    assert rc == 0, log[-800:]
    return log, summary, records


def _children(spans, k):
    return [s[0] for s in spans if s[1] == k]


def test_anchor_and_identify_sit_under_every_rounds_bond_chain(cyc):
    log, summary, _ = cyc
    spans = summary["spans"]
    rounds = len(stages.stage_split(log)["bonding"])
    assert rounds > 0
    with_kids = [k for k, s in enumerate(spans)
                 if s[0] == "bond.chain" and _children(spans, k)]
    assert len(with_kids) == rounds
    for k in with_kids:
        assert _children(spans, k) == ["bond.anchor", "bond.identify"]
    names = _names(spans)
    assert names.count(("bond.anchor", "bond.chain")) == rounds
    assert names.count(("bond.identify", "bond.chain")) == rounds
    # nowhere else
    assert sum(1 for s in spans if s[0] in ("bond.anchor",
                                             "bond.identify")) == 2 * rounds


def test_fuse_and_simplify_sit_under_cyclize(cyc):
    spans = cyc[1]["spans"]
    (k,) = [k for k, s in enumerate(spans) if s[0] == "cyclize"]
    assert _children(spans, k) == ["cyclize.fuse", "cyclize.simplify"]
    assert sum(1 for s in spans if s[0].startswith("cyclize.")) == 2


def test_self_times_still_sum_to_the_job(cyc):
    spans = cyc[1]["spans"]
    assert all(t >= 0 for t in _self_ns(spans))
    assert sum(_self_ns(spans)) == pytest.approx(spans[0][3] - spans[0][2],
                                                 rel=0.01)


def test_chain_masked_counts_each_rounds_masked_chaining(cyc):
    log, summary, records = cyc
    bonding = stages.stage_split(log)["bonding"]
    assert len({r["sequence"] for r in bonding}) == 2
    masked = summary["chain.masked"]
    assert masked["count"] >= len(bonding) > 0
    assert masked["cells"] > 0 and masked["seconds"] > 0
    # every round of every sequence: a record inside its bond.anchor, and
    # masked chainings nowhere else
    spans = summary["spans"]
    anchors = [k for k, s in enumerate(spans) if s[0] == "bond.anchor"]
    assert len(anchors) == len(bonding)
    for k in anchors:
        assert any(tag == "chain.masked" and k in open_
                   for tag, open_ in records)
    assert all(set(open_) & set(anchors)
               for tag, open_ in records if tag == "chain.masked")


def test_each_masked_chaining_is_counted_under_its_engine(cyc):
    _, summary, records = cyc
    tags = [tag for tag, _ in records if tag != "release"]
    at = [k for k, tag in enumerate(tags) if tag == "chain.masked"]
    assert at
    # each masked chaining's record and, right after it, its engine's
    engines = [tags[k + 1] for k in at]
    assert set(engines) <= {"chain.masked_cdq", "chain.masked_tree"}
    assert (tags.count("chain.masked_cdq") + tags.count("chain.masked_tree")
            == len(at))
    cells = sum(summary[t]["cells"] for t in set(engines))
    assert cells == summary["chain.masked"]["cells"]
    # every masked chaining here is chain x chain with its ties resolved
    assert summary["chain.masked_cdq"]["count"] == len(at)
    assert "chain.masked_tree" not in summary


def test_bond_found_counts_the_bonds_the_log_reports(cyc):
    log, summary, _ = cyc
    found = sum(r["found"] for r in stages.stage_split(log)["bonding"])
    assert found > 0
    assert summary["bond.found"]["count"] == found
    # a bond's length in bp: the tandem copies are about 1.5 kbp
    assert summary["bond.found"]["cells"] >= 1000 * found
    assert summary["bond.found"]["seconds"] == 0


@pytest.mark.parametrize("name", ["pair", "msa"])
def test_a_run_without_c_records_no_new_span_or_tag(jobs, name):  # noqa: F811
    rc, _, summary, _ = jobs[name]
    assert rc == 0
    assert not NEW_SPANS & {s[0] for s in summary["spans"]}
    assert not NEW_TAGS & set(summary)
    # the chainings keep their engines' tags, one record a SparseAffine
    # chaining of the subproblems
    chain_tags = {t for t in summary if t.startswith("chain.")}
    assert chain_tags and chain_tags <= {"chain.cdq", "chain.tree",
                                         "chain.tree_fallback"}
    assert sum(summary[t]["count"] for t in chain_tags) == sum(
        1 for s in summary["spans"] if s[0] == "chain")


def test_the_heap_is_handed_back_around_each_masked_chaining(cyc):
    log, summary, records = cyc
    spans = summary["spans"]
    rounds = len(stages.stage_split(log)["bonding"])
    where = [spans[open_[-1]][0] for tag, open_ in records
             if tag == "release"]
    # each round's start, inside its bond.chain; each masked chaining's
    # fill-in, inside its bond.anchor; once in the job after bonding,
    # before the first subproblem
    assert where.count("bond.chain") == rounds
    assert where.count("bond.anchor") == rounds
    assert len(where) == 2 * rounds + 1
    # the last in the job span itself, no other open
    assert [open_ for tag, open_ in records if tag == "release"][-1] == (0,)


def test_release_free_heap_hands_back_freed_pages():
    memory.release_free_heap()
    if not memory._malloc_trim:
        pytest.skip("the C library has no malloc_trim")
    # 64 MiB of heap chunks below a live one, which keeps the heap's top
    # from shrinking when they are freed
    chunks = [bytearray(1 << 16) for _ in range(1024)]
    pin = bytearray(1 << 16)
    del chunks
    before = memory.current_memory_usage()
    memory.release_free_heap()
    after = memory.current_memory_usage()
    assert before - after >= 32 << 20, (before, after)
    del pin

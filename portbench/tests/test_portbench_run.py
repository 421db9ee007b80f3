"""Whole runs of the harness on the CPU, without the look for a card: the
port's device tier on its plain versions (CENTROLIGN_TORCH_DEVICE=cpu),
small cells of a test copy (conftest.tiny_root). A sound run is correct;
a run with the timed path broken underneath is not, for each fault the
cells can have; the control (the int16 reference in the program's place)
fails the device numbers; and a run in which any of its processes loaded
a module named jax prints no result."""

import json
import os
import sys
import textwrap

import pytest

from portbench import run as harness
from portbench import traffic, worker

FAULTS = textwrap.dedent('''
    import os
    import sys
    import types
    FAULT = os.environ.get("PORTBENCH_TEST_FAULT")
    CLIENT = bool(os.environ.get("CENTROLIGN_TORCH_DEVICE"))
    if FAULT == ("jax_in_client" if CLIENT else "jax_in_reference"):
        # a stand-in module of that name, as if the process had loaded JAX
        sys.modules["jax"] = types.ModuleType("jax")
    if FAULT and CLIENT:
        import io
        import numpy as np
        from centrolign_tpu_torch import cli, stitcher
        if FAULT == "cigar":
            # an answer altered where it is produced: the first run of
            # equal bases begins with a mismatch
            good = cli.explicit_cigar
            def explicit_cigar(*a):
                text = good(*a)
                n = text.index("=")
                k = int(text[:n].split("X")[-1].split("D")[-1].split("I")[-1])
                head = text[:n - len(str(k))]
                return head + "1X" + (f"{k - 1}=" if k > 1 else "") + text[n + 1:]
            cli.explicit_cigar = explicit_cigar
        if FAULT == "gfa":
            good_gfa = cli.write_gfa
            def write_gfa(graph, tableau, out):
                buf = io.StringIO()
                good_gfa(graph, tableau, buf)
                lines = buf.getvalue().split("\\n")
                for k, line in enumerate(lines):
                    if line.startswith("S\\t"):
                        f = line.split("\\t")
                        f[2] = ("C" if f[2][0] != "C" else "G") + f[2][1:]
                        lines[k] = "\\t".join(f)
                        break
                out.write("\\n".join(lines))
            cli.write_gfa = write_gfa
        good_fetch = stitcher.gotoh_fetch
        if FAULT == "device_answer":
            # each device alignment's first aligned pair split in two gaps
            def gotoh_fetch(handle):
                out = []
                for aln, score in good_fetch(handle):
                    both = np.flatnonzero((aln[:, 0] >= 0) & (aln[:, 1] >= 0))
                    if len(both):
                        k = both[0]
                        i, j = aln[k]
                        aln = np.vstack([aln[:k], [[i, -1], [-1, j]],
                                         aln[k + 1:]])
                    out.append((aln, score))
                return out
            stitcher.gotoh_fetch = gotoh_fetch
        if FAULT == "device_half":
            # half of each dispatch's results left out
            def gotoh_fetch(handle):
                res = good_fetch(handle)
                return res[:len(res) // 2]
            stitcher.gotoh_fetch = gotoh_fetch
        if FAULT == "anchors":
            # chaining keeps every other anchor: the output stays an
            # alignment of its input, a worse one
            from centrolign_tpu_torch import anchorer
            good_chain = anchorer.Anchorer.anchor_chain
            def anchor_chain(self, *a, **k):
                return good_chain(self, *a, **k)[::2]
            anchorer.Anchorer.anchor_chain = anchor_chain
        if FAULT == "device_input":
            # the chain tier aligns the gap's bases in the wrong order
            good_order = stitcher._chain_order
            stitcher._chain_order = lambda sub: good_order(sub)[::-1].copy()
''')


@pytest.fixture
def fault(tmp_path, monkeypatch):
    d = tmp_path / "site"
    d.mkdir()
    (d / "sitecustomize.py").write_text(FAULTS)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(d), *filter(None, [os.environ.get("PYTHONPATH")])]))

    def plant(name):
        monkeypatch.setenv("PORTBENCH_TEST_FAULT", name)
    return plant


def _run(root, cell, seed, trace=False, control=False):
    return harness.run_cell(cell, seed, 3, trace, device_mode="cpu",
                            root=root, control=control)


def test_cli_twice_in_one_process_gives_equal_bytes(tmp_path, monkeypatch):
    from centrolign_tpu_torch import cli
    from portbench import spec
    monkeypatch.setenv("CENTROLIGN_TORCH_DEVICE", "cpu")
    cell = spec.cell("pair_185k")
    root = traffic.ancestor(cell["config"])
    path = str(tmp_path / "warm.fasta")
    argv = traffic.warmup_fasta(2 ** 33 + 5, path, root)
    first = worker.run_cli(cli, argv)
    second = worker.run_cli(cli, argv)
    assert first[0] == second[0] == 0
    assert first[1] and first[1] == second[1]


@pytest.mark.parametrize("cell", ["tiny_pair", "tiny_msa"])
def test_a_sound_run_is_correct_and_reports_its_metrics(tiny, cell):
    run, metrics, numbers = _run(tiny, cell, 2 ** 35 + 11, trace=True,
                                 control=True)
    assert all(n["ok"] for n in numbers.values()), numbers
    assert numbers["gotoh_checked"]["value"] > 0
    assert numbers["outputs_differ"]["value"] == 0
    assert run["attempted"] >= 1 and run["failed"] == 0
    kind = cell.split("_")[1]
    for name in ("calibration_ms_per_kbp", "chain_ms_per_kbp",
                 "device_cell_pct"):
        assert f"{name}.{kind}" in metrics
    assert metrics["job_rss_mib"]["value"] >= 0
    assert run["breakdown"]["idle_gaps"]
    # the control judged in the program's place fails a device number
    bad = [k for k, n in run["control"].items() if not n["ok"]]
    assert set(bad) <= {"gotoh_differ", "gotoh_shortfall_max"}


def test_end_to_end_metrics_of_an_untraced_run(tiny):
    run, metrics, numbers = _run(tiny, "tiny_pair", 9)
    assert sorted(metrics) == ["pair_kbp_per_s", "peak_rss_mib", "setup_s"]
    assert all(m["value"] > 0 for m in metrics.values())
    assert all(n["ok"] for n in numbers.values()), numbers


def test_a_job_without_an_expected_output_is_not_correct(tiny):
    base = os.path.join(tiny, "portbench", "expected")
    for name in os.listdir(base):
        os.remove(os.path.join(base, name))
    run, metrics, numbers = _run(tiny, "tiny_pair", 5)
    assert numbers["outputs_differ"]["value"] == run["attempted"] > 0
    assert run["failed"] == run["attempted"]
    assert "no expected output" in run["wrong"][0]["why"]


@pytest.mark.parametrize("name,cell,fails", [
    ("cigar", "tiny_pair", "outputs_wrong"),
    ("cigar", "tiny_pair", "outputs_differ"),
    ("gfa", "tiny_msa", "outputs_wrong"),
    ("anchors", "tiny_pair", "outputs_differ"),
    ("anchors", "tiny_msa", "outputs_differ"),
    ("device_answer", "tiny_pair", "gotoh_differ"),
    ("device_half", "tiny_pair", None),
    ("device_input", "tiny_pair", "gotoh_inputs_foreign"),
])
def test_a_broken_timed_path_is_not_correct(tiny, fault, name, cell, fails):
    """`fails` names the number the fault has to fail; None: the run has
    to fail outright (no result), as a warm-up that cannot align does."""
    fault(name)
    if fails is None:
        with pytest.raises(harness.RunFailed):
            _run(tiny, cell, 31)
        return
    run, metrics, numbers = _run(tiny, cell, 31)
    assert not numbers[fails]["ok"], numbers
    assert not all(n["ok"] for n in numbers.values())


def _main(tiny, monkeypatch, capsys):
    monkeypatch.setattr(harness, "card", lambda chips: ("a stand-in", None))
    rc = harness.main(["--workload", "tiny_pair", "--seed", "17",
                       "--seconds", "2", "--trace", "0"], root=tiny,
                      device_mode="cpu")
    return rc, capsys.readouterr()


def test_main_prints_one_result_line_with_its_checks_last(tiny, monkeypatch,
                                                          capsys):
    rc, out = _main(tiny, monkeypatch, capsys)
    assert rc == 0
    result = json.loads(out.out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert result["checks"]["outputs_differ"] == {"value": 0,
                                                  "limit": "<= 0"}
    assert "check outputs_differ 0 limit <= 0 ok" in out.err


@pytest.mark.parametrize("where", ["jax_in_client", "jax_in_reference",
                                   "jax_in_reader"])
def test_a_run_that_loaded_jax_prints_no_result(tiny, fault, monkeypatch,
                                                 capsys, where):
    if where == "jax_in_reader":
        # a metric reader that loads a module named jax once the window
        # and the reference are done
        reader = os.path.join(tiny, "portbench", "metrics", "setup_s.py")
        with open(reader, "a") as f:
            f.write("\nimport sys, types\n"
                    "sys.modules.setdefault('jax', types.ModuleType('jax'))\n")
    else:
        fault(where)
    try:
        rc, out = _main(tiny, monkeypatch, capsys)
    finally:
        stub = sys.modules.get("jax")
        if stub is not None and getattr(stub, "__file__", None) is None:
            del sys.modules["jax"]
    assert rc != 0
    assert out.out.strip() == ""
    assert "jax" in out.err

"""A configuration's `params` (reference/paramfile.py): loading refuses
what -C would override without a word, and the file a job gets is one
the port's own parser reads, partial as it is."""

import json
import os
import shutil

import pytest

from conftest import ROOT
from portbench import spec
from portbench.reference import paramfile

PARAMS = {"cyclize_tandem_duplications": True, "min_cyclizing_length": 2500,
          "max_realignment_cycle_size": 0, "inconsistent_indel_window": 0,
          "min_inconsistency_total_length": 1000000000}


@pytest.mark.parametrize("cli_args", [
    ["-c"], ["--cyclize"], ["-y", "2500"], ["--cyclizing-size=2500"],
    ["-u"], ["-v", "3"], ["-T", "tree.nwk"], ["-m", "100"], ["-a", "10"],
    ["-p", "1"], ["-g", "1"], ["-t", "2"], ["-R"], ["--skip-calibration"],
    ["--bond-prefix", "b"], ["-S", "cp"], ["-s", "sub.txt"], ["-A", "p"],
    ["-C", "other.cfg"], ["-G"], ["seqs.fasta"], ["--force"],
    ["--force-gfa-output", "-cu"], ["--hosts"],
])
def test_cli_args_that_set_a_parameter_are_refused(cli_args):
    with pytest.raises(ValueError):
        paramfile.check({"params": PARAMS, "cli_args": cli_args})


@pytest.mark.parametrize("cli_args", [
    [], ["--force-gfa-output"], ["--hosts", "2"], ["--hosts=2"],
    ["--hosts", "2", "--force-gfa-output"],
])
def test_cli_args_that_minus_c_keeps_are_taken(cli_args):
    paramfile.check({"params": PARAMS, "cli_args": cli_args})


@pytest.mark.parametrize("params", [
    {"fasta_name": "x.fasta"}, {"tree_name": "t.nwk"}, {"logging_level": 3},
    {"bonds_prefix": "bond"}, {"subproblems_prefix": "cp"},
    {"all_pairs_prefix": "p"}, {"subalignments_filepath": "s"},
    {"Min_Length": 1}, {"min_cyclizing_length": None},
    {"anchor_gap_open": [1, 2]}, {"window_length": {"a": 1}},
    {"x": "a # b"}, [["min_cyclizing_length", 1]],
])
def test_params_the_file_cannot_carry_are_refused(params):
    with pytest.raises(ValueError):
        paramfile.check({"params": params, "cli_args": []})


def test_loading_a_cell_refuses_an_overridden_flag(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = os.path.join(root, "portbench", "configs", "pair-hor.json")
    with open(path) as f:
        config = json.load(f)
    config["params"] = PARAMS
    for cli_args, ok in ((["--force-gfa-output"], True), (["-c"], False)):
        config["cli_args"] = cli_args
        with open(path, "w") as f:
            json.dump(config, f)
        if ok:
            assert spec.cell("pair_185k", root)["config"]["params"] == PARAMS
        else:
            with pytest.raises(ValueError, match="-C"):
                spec.cell("pair_185k", root)


def test_the_ports_parser_reads_a_partial_file(tmp_path):
    from centrolign_tpu_torch.params import Parameters
    path = str(tmp_path / "job0.cfg")
    params = {**PARAMS, "anchor_gap_open": [1.5, 50, 5000],
              "pair_count_power": 0.25}
    paramfile.write(path, params, "/data/job 0.fasta", "/data/job0.nwk", 3)
    with open(path) as f:
        text = f.read()
    got = Parameters(text)
    assert got.get("fasta_name") == "/data/job 0.fasta"
    assert got.get("tree_name") == "/data/job0.nwk"
    assert got.get("logging_level") == 3
    assert got.get("cyclize_tandem_duplications") is True
    assert got.get("min_cyclizing_length") == 2500
    assert got.get("max_realignment_cycle_size") == 0
    assert got.get("min_inconsistency_total_length") == 1000000000
    assert got.get("anchor_gap_open") == (1.5, 50.0, 5000.0)
    assert got.get("pair_count_power") == 0.25
    # every parameter the file does not name keeps its default
    assert got.get("max_tandem_duplication_search_rounds") == 3
    assert got.get("constraint_method") == 3
    assert paramfile.parse(text) == {
        "fasta_name": "/data/job 0.fasta", "tree_name": "/data/job0.nwk",
        "logging_level": "3", "cyclize_tandem_duplications": "true",
        "min_cyclizing_length": "2500", "max_realignment_cycle_size": "0",
        "inconsistent_indel_window": "0",
        "min_inconsistency_total_length": "1000000000",
        "anchor_gap_open": "1.5,50,5000", "pair_count_power": "0.25"}
    # the program's own -G output reads the same through parse
    assert paramfile.parse(got.generate_config())["min_cyclizing_length"] \
        == "2500"

"""The port's sanitizer tier: its native runtime built under ASan and UBSan.

CENTROLIGN_TPU_NATIVE_SANITIZE=1 builds every source of
centrolign_tpu_torch/native/ with -fsanitize=address,undefined
-fno-sanitize-recover=all into _build/libnative_san-<hash>.so, and the host
side of every csrc/*.cu into _build/lib<name>_san-<hash>.so (the reference's
-DDEV=ON build, reference CMakeLists.txt:19-25). A sanitized library loads
only into a process that has the sanitizer runtimes preloaded, so the runs
marked `slow` are subprocesses with LD_PRELOAD=libasan.so:libubsan.so and
ASAN_OPTIONS=detect_leaks=0 (CPython's own allocations are not the tier's
concern). Any out-of-bounds access, use-after-free or undefined behaviour
in the native code ends the run (-fno-sanitize-recover=all), which fails
the checks on its report, its exit code and its output: the pair.fasta
CIGAR byte-identical to the reference, the level schedules equal to the
plain library's, a small MSA's GFA equal to the plain run's.

The counted tests check the switch without compiling: the library names
and the command lines of both builds, and the refusal to load a sanitized
library without the preload.
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

from centrolign_tpu_torch import native
from centrolign_tpu_torch.ops import _build, chain_cdq, chain_scan

from test_torch_chain_levels import (CDQ_PROBLEMS, EVENT_PROBLEMS,
                                     _cdq_problems, _events)
from chip_smoke import cdq_problem, scan_problem
from test_torch_cli import _write_msa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR = os.path.join(REPO, "benchdata", "pair.fasta")
REF_CIGAR = os.path.join(REPO, "benchdata", "ref_pair.cigar.txt")


# ---------------------------------------------------------------------------
# the switch (counted; nothing compiles)


class _Proc:
    """A finished compiler process that wrote its output file."""

    def __init__(self, cmd, rc=0):
        self.returncode = rc
        if rc == 0:
            with open(cmd[cmd.index("-o") + 1], "w"):
                pass

    def wait(self):
        return self.returncode

    def communicate(self):
        return ("ptxas info    : Used 32 registers\n", None)


@pytest.fixture
def compilers(monkeypatch, tmp_path):
    """Every g++ and nvcc command either build runs, recorded in order;
    the builds write into tmp_path. `fail` makes every command fail."""
    calls = {"cmds": [], "fail": False}

    def popen(cmd, **kw):
        calls["cmds"].append(list(cmd))
        return _Proc(cmd, 1 if calls["fail"] else 0)

    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.setattr(subprocess, "run", popen)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.delenv(native.SANITIZE_ENV, raising=False)
    return calls


def test_native_switch_selects_the_sanitized_build(compilers, monkeypatch):
    so = native._built_library(native.sanitizing())
    plain = compilers["cmds"]
    compilers["cmds"] = []
    monkeypatch.setenv(native.SANITIZE_ENV, "1")
    so_san = native._built_library(native.sanitizing())
    san = compilers["cmds"]

    digest = native._source_hash()[:16]
    assert os.path.basename(so) == f"libnative-{digest}.so"
    assert os.path.basename(so_san) == f"libnative_san-{digest}.so"
    srcs = [os.path.join(native._DIR, s) for s in native._SOURCES]
    assert len(srcs) == 13 and srcs[-1].endswith("chain_levels.cpp")
    # the plain build's command lines, as they were before the tier
    assert [c[:-3] for c in plain[:-1]] == \
        [["g++", "-O3", "-std=c++17", "-fPIC", "-fopenmp", "-c"]] * 13
    assert [c[-1] for c in plain[:-1]] == srcs
    assert plain[-1][:5] == ["g++", "-shared", "-fopenmp", "-o",
                             f"{so}.{os.getpid()}.tmp"]
    # the sanitized one: every source, and the link
    san_flags = ["-O1", "-g", "-fsanitize=address,undefined",
                 "-fno-sanitize-recover=all", "-std=c++17", "-fPIC"]
    assert [c[:-3] for c in san[:-1]] == \
        [["g++", *san_flags, "-fopenmp", "-c"]] * 13
    assert [c[-1] for c in san[:-1]] == srcs
    assert san[-1][:4] == ["g++", "-shared", "-fsanitize=address,undefined",
                           "-fopenmp"]


@pytest.mark.parametrize("sanitize", [False, True])
def test_native_build_failure_raises(compilers, monkeypatch, sanitize):
    """A failed build raises, with and without OpenMP; a failed sanitized
    build does not fall back to the plain library."""
    if sanitize:
        monkeypatch.setenv(native.SANITIZE_ENV, "1")
    compilers["fail"] = True
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._built_library(native.sanitizing())
    assert len(compilers["cmds"]) == 2 * 13
    assert all(("-fsanitize=address,undefined" in c) == sanitize
               for c in compilers["cmds"])
    assert not os.listdir(native._BUILD_DIR) or \
        os.listdir(native._BUILD_DIR) == ["native.lock"]


def test_nvcc_switch_selects_the_sanitized_build(compilers, monkeypatch):
    _build.build_libraries(["gotoh"])
    monkeypatch.setenv(native.SANITIZE_ENV, "1")
    _build.build_libraries(["gotoh"])
    (plain,), (san,) = compilers["cmds"][:1], compilers["cmds"][1:]
    src = os.path.join(_build.CSRC, "gotoh.cu")
    # named by the source and the header it includes
    with open(src, "rb") as f, \
            open(os.path.join(_build.CSRC, "jitter.cuh"), "rb") as h:
        digest = hashlib.sha256(f.read() + h.read()).hexdigest()[:16]
    lib = os.path.join(_build.BUILD_DIR, f"libgotoh-{digest}.so")
    lib_san = os.path.join(_build.BUILD_DIR, f"libgotoh_san-{digest}.so")
    tmp = f".{os.getpid()}.tmp"
    # the plain command line, as it was before the tier
    assert plain == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v", "-o", lib + tmp, src]
    # the sanitized one: the same device flags, the sanitizers on the host
    # side only, one a flag (nvcc splits -Xcompiler's argument at commas)
    assert san == ["nvcc", *plain[1:10], "-Xcompiler", "-fsanitize=address",
                   "-Xcompiler", "-fsanitize=undefined", "-Xcompiler",
                   "-fno-sanitize-recover=all", "-Xcompiler", "-g", "-o",
                   lib_san + tmp, src]
    # each library with nvcc's report beside it, read back per build
    assert sorted(os.listdir(_build.BUILD_DIR)) == sorted(
        os.path.basename(p) for so in (lib, lib_san)
        for p in (so, so[:-3] + ".log"))
    for sanitize in (False, True):
        assert _build.build_log("gotoh", sanitize) == \
            "ptxas info    : Used 32 registers\n"


def test_nvcc_library_without_its_report_builds_anew(compilers):
    """A library whose ptxas report is missing is not taken as built, so
    every built library has its report; one with its report is reused."""
    _build.build_libraries(["gotoh"])
    _build.build_libraries(["gotoh"])
    assert len(compilers["cmds"]) == 1
    os.remove(_build._library_path("gotoh")[:-3] + ".log")
    assert _build.build_log("gotoh") == ""
    _build.build_libraries(["gotoh"])
    assert len(compilers["cmds"]) == 2
    assert "Used 32 registers" in _build.build_log("gotoh")
    assert _build.build_log("gotoh", sanitize=True) == ""


@pytest.mark.parametrize("loader", ["native", "nvcc"])
def test_sanitized_load_without_preload_raises(monkeypatch, loader):
    """Loading a sanitized library into a process without the runtimes
    would end it in ASan's own check; the loaders raise first, naming the
    preload, and never open the library."""
    assert not native.sanitizer_runtimes_loaded()
    monkeypatch.setenv(native.SANITIZE_ENV, "1")

    def no_dlopen(*a, **kw):
        raise AssertionError("the sanitized library was opened")

    monkeypatch.setattr(native.ctypes, "CDLL", no_dlopen)
    if loader == "native":
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_built_library",
                            lambda sanitize: "/nonexistent/libnative_san.so")
        load = native.get_lib
    else:
        monkeypatch.setattr(_build, "_libs", {})
        monkeypatch.setattr(_build, "build_libraries", lambda names: None)

        def load():
            return _build.load_library("gotoh")
    with pytest.raises(RuntimeError) as err:
        load()
    assert native.PRELOAD in str(err.value)
    assert "libasan.so" in native.PRELOAD and "libubsan.so" in native.PRELOAD
    assert "_san" in str(err.value)


@pytest.mark.parametrize("missing", [None, "libasan.so", "libubsan.so"])
def test_sanitizer_preload_resolves_both_runtimes(monkeypatch, tmp_path,
                                                  missing):
    """The preload is g++'s path of each runtime, joined by ':'; a runtime
    that g++ does not have (it echoes the bare name) raises."""
    cmds = []

    class _Out:
        def __init__(self, name):
            self.stdout = name + "\n"
            if name != missing:
                self.stdout = str(tmp_path / name) + "\n"
                (tmp_path / name).touch()

    def run(cmd, **kw):
        cmds.append(cmd)
        return _Out(cmd[1].split("=", 1)[1])

    monkeypatch.setattr(subprocess, "run", run)
    if missing:
        with pytest.raises(RuntimeError, match=f"g\\+\\+ has no {missing}"):
            native.sanitizer_preload()
        return
    assert native.sanitizer_preload() == \
        f"{tmp_path / 'libasan.so'}:{tmp_path / 'libubsan.so'}"
    assert cmds == [["g++", "-print-file-name=libasan.so"],
                    ["g++", "-print-file-name=libubsan.so"]]


# ---------------------------------------------------------------------------
# runs under ASan and UBSan (slow)


@pytest.fixture(scope="module")
def san_env():
    """The environment of a sanitized run, the sanitized library built
    first (here, without the preload: g++ runs uninstrumented)."""
    try:
        preload = native.sanitizer_preload()
    except RuntimeError as err:
        pytest.skip(str(err))
    native._built_library(True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CENTROLIGN_")}
    env.update(CENTROLIGN_TORCH_DEVICE="none", LD_PRELOAD=preload,
               ASAN_OPTIONS="detect_leaks=0",
               **{native.SANITIZE_ENV: "1"})
    return env


def _plain(env):
    return {k: v for k, v in env.items()
            if k not in ("LD_PRELOAD", "ASAN_OPTIONS", native.SANITIZE_ENV)}


def _run(argv, env, timeout=900):
    return subprocess.run([sys.executable, *argv], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=timeout)


def _clean(r):
    assert "AddressSanitizer" not in r.stderr, r.stderr[-4000:]
    assert "runtime error:" not in r.stderr, r.stderr[-4000:]
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.slow
def test_pair_fasta_host_only_under_asan_ubsan(san_env):
    r = _run(["-m", "centrolign_tpu_torch.cli", "-v", "0", PAIR], san_env)
    _clean(r)
    with open(REF_CIGAR) as f:
        assert r.stdout == f.read(), "the sanitized run changed the CIGAR"


_LEVELS = r"""
import sys
import numpy as np
sys.path.insert(0, {repo!r})
from centrolign_tpu_torch import native
assert native.sanitizing() and native.sanitizer_runtimes_loaded()
x = np.load({inp!r})
out = {{}}
for k in x.files:
    if k.startswith("cdq_ps1_"):
        i = k[len("cdq_ps1_"):]
        out["cdq_" + i] = native.cdq_row_levels(x[k], x["cdq_pe1_" + i])
    elif k.startswith("ev_"):
        i = k[len("ev_"):]
        out["ev_" + i] = native.chain_event_levels(x[k], int(x["n_" + i]))
    elif k.startswith("bad_"):
        try:
            native.chain_event_levels(x[k], int(x["badn_" + k[4:]]))
        except ValueError:
            out[k] = np.ones(1)
assert "native_san" in native._lib._name
np.savez({out!r}, **out)
"""


def _level_inputs():
    """tests/test_torch_chain_levels.py's problems and one of n = 1: the
    CDQ scan's sorted rows (a chain, ties, anchors that end before they
    start, n 0 in the batch) and the event scan's streams, and the three
    streams the event schedule must refuse."""
    inp = {}
    rng = np.random.default_rng(1)
    for name in CDQ_PROBLEMS + ["one"]:
        problems = ([cdq_problem(rng, 1)] if name == "one"
                    else _cdq_problems(name))
        n_pad = max(max(len(p[0]) for p in problems), 1)
        _, arrays = chain_cdq.pack(problems, n_pad)
        for b, p in enumerate(problems):
            n = len(p[0])
            inp[f"cdq_ps1_{name}{b}"] = arrays[1][b, :n, 0].astype(np.int64)
            inp[f"cdq_pe1_{name}{b}"] = arrays[0][b, :n, 0].astype(np.int64)
    for name in EVENT_PROBLEMS + ["one"]:
        if name == "one":
            _, _, ev, dp0, _ = chain_scan.build_events(
                *scan_problem(rng, 1)[:6])
        else:
            ev, dp0 = _events(name)
        inp[f"ev_{name}"], inp[f"n_{name}"] = ev, np.int64(len(dp0))
    ev = np.array([[0, 0, 1, 0], [1, 0, 0, 0], [1, 0, 0, 0]], np.int32)
    for k, (bad, n) in enumerate(((ev, 1), (ev[[0, 0]], 1), (ev[:1], 0))):
        inp[f"bad_{k}"], inp[f"badn_{k}"] = bad, np.int64(n)
    return inp


@pytest.mark.slow
def test_level_schedules_under_asan_ubsan(san_env, tmp_path):
    inp = _level_inputs()
    assert any(len(v) == 0 for k, v in inp.items() if k.startswith("cdq_ps1"))
    assert any(len(v) == 1 for k, v in inp.items() if k.startswith("cdq_ps1"))
    np.savez(tmp_path / "in.npz", **inp)
    script = _LEVELS.format(repo=REPO, inp=str(tmp_path / "in.npz"),
                            out=str(tmp_path / "out.npz"))
    r = _run(["-c", script], san_env)
    _clean(r)
    got = np.load(tmp_path / "out.npz")
    n_cdq = n_ev = 0
    for k, v in inp.items():
        if k.startswith("cdq_ps1_"):
            i = k[len("cdq_ps1_"):]
            want = native.cdq_row_levels(v, inp["cdq_pe1_" + i])
            assert np.array_equal(got["cdq_" + i], want), k
            n_cdq += 1
        elif k.startswith("ev_"):
            want = native.chain_event_levels(v, int(inp["n_" + k[3:]]))
            assert np.array_equal(got[k], want), k
            n_ev += 1
        elif k.startswith("bad_"):
            assert k in got.files, f"the sanitized schedule took {k}"
    assert n_cdq == 1 + sum(len(_cdq_problems(n)) for n in CDQ_PROBLEMS)
    assert n_ev == 1 + len(EVENT_PROBLEMS)


@pytest.mark.slow
def test_small_msa_under_asan_ubsan(san_env, tmp_path):
    """Three sequences with divergent blocks: the graph, bubble and
    fill-in paths that a pair does not reach."""
    fasta = _write_msa(tmp_path / "msa.fasta", 17)
    tree = tmp_path / "msa.nwk"
    tree.write_text("((g0,g1),g2);\n")
    argv = ["-m", "centrolign_tpu_torch.cli", "-v", "0", "-T", str(tree),
            fasta]
    plain = _run(argv, _plain(san_env))
    assert plain.returncode == 0, plain.stderr[-2000:]
    assert plain.stdout.startswith("H\t")
    r = _run(argv, san_env)
    _clean(r)
    assert r.stdout == plain.stdout, "the sanitized run changed the GFA"

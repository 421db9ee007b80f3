"""The checks of chip_smoke.py's phases 12 to 14, as far as the CPU
reaches: the families' loop of phase 12 (poisoned memory, stubbed here),
guard bands (ops/guard.py), the launchers' `*_buffers` / `*_into` split,
and the jitter build (csrc/jitter.cuh, ops/_build.py).

On the CPU each `*_into` writes the plain version's result into
caller-given tensors, so every kernel family of phase 13 runs here inside
guard bands, at a small size, against the package's own wrappers and the
plain versions (exact: integer DP, and the same float operations in the
same order). The guard itself is held against writes one element before
and after a payload, a changed input, and a band read that reaches an
output. The jitter build is checked without compiling (nvcc is
monkeypatched): its command line and library name beside the plain
build's, which stay as they were, and that only an explicit argument
loads it.
"""

import copy
import hashlib
import os
import re
import subprocess
from math import prod

import numpy as np
import pytest
import torch

import chip_smoke
from centrolign_tpu_torch import native
from centrolign_tpu_torch.ops import (_build, chain_cdq_cuda, chain_scan_cuda,
                                      gotoh_cuda, guard, popoa_dag_cuda,
                                      sharded_gotoh_cuda)
from centrolign_tpu_torch.ops.align_params import MININF, AlignmentParams
from centrolign_tpu_torch.parallel import sharded_gotoh as sh

CPU = torch.device("cpu")
PARAMS = AlignmentParams(20, 80, (60, 800, 2500), (30, 5, 1))


# ---------------------------------------------------------------------------
# the guard


@pytest.mark.parametrize("shape,dtype,init", [
    ((0,), torch.int32, None), ((5,), torch.int16, 0),
    ((3, 7, 2), torch.float32, -1.5), ((2, 300, 400), torch.uint8, None),
    ((1000, 70), torch.int64, 7)])
def test_guard_view(shape, dtype, init):
    """A guarded tensor: its shape, dtype and init, its payload on a
    256-byte boundary between two bands of at least 64 KiB and one row of
    its last two dimensions."""
    g = guard.Guard(0xA5)
    x = g.empty("x", shape, dtype, CPU, init)
    assert x.shape == shape and x.dtype == dtype and x.is_contiguous()
    buf, band, nbytes, kept = g.entries["x"]
    assert kept is None and nbytes == x.numel() * x.element_size()
    assert band % guard.ALIGN == 0 and band >= guard.BAND_MIN
    assert band >= prod(shape[-2:]) * x.element_size()
    assert len(buf) == 2 * band + nbytes
    assert (buf.data_ptr() + band) % guard.ALIGN == 0
    if x.numel():
        assert x.data_ptr() == buf.data_ptr() + band
    if init is None:
        assert (x.reshape(-1).view(torch.uint8) == 0xA5).all()
    else:
        assert (x == init).all()
    assert (buf[:band] == 0xA5).all() and (buf[band + nbytes:] == 0xA5).all()
    assert g.check() == []


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.float32,
                                   torch.int64])
@pytest.mark.parametrize("where", ["before", "after"])
def test_check_names_a_write_beside_the_payload(where, dtype):
    """One element written just before or just after a payload: check()
    names each of its bytes, with the tensor, the side and the offset."""
    g = guard.Guard(0x5A)
    g.empty("other", (10,), torch.int32, CPU)
    x = g.empty("out", (4, 33), dtype, CPU, 0)
    x.fill_(3)  # writes inside the payload are no change
    assert g.check() == []
    buf, band, nbytes, _ = g.entries["out"]
    size = x.element_size()
    at = band - size if where == "before" else band + nbytes
    buf[at:at + size].view(dtype).fill_(1)
    changes = g.check()
    assert len(changes) == size
    assert {(c.tensor, c.where) for c in changes} == {("out", where)}
    want = range(-size, 0) if where == "before" else range(nbytes,
                                                           nbytes + size)
    assert sorted(c.offset for c in changes) == list(want)
    assert all(c.value != 0x5A for c in changes)
    assert f"out: {where} the payload" in guard.report(changes)


def test_check_names_a_changed_input():
    g = guard.Guard(0xA5)
    x = torch.arange(50, dtype=torch.int32)
    gx = g.input("in", x)
    assert torch.equal(gx, x) and gx.data_ptr() != x.data_ptr()
    assert g.check() == []
    gx[17] += 1
    changes = g.check()
    assert [(c.tensor, c.where, c.offset) for c in changes] == \
        [("in", "payload", 68)]
    assert "in: input changed at offset 68" in guard.report(changes)


def test_report_is_cut():
    changes = [guard.Change("t", "after", k, 0) for k in range(30)]
    text = guard.report(changes, limit=5)
    assert len(text.splitlines()) == 6 and "25 more" in text


# ---------------------------------------------------------------------------
# the launchers' buffers


def test_buffers_contract():
    """The specs each launcher allocates: inits and spares as the
    launchers had them (Gotoh bp zeroed with 8 entries of room, the DAG bp
    zeroed, the grid barriers' counters zeroed, L5's state and score
    MININF, one halo slot per chunk)."""
    i16, i32, i64 = torch.int16, torch.int32, torch.int64
    assert gotoh_cuda.gotoh_fill_buffers(3, 100) == [
        ("bp", (108,), i16, 0), ("score", (3,), i32, None)]
    assert gotoh_cuda.gotoh_traceback_buffers(3, 50) == [
        ("out", (3, 51, 2), i32, 0)]
    assert popoa_dag_cuda.popoa_dag_fill_buffers(70, 4, 0) == [
        ("bp", (70,), i32, 0), ("sinkm", (4,), i32, None),
        ("scratch", (1,), i32, None)]
    assert popoa_dag_cuda.popoa_dag_traceback_buffers(2, 9) == [
        ("out", (2, 12, 2), i32, 0)]
    cdq = dict((s[0], s[1:]) for s in chain_cdq_cuda.cdq_scan_buffers(2, 5,
                                                                       132))
    assert cdq["bar"] == ((1,), i64, 0)
    assert cdq["part"][0] == (132, chain_cdq_cuda.PART_QUERIES, 7, 4)
    assert cdq["table"][0] == (2, 5, 8)
    scan = dict((s[0], s[1:]) for s in chain_scan_cuda.event_scan_buffers(
        9, 4, 132))
    assert scan["bar"] == ((1,), i64, 0) and scan["row"][0] == (6, 2)
    mesh = [[CPU, CPU, torch.device("cuda", 0)]]
    specs = sh.shard_buffers(mesh, 1, 768, 300, True)
    Wl, H, _, chunks = sh.shard_layout(768, 3, 300)
    for s in range(3):
        d = dict((x[0], x[1:]) for x in specs[(0, s)])
        assert d["state"] == ((2, 1, sh.HALO_Q, Wl), i32, MININF)
        assert d["score"] == ((1,), i32, MININF)
        assert d["bp"] == ((300, 1, Wl), i16, None)
        assert ("out" in d) == (s < 2)
        # halo slots copied in only from a shard on another device
        assert ("in" in d) == (s == 2)
        if "in" in d:
            assert d["in"][0] == (chunks, 1, sh.HALO_Q, H)
    assert "bp" not in dict((x[0], x) for x in sh.shard_buffers(
        [[CPU]], 1, 256, 10, False)[(0, 0)])


def test_into_refuses_other_buffers():
    s1 = np.arange(20, dtype=np.int32) % 4
    s2 = np.arange(25, dtype=np.int32) % 4
    jobs = [(s1, s2, False, PARAMS)]
    table, seqs = gotoh_cuda.params_table(jobs), gotoh_cuda.pack_seqs(jobs)
    bp_size, plan, _ = gotoh_cuda.launch_sizes(jobs)
    bufs = gotoh_cuda.allocate(gotoh_cuda.gotoh_fill_buffers(1, bp_size), CPU)
    bufs["bp"] = bufs["bp"][:-1]
    with pytest.raises(ValueError, match="bp must be"):
        gotoh_cuda.gotoh_fill_into(table, seqs, bp_size, plan, bufs)
    del bufs["bp"]
    with pytest.raises(ValueError, match="no buffer 'bp'"):
        gotoh_cuda.gotoh_fill_into(table, seqs, bp_size, plan, bufs)


# ---------------------------------------------------------------------------
# every kernel family inside guard bands (phase 13 on the CPU)


FAMILIES = ["Gotoh fill", "Gotoh traceback", "single-problem entry",
            "DAG fill", "DAG traceback", "L3", "L4", "L5"]


@pytest.fixture(scope="module")
def inputs():
    return chip_smoke.family_inputs(np.random.default_rng(1311), PARAMS,
                                    small=True)


@pytest.fixture(scope="module")
def families(inputs):
    fams = {f.name: f for f in chip_smoke.guard_families(inputs, PARAMS,
                                                         CPU)}
    assert list(fams) == FAMILIES
    return fams


@pytest.mark.parametrize("name", FAMILIES)
def test_into_inside_guard_bands(families, name):
    """The family's `*_into` on guarded inputs and buffers equals the
    package's wrapper and the plain version bit for bit, under both band
    patterns, and leaves every band and input as it was."""
    fam = families[name]
    wrapper = {k: chip_smoke.as_bytes(v) for k, v in fam.wrapper().items()}
    chip_smoke.check_run(fam, wrapper, [], "through its wrapper")
    outs = []
    for pattern in chip_smoke.GUARD_PATTERNS:
        out, changes = chip_smoke.run_guarded(fam, pattern)
        assert changes == []
        chip_smoke.check_run(fam, out, changes, f"bands of {pattern:#x}")
        outs.append(out)
    assert all(torch.equal(outs[0][k][1], outs[1][k][1]) for k in outs[0])


def test_poisoned_memory_runs_every_family(families, inputs, monkeypatch):
    """Phase 12 on the CPU, its poisoning stubbed (the CPU has no caching
    allocator): every family through its wrappers and the single-problem
    pair through gotoh_align_device equal the plain versions, after each
    pattern; another pair through the entry is named."""
    poisoned = []
    monkeypatch.setattr(chip_smoke, "poison_free", lambda device, byte: (
        poisoned.append(byte), {"large": 0, "small": 0})[1])
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda device: {"segment.all.allocated": 0})
    fams = list(families.values())
    chip_smoke.poisoned_memory(fams, inputs["single"], CPU, "cpu")
    assert poisoned == [0xA5, 0x5A]
    s1, s2, swap, params = inputs["single"]
    with pytest.raises(RuntimeError, match="gotoh_align_device aln, "
                       "unpoisoned: differs"):
        chip_smoke.poisoned_memory(fams, (s2, s1, swap, params), CPU, "cpu")


def _past_end(x):
    """A view of `x` flattened with one more element."""
    return torch.as_strided(x, (x.numel() + 1,), (1,))


@pytest.mark.parametrize("fault,message", [
    ("write past an output", "after the payload"),
    ("change an input", "input changed"),
    ("read a band into an output", "differs from its plain version")])
def test_guarded_run_catches(families, fault, message):
    """Phase 13 on a launch made faulty: each fault raises, naming it."""
    fam = families["L4"]
    launch = fam.launch

    def faulty(ins, bufs, jitter):
        out = launch(ins, bufs, jitter)
        winner = bufs["scan"]["winner"]
        if fault == "write past an output":
            _past_end(winner)[-1] = 7
        elif fault == "change an input":
            ins["scan"]["ev"][0, 0] += 1
        else:
            winner[-1] = _past_end(winner)[-1]
        return out

    fam_bad = copy.copy(fam)
    fam_bad.launch = faulty
    with pytest.raises(RuntimeError, match=message):
        chip_smoke.check_run(fam_bad, *chip_smoke.run_guarded(fam_bad, 0x5A),
                             "a faulty launch")


def test_jitter_runs_count_the_runs_that_differ(families, monkeypatch):
    """Phase 14 runs all of a family's seeds x sleeps and then names how
    many differed and the first (the jitter setting recorded, nothing
    compiles)."""
    fam = families["L4"]
    launch, seeds = fam.launch, []
    monkeypatch.setattr(_build, "set_jitter",
                        lambda name, seed, max_ns: seeds.append(seed))
    monkeypatch.setattr(chip_smoke, "JITTER_SEEDS", (1, 2, 3))

    def racy(ins, bufs, jitter):
        out = launch(ins, bufs, jitter)
        if seeds[-1] == 2:
            out["winner"][0] += 1
        return out

    chip_smoke.jitter_runs([fam], "cpu")
    assert seeds == [1, 1, 2, 2, 3, 3, 0]
    fam_bad = copy.copy(fam)
    fam_bad.launch = racy
    with pytest.raises(RuntimeError, match=r"L4: 2 of 6 jitter runs differ; "
                       r"the first: L4 winner, jitter seed 2, max 200 ns"):
        chip_smoke.jitter_runs([fam_bad], "cpu")
    assert seeds[-1] == 0


# ---------------------------------------------------------------------------
# the jitter build (nothing compiles)


class _Nvcc:
    """A finished nvcc that wrote its output file."""

    def __init__(self, cmd, rc):
        self.returncode = rc
        if rc == 0:
            with open(cmd[cmd.index("-o") + 1], "w"):
                pass

    def communicate(self):
        return ("ptxas info    : Used 40 registers\n", None)


@pytest.fixture
def nvcc(monkeypatch, tmp_path):
    """Every nvcc command line, recorded; `fail` makes them fail."""
    calls = {"cmds": [], "fail": False}

    def popen(cmd, **kw):
        calls["cmds"].append(list(cmd))
        return _Nvcc(cmd, 1 if calls["fail"] else 0)

    monkeypatch.setattr(subprocess, "Popen", popen)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.delenv(native.SANITIZE_ENV, raising=False)
    return calls


@pytest.mark.parametrize("sanitize", [False, True])
def test_jitter_build_command_line(nvcc, monkeypatch, sanitize):
    """The jitter build is the plain command line plus
    -DCENTROLIGN_JITTER=1, into lib<name>_jit-<hash>.so (whatever the
    sanitizer switch); the plain build's command line and name are as
    they were, the hash taken over the source and jitter.cuh."""
    _build.build_libraries(["gotoh"])
    if sanitize:
        monkeypatch.setenv(native.SANITIZE_ENV, "1")
    _build.build_jitter_libraries(["gotoh"])
    plain, jit = nvcc["cmds"]
    src = os.path.join(_build.CSRC, "gotoh.cu")
    with open(src, "rb") as f, \
            open(os.path.join(_build.CSRC, "jitter.cuh"), "rb") as h:
        digest = hashlib.sha256(f.read() + h.read()).hexdigest()[:16]
    lib = os.path.join(_build.BUILD_DIR, f"libgotoh-{digest}.so")
    lib_jit = os.path.join(_build.BUILD_DIR, f"libgotoh_jit-{digest}.so")
    tmp = f".{os.getpid()}.tmp"
    assert plain == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v", "-o", lib + tmp, src]
    assert jit == [*plain[:10], "-DCENTROLIGN_JITTER=1", "-o", lib_jit + tmp,
                   src]
    assert sorted(os.listdir(_build.BUILD_DIR)) == sorted(
        os.path.basename(p) for so in (lib, lib_jit)
        for p in (so, so[:-3] + ".log"))
    assert "Used 40" in _build.build_log("gotoh", jitter=True)
    _build.build_jitter_libraries(["gotoh"])  # built: no nvcc
    assert len(nvcc["cmds"]) == 2


def test_jitter_build_failure_raises(nvcc, monkeypatch):
    """A failed jitter build raises; nothing falls back to the plain
    library."""
    opened = []
    monkeypatch.setattr(_build.ctypes, "CDLL", opened.append)
    monkeypatch.setattr(native, "open_library",
                        lambda *a: opened.append(a))
    _build.build_libraries(["gotoh"])
    nvcc["fail"] = True
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load_library("gotoh", jitter=True)
    assert opened == [] and _build._libs == {}


def test_only_an_explicit_argument_loads_the_jitter_build(monkeypatch):
    """Every kernel wrapper's `_lib()` loads the plain library, whatever
    the environment; `_lib(True)` the jitter one."""
    loaded = []

    class _Lib:
        def __getattr__(self, name):
            return _Fn()

    class _Fn:
        pass

    def load(name, jitter=False):
        loaded.append((name, jitter))
        return _Lib()

    monkeypatch.setattr(_build, "load_library", load)
    monkeypatch.setenv("CENTROLIGN_JITTER", "1")
    mods = [gotoh_cuda, popoa_dag_cuda, chain_cdq_cuda, chain_scan_cuda,
            sharded_gotoh_cuda]
    for mod in mods:
        mod._lib()
        mod._lib(True)
    assert loaded == [(n, j) for n in ("gotoh", "popoa_dag", "chain_cdq",
                                       "chain_scan", "sharded_gotoh")
                      for j in (False, True)]


def test_header_is_hashed(monkeypatch, tmp_path):
    """An edit of jitter.cuh names every library anew, so a library built
    from the old header is never loaded."""
    for name in ("gotoh.cu", "jitter.cuh"):
        (tmp_path / name).write_bytes(
            open(os.path.join(_build.CSRC, name), "rb").read())
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    before = [_build._library_path("gotoh", jitter=j) for j in (False, True)]
    with open(tmp_path / "jitter.cuh", "a") as f:
        f.write("\n")
    after = [_build._library_path("gotoh", jitter=j) for j in (False, True)]
    assert all(a != b for a, b in zip(before, after))


# hand-offs of each source that the jitter build delays
SITES = {"gotoh": 10, "popoa_dag": 5, "chain_cdq": 4, "chain_scan": 4,
         "sharded_gotoh": 3}


@pytest.mark.parametrize("name", list(SITES))
def test_sources_mark_their_hand_offs(name):
    """Each source includes jitter.cuh and numbers its JITTER sites 0,
    1, ...; the plain build's JITTER is ((void)0)."""
    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        text = f.read()
    assert '#include "jitter.cuh"' in text
    sites = [int(x) for x in re.findall(r"JITTER\((\d+)\);", text)]
    assert sorted(sites) == list(range(SITES[name]))
    with open(os.path.join(_build.CSRC, "jitter.cuh")) as f:
        header = f.read()
    plain = header.split("#else", 1)[1]
    assert "#define JITTER(site) ((void)0)" in plain
    assert "centrolign_jitter_set" not in plain

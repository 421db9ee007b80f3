"""Native (C++) host runtime: compiled on demand with g++, loaded via ctypes.

Holds the serial-sweep algorithms that are host-latency-bound rather than
device-shaped: the sparse chaining DP (chain.cpp). The shared object is
built at first use into centrolign_tpu_torch/_build/, named by the hash of
the sources, so an edited source builds anew. One process builds, under a
file lock, while the others wait for it; each source compiles in its own
g++ process, all started together.

Sanitizer tier (the reference's -DDEV=ON ASan+UBSan build, reference
CMakeLists.txt:19-25): with CENTROLIGN_TPU_NATIVE_SANITIZE=1, read when the
library is first loaded, every source builds with `_SAN_FLAGS` into a
library of its own, `libnative_san-<hash>.so`. It loads only into a process
that has the sanitizer runtimes preloaded (`PRELOAD`); without them loading
raises, and a failed sanitized build raises: neither falls back to the plain
library. tests/test_torch_sanitizer_tier.py drives it.

Copy of centrolign_tpu/native/__init__.py (its committed _native.so is not
carried over).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SOURCES = ["chain.cpp", "chain_general.cpp", "chain_affine_cdq.cpp", "esa.cpp", "popoa.cpp", "extract.cpp", "wfa.cpp", "chain_parity.cpp", "superbubbles.cpp", "three_ecc.cpp", "cactus_snarls.cpp", "fill_in.cpp", "chain_levels.cpp"]
_FLAGS = ["-O3", "-std=c++17", "-fPIC"]
SANITIZE_ENV = "CENTROLIGN_TPU_NATIVE_SANITIZE"
_SAN_FLAGS = ["-O1", "-g", "-fsanitize=address,undefined",
              "-fno-sanitize-recover=all", "-std=c++17", "-fPIC"]
_SAN_LINK = ["-fsanitize=address,undefined"]
PRELOAD = ("LD_PRELOAD=$(g++ -print-file-name=libasan.so):"
           "$(g++ -print-file-name=libubsan.so)")

_lib = None


def malloc_trim() -> None:
    """Release freed native-heap arenas to the OS (no-op off glibc). Called
    between subproblems: the chain DP's small-block churn otherwise retains
    tens of GB across the big late-tree joins."""
    try:
        get_lib().native_malloc_trim()
    except Exception:
        pass


def _source_hash() -> str:
    h = hashlib.sha256()
    for s in _SOURCES:
        with open(os.path.join(_DIR, s), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def sanitizing() -> bool:
    """Whether CENTROLIGN_TPU_NATIVE_SANITIZE=1 asks for the sanitizer
    tier."""
    return os.environ.get(SANITIZE_ENV, "0") == "1"


def _compile(so: str, openmp: bool, sanitize: bool) -> bool:
    """Compile every source into an object in parallel, then link `so`."""
    omp = ["-fopenmp"] if openmp else []
    flags, link = (_SAN_FLAGS, _SAN_LINK) if sanitize else (_FLAGS, [])
    objs = [f"{so}.{os.getpid()}.{s}.o" for s in _SOURCES]
    procs = [subprocess.Popen(["g++", *flags, *omp, "-c", "-o", o,
                               os.path.join(_DIR, s)],
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
             for s, o in zip(_SOURCES, objs)]
    ok = all(p.wait() == 0 for p in procs)
    tmp = f"{so}.{os.getpid()}.tmp"
    if ok:
        ok = subprocess.run(["g++", "-shared", *link, *omp, "-o", tmp,
                             *objs], capture_output=True).returncode == 0
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if ok:
        os.replace(tmp, so)
    return ok


def _build(so: str, sanitize: bool) -> None:
    if not _compile(so, openmp=True, sanitize=sanitize):
        # toolchains without libgomp
        if not _compile(so, openmp=False, sanitize=sanitize):
            raise RuntimeError(f"g++ failed to build {so} from {_DIR}")


def _built_library(sanitize: bool) -> str:
    """The path of the shared object for the current sources (the
    sanitized one with `sanitize`), built first (by this process or
    another one) if it does not exist yet."""
    name = "libnative_san" if sanitize else "libnative"
    so = os.path.join(_BUILD_DIR, f"{name}-{_source_hash()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            _build(so, sanitize)
    return so


def sanitizer_runtimes_loaded() -> bool:
    """Whether ASan's and UBSan's runtimes are in this process's global
    symbols, as LD_PRELOAD puts them. Loading a sanitized library without
    them ends the process in the runtime's own check, so test first."""
    return all(hasattr(ctypes.pythonapi, sym) for sym in (
        "__asan_init", "__ubsan_handle_add_overflow_abort"))


def sanitizer_preload() -> str:
    """The LD_PRELOAD value that `PRELOAD` spells: ASan's and UBSan's
    runtimes as g++ resolves them. Raises if the toolchain lacks either."""
    paths = []
    for name in ("libasan.so", "libubsan.so"):
        path = subprocess.run(["g++", f"-print-file-name={name}"],
                              capture_output=True, text=True,
                              check=True).stdout.strip()
        if not os.path.isabs(path) or not os.path.exists(path):
            raise RuntimeError(
                f"g++ has no {name}: the sanitizer tier cannot run")
        paths.append(path)
    return ":".join(paths)


def open_library(path: str, sanitize: bool) -> ctypes.CDLL:
    """ctypes.CDLL(path), for a sanitized library only after checking that
    the sanitizer runtimes are preloaded."""
    if sanitize and not sanitizer_runtimes_loaded():
        raise RuntimeError(
            f"{SANITIZE_ENV}=1: {os.path.basename(path)} is built with ASan "
            f"and UBSan and loads only into a process with their runtimes "
            f"preloaded; run it with {PRELOAD} and "
            f"ASAN_OPTIONS=detect_leaks=0 (on a card also "
            f"protect_shadow_gap=0)")
    return ctypes.CDLL(path)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    sanitize = sanitizing()
    lib = open_library(_built_library(sanitize), sanitize)
    lib.chain_dp_seq.restype = ctypes.c_int64
    lib.chain_dp_seq.argtypes = [
        ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.psd_build.restype = None
    lib.psd_build.argtypes = [ctypes.c_int64, ctypes.c_int64] + \
        [ctypes.c_void_p] * 6
    lib.chain_dp_general.restype = ctypes.c_int64
    lib.chain_dp_general.argtypes = [
        ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_double, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.esa_build.restype = None
    lib.esa_build.argtypes = [
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.esa_minimal_rare_matches.restype = ctypes.c_int64
    lib.esa_minimal_rare_matches.argtypes = [
        ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int8), ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    I64P = ctypes.c_void_p
    U8P = ctypes.c_void_p
    I32P = ctypes.c_void_p
    lib.topological_order_native.restype = None
    lib.topological_order_native.argtypes = [ctypes.c_int64, I64P, I64P, I64P, I64P]
    lib.minmax_distance_native.restype = None
    lib.minmax_distance_native.argtypes = [
        ctypes.c_int64, I64P, I64P, I64P, I64P,
        ctypes.c_int64, I64P, I64P, I64P]
    lib.popoa_align_native.restype = ctypes.c_int64
    lib.popoa_align_native.argtypes = [
        ctypes.c_int64, U8P, I64P, I64P, I64P, I64P,
        ctypes.c_int64, U8P, I64P, I64P, I64P, I64P,
        ctypes.c_int64, I64P, ctypes.c_int64, I64P,
        ctypes.c_int64, I64P, ctypes.c_int64, I64P,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, I32P, I32P,
        I64P, I64P]
    lib.esa_walk_matches.restype = None
    lib.esa_walk_matches.argtypes = [
        ctypes.c_int64, I64P, I64P, I64P,
        ctypes.POINTER(ctypes.c_int8), I64P, I64P]
    lib.extract_connecting_native.restype = None
    lib.extract_connecting_native.argtypes = [
        ctypes.c_int64, I64P, I64P, U8P,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, I64P, I64P, I64P, ctypes.c_int,
        I64P, I64P, ctypes.c_int64,
        U8P, I64P, I64P, I64P, I64P, I64P, I64P]
    lib.chain_sparse_parity.restype = ctypes.c_int64
    lib.chain_sparse_parity.argtypes = (
        [ctypes.c_int64] + [I64P] * 4 + [ctypes.c_int64] +
        [ctypes.c_int64, ctypes.c_int64] + [I64P] * 6 +
        [ctypes.c_void_p] + [I64P] * 4 +
        [ctypes.c_int64] + [I64P] * 5 +
        [ctypes.c_int64] + [I64P] * 5 +
        [ctypes.c_int64, I64P, ctypes.c_int64, I64P,
         ctypes.c_int64, I64P, ctypes.c_int64, I64P,
         ctypes.c_int64, I64P, ctypes.c_int,
         ctypes.c_int64, I64P, ctypes.c_void_p])
    DP = ctypes.c_void_p
    lib.bonder_dev_constrained_partition.restype = ctypes.c_int64
    lib.bonder_dev_constrained_partition.argtypes = [
        ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_void_p, I64P,
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        I64P]
    lib.superbubbles_build.restype = ctypes.c_int64
    lib.superbubbles_build.argtypes = (
        [ctypes.c_int64] + [I64P] * 4 + [ctypes.c_int64, ctypes.c_int64] +
        [I64P] * 8)
    lib.ref_topological_order.restype = None
    lib.ref_topological_order.argtypes = [ctypes.c_int64] + [I64P] * 5
    lib.snarl_tree_build.restype = ctypes.c_int64
    lib.snarl_tree_build.argtypes = (
        [ctypes.c_int64] + [I64P] * 4 +
        [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64] + [I64P] * 10)
    lib.three_edge_connected_components.restype = ctypes.c_int64
    lib.three_edge_connected_components.argtypes = \
        [ctypes.c_int64] + [I64P] * 5
    lib.chain_merge_build.restype = None
    lib.chain_merge_build.argtypes = (
        [ctypes.c_int64] + [I64P] * 4 +
        [ctypes.c_int64, I64P, I64P, ctypes.c_int64, ctypes.c_int64] +
        [I64P] * 3)
    lib.path_merge_build.restype = None
    lib.path_merge_build.argtypes = (
        [ctypes.c_int64] + [I64P] * 4 +
        [ctypes.c_int64, I64P, I64P, ctypes.c_int64, ctypes.c_int64] +
        [I64P] * 3 + [ctypes.c_int])
    lib.chain_affine_cdq.restype = ctypes.c_int64
    lib.chain_affine_cdq.argtypes = [
        ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.chain_affine_parity.restype = ctypes.c_int64
    lib.chain_affine_parity.argtypes = (
        [ctypes.c_int64] + [I64P] * 4 +
        [ctypes.c_int64] + [I64P] * 4 +
        [ctypes.c_int64, ctypes.c_int64] + [I64P] * 6 + [DP] + [I64P] * 4 +
        [ctypes.c_int64] + [I64P] * 5 +
        [ctypes.c_int64] + [I64P] * 5 +
        [DP, DP, ctypes.c_double,
         ctypes.c_int64, I64P, ctypes.c_int64, I64P,
         ctypes.c_int64, I64P, ctypes.c_int64, I64P,
         ctypes.c_int64, I64P, ctypes.c_int32, ctypes.c_int,
         ctypes.c_int64, I64P, DP])
    _wfa_common = [
        ctypes.c_int64, U8P, I64P, I64P, I64P, I64P,
        ctypes.c_int64, U8P, I64P, I64P, I64P, I64P,
        ctypes.c_int64, I64P, ctypes.c_int64, I64P,
        ctypes.c_int64, I64P, ctypes.c_int64, I64P,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, I64P, I64P]
    lib.wfa_po_poa_native.restype = ctypes.c_int64
    lib.wfa_po_poa_native.argtypes = _wfa_common + [
        ctypes.c_int32, ctypes.c_int64, I64P, I64P]
    lib.deletion_wfa_po_poa_native.restype = ctypes.c_int64
    lib.deletion_wfa_po_poa_native.argtypes = _wfa_common + [I64P, I64P]
    lib.anchor_fill_in_native.restype = ctypes.c_int64
    lib.anchor_fill_in_native.argtypes = (
        # graphs
        [ctypes.c_int64] + [I64P] * 4 + [ctypes.c_int64] + [I64P] * 4 +
        # paths
        [ctypes.c_int64, I64P, I64P, ctypes.c_int64, I64P, I64P] +
        # xmerge views + table width
        [ctypes.c_int64] + [I64P] * 3 + [ctypes.c_int64] + [I64P] * 3 +
        [ctypes.c_int] +
        # matches
        [ctypes.c_int64] + [I64P] * 10 +
        # top chain
        [ctypes.c_int64, I64P, DP] +
        # sentinels
        [ctypes.c_int64] * 4 +
        # config
        [ctypes.c_int, ctypes.c_double, DP, DP,
         ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_double,
         ctypes.c_int64, ctypes.c_int64, I64P, ctypes.c_int,
         ctypes.c_int64, I64P, DP])
    lib.chain_fill_length_native.restype = ctypes.c_int64
    lib.chain_fill_length_native.argtypes = (
        [ctypes.c_int64, I64P, I64P, ctypes.c_int64] + [I64P] * 3 +
        [ctypes.c_int64, I64P, I64P, ctypes.c_int64] + [I64P] * 3 +
        [ctypes.c_int, ctypes.c_int64, I64P])
    lib.cdq_row_levels.restype = None
    lib.cdq_row_levels.argtypes = [ctypes.c_int64] + [ctypes.c_void_p] * 3
    lib.chain_event_levels.restype = ctypes.c_int64
    lib.chain_event_levels.argtypes = [ctypes.c_int64, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_void_p]
    _lib = lib
    return lib


def _ptr_i64(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _ptr_f64(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def chain_dp_seq(s1, e1, s2, e2, w, init_w, fin_w, use_gap: bool,
                 go, ge, scale: float, min_score: float):
    """Run the native chaining DP. Returns (best_end_index or -1, backptr,
    dp_final)."""
    lib = get_lib()
    n = len(s1)
    s1 = np.ascontiguousarray(s1, dtype=np.int64)
    e1 = np.ascontiguousarray(e1, dtype=np.int64)
    s2 = np.ascontiguousarray(s2, dtype=np.int64)
    e2 = np.ascontiguousarray(e2, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    init_w = np.ascontiguousarray(init_w, dtype=np.float64)
    fin_w = np.ascontiguousarray(fin_w, dtype=np.float64)
    go = np.ascontiguousarray(go, dtype=np.float64)
    ge = np.ascontiguousarray(ge, dtype=np.float64)
    backptr = np.empty(n, dtype=np.int64)
    dp = np.empty(n, dtype=np.float64)
    best = lib.chain_dp_seq(
        n, _ptr_i64(s1), _ptr_i64(e1), _ptr_i64(s2), _ptr_i64(e2),
        _ptr_f64(w), _ptr_f64(init_w), _ptr_f64(fin_w),
        1 if use_gap else 0, len(go), _ptr_f64(go), _ptr_f64(ge),
        float(scale), float(min_score), _ptr_i64(backptr), _ptr_f64(dp))
    return int(best), backptr, dp


def psd_build(topo_order, prev_indptr, prev_indices, index_on, table):
    """Post-switch distances (C, V), 0 = none (reference semantics)."""
    lib = get_lib()
    C, V = index_on.shape
    topo_order = np.ascontiguousarray(topo_order, dtype=np.int64)
    prev_indptr = np.ascontiguousarray(prev_indptr, dtype=np.int64)
    prev_indices = np.ascontiguousarray(prev_indices, dtype=np.int64)
    index_on = np.ascontiguousarray(index_on, dtype=np.int64)
    table = np.ascontiguousarray(table, dtype=np.int64)
    out = np.zeros((C, V), dtype=np.int64)
    lib.psd_build(V, C, _ptr_i64(topo_order), _ptr_i64(prev_indptr),
                  _ptr_i64(prev_indices), _ptr_i64(index_on), _ptr_i64(table),
                  _ptr_i64(out))
    return out


def chain_dp_general(s1, e1, s2, e2, w, init_w, fin_w,
                     topo1, chain1, idx1, T1, D1, chain1_nodes, chain1_offsets,
                     chain2, idx2, T2, D2,
                     use_gap, go, ge, scale, min_score):
    lib = get_lib()
    n = len(s1)
    V1, C1 = T1.shape
    V2, C2 = T2.shape
    arrs = {}
    def i64(x, name):
        arrs[name] = np.ascontiguousarray(x, dtype=np.int64)
        return _ptr_i64(arrs[name])
    def f64(x, name):
        arrs[name] = np.ascontiguousarray(x, dtype=np.float64)
        return _ptr_f64(arrs[name])
    backptr = np.empty(n, dtype=np.int64)
    dp = np.empty(n, dtype=np.float64)
    if D1 is None:
        D1 = np.zeros((C1, V1), dtype=np.int64)
        D2 = np.zeros((C2, V2), dtype=np.int64)
    go = np.ascontiguousarray(go, dtype=np.float64)
    ge = np.ascontiguousarray(ge, dtype=np.float64)
    best = lib.chain_dp_general(
        n, i64(s1, "s1"), i64(e1, "e1"), i64(s2, "s2"), i64(e2, "e2"),
        f64(w, "w"), f64(init_w, "iw"), f64(fin_w, "fw"),
        V1, C1, i64(topo1, "t1o"), i64(chain1, "c1"), i64(idx1, "i1"),
        i64(T1, "T1"), i64(D1, "D1"),
        i64(chain1_nodes, "cn"), i64(chain1_offsets, "co"),
        V2, C2, i64(chain2, "c2"), i64(idx2, "i2"), i64(T2, "T2"), i64(D2, "D2"),
        1 if use_gap else 0, len(go), _ptr_f64(go), _ptr_f64(ge),
        float(scale), float(min_score), _ptr_i64(backptr), _ptr_f64(dp))
    return int(best), backptr, dp


def esa_build(text):
    """SA + ISA + LCP via native SA-IS/Kasai. text int64, terminal 0 unique
    minimum."""
    lib = get_lib()
    text = np.ascontiguousarray(text, dtype=np.int64)
    n = len(text)
    K = int(text.max()) + 1 if n else 1
    sa = np.empty(n, dtype=np.int64)
    isa = np.empty(n, dtype=np.int64)
    lcp = np.zeros(n, dtype=np.int64)
    lib.esa_build(n, _ptr_i64(text), K, _ptr_i64(sa), _ptr_i64(isa),
                  _ptr_i64(lcp))
    return sa, isa, lcp


def esa_minimal_rare_matches(sa, isa, lcp, start_comp, start_id, max_count):
    """Native minimal-rare-match enumeration (2 components). Returns an
    (M, 5) int64 array of (sa_begin, sa_end, length, cnt0, cnt1) rows in
    reference traversal order."""
    lib = get_lib()
    n = len(sa)
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    isa = np.ascontiguousarray(isa, dtype=np.int64)
    lcp = np.ascontiguousarray(lcp, dtype=np.int64)
    start_comp = np.ascontiguousarray(start_comp, dtype=np.int8)
    start_id = np.ascontiguousarray(start_id, dtype=np.int64)
    cap = max(1024, n // 4)
    while True:
        out = np.empty((cap, 5), dtype=np.int64)
        m = lib.esa_minimal_rare_matches(
            n, _ptr_i64(sa), _ptr_i64(isa), _ptr_i64(lcp),
            start_comp.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            _ptr_i64(start_id), int(max_count), cap, _ptr_i64(out))
        if m <= cap:
            return out[:m]
        cap = m


def _ptr_u8(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _pair_width(t1, io1, t2, io2):
    """Common table width for a two-graph native call. Tables are int32
    below 2^31 nodes (the reference's uint32 tier) and int64 beyond; a
    mixed pair is upcast to int64."""
    if t1.dtype == np.int32 and t2.dtype == np.int32:
        return 4, t1, io1, t2, io2
    return (8,
            np.ascontiguousarray(t1, dtype=np.int64),
            np.ascontiguousarray(io1, dtype=np.int64),
            np.ascontiguousarray(t2, dtype=np.int64),
            np.ascontiguousarray(io2, dtype=np.int64))


def _csr64(pair):
    ptr, ind = pair
    return (np.ascontiguousarray(ptr, dtype=np.int64),
            np.ascontiguousarray(ind, dtype=np.int64))


def topological_order(graph):
    """Native Kahn topological order."""
    lib = get_lib()
    V = graph.node_size
    nptr, nind = _csr64(graph.next_csr())
    pptr, pind = _csr64(graph.prev_csr())
    out = np.empty(V, dtype=np.int64)
    lib.topological_order_native(V, _ptr_i64(nptr), _ptr_i64(nind),
                                 _ptr_i64(pptr), _ptr_i64(out))
    return out


def minmax_distance(graph, sources):
    lib = get_lib()
    V = graph.node_size
    nptr, nind = _csr64(graph.next_csr())
    pptr, pind = _csr64(graph.prev_csr())
    sources = np.ascontiguousarray(sources, dtype=np.int64)
    mind = np.empty(V, dtype=np.int64)
    maxd = np.empty(V, dtype=np.int64)
    lib.minmax_distance_native(V, _ptr_i64(nptr), _ptr_i64(nind),
                               _ptr_i64(pptr), _ptr_i64(pind),
                               len(sources), _ptr_i64(sources),
                               _ptr_i64(mind), _ptr_i64(maxd))
    return mind, maxd


def popoa_align(graph1, graph2, sources1, sources2, sinks1, sinks2, params):
    """Native PO-POA (fill + traceback), identical to ops.popoa_ref.popoa."""
    lib = get_lib()
    V1, V2 = graph1.node_size, graph2.node_size
    lab1 = np.ascontiguousarray(graph1.labels, dtype=np.uint8)
    lab2 = np.ascontiguousarray(graph2.labels, dtype=np.uint8)
    n1ptr, n1ind = _csr64(graph1.next_csr())
    p1ptr, p1ind = _csr64(graph1.prev_csr())
    n2ptr, n2ind = _csr64(graph2.next_csr())
    p2ptr, p2ind = _csr64(graph2.prev_csr())
    s1 = np.ascontiguousarray(sources1, dtype=np.int64)
    s2 = np.ascontiguousarray(sources2, dtype=np.int64)
    k1 = np.ascontiguousarray(sinks1, dtype=np.int64)
    k2 = np.ascontiguousarray(sinks2, dtype=np.int64)
    go = np.ascontiguousarray(params.gap_open, dtype=np.int32)
    ge = np.ascontiguousarray(params.gap_extend, dtype=np.int32)
    out = np.empty((V1 + V2 + 2, 2), dtype=np.int64)
    score = np.zeros(1, dtype=np.int64)
    n = lib.popoa_align_native(
        V1, _ptr_u8(lab1), _ptr_i64(n1ptr), _ptr_i64(n1ind),
        _ptr_i64(p1ptr), _ptr_i64(p1ind),
        V2, _ptr_u8(lab2), _ptr_i64(n2ptr), _ptr_i64(n2ind),
        _ptr_i64(p2ptr), _ptr_i64(p2ind),
        len(s1), _ptr_i64(s1), len(s2), _ptr_i64(s2),
        len(k1), _ptr_i64(k1), len(k2), _ptr_i64(k2),
        int(params.match), int(params.mismatch), len(go),
        go.ctypes.data_as(ctypes.c_void_p),
        ge.ctypes.data_as(ctypes.c_void_p),
        _ptr_i64(out), _ptr_i64(score))
    return out[:n].copy(), int(score[0])


class ExtractionContext:
    """Reusable buffers + flattened graph/xmerge arrays for native
    extract_connecting_graph calls on one (graph, xmerge) pair."""

    def __init__(self, graph, xmerge):
        self.V = graph.node_size
        nptr, nind = graph.next_csr()
        self.nptr = np.ascontiguousarray(nptr, dtype=np.int64)
        self.nind = np.ascontiguousarray(nind, dtype=np.int64)
        self.labels = np.ascontiguousarray(graph.labels, dtype=np.uint8)
        self.table = np.ascontiguousarray(xmerge.table)
        self.path_head = np.ascontiguousarray(xmerge.path_head, dtype=np.int64)
        self.index_on = np.ascontiguousarray(xmerge.index_on)
        self.width = 4 if self.table.dtype == np.int32 else 8
        self.C = self.table.shape[1]
        V, E = self.V, len(self.nind)
        self.fwd = np.zeros(V, dtype=np.int64)
        self.epoch = np.full(V, -1, dtype=np.int64)
        self.cur = 0
        self.out_labels = np.empty(max(V, 1), dtype=np.uint8)
        self.out_back = np.empty(max(V, 1), dtype=np.int64)
        self.out_ef = np.empty(max(E, 1), dtype=np.int64)
        self.out_et = np.empty(max(E, 1), dtype=np.int64)
        self.out_src = np.empty(max(V, 1), dtype=np.int64)
        self.out_snk = np.empty(max(V, 1), dtype=np.int64)
        self.counts = np.empty(4, dtype=np.int64)
        # all buffers are fixed for the context's lifetime: marshal their
        # addresses exactly once (ctypes data_as costs ~3us per array and
        # extraction runs tens of thousands of times per subproblem)
        self._fn = get_lib().extract_connecting_native
        self._args_pre = (self.V, _ptr_i64(self.nptr), _ptr_i64(self.nind),
                          _ptr_u8(self.labels))
        self._args_mid = (self.C, _ptr_i64(self.table),
                          _ptr_i64(self.path_head), _ptr_i64(self.index_on),
                          self.width,
                          _ptr_i64(self.fwd), _ptr_i64(self.epoch))
        self._args_out = (_ptr_u8(self.out_labels), _ptr_i64(self.out_back),
                          _ptr_i64(self.out_ef), _ptr_i64(self.out_et),
                          _ptr_i64(self.out_src), _ptr_i64(self.out_snk),
                          _ptr_i64(self.counts))

    def extract(self, from_id: int, to_id: int):
        self.cur += 1
        self._fn(*self._args_pre, int(from_id), int(to_id),
                 *self._args_mid, self.cur, *self._args_out)
        nn, ne, ns, nk = (int(x) for x in self.counts)
        return (self.out_labels[:nn].copy(), self.out_back[:nn].copy(),
                self.out_ef[:ne].copy(), self.out_et[:ne].copy(),
                self.out_src[:ns].copy(), self.out_snk[:nk].copy())


def esa_walk_matches(rows, sa, ids, comp):
    """Walk all match rows into flat walks. Returns (walks flat int64,
    offsets per row). Row m occupies walks[offsets[m] : offsets[m] +
    (cnt0+cnt1)*L] as cnt0 comp-0 walks then cnt1 comp-1 walks."""
    lib = get_lib()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    sa = np.ascontiguousarray(sa, dtype=np.int64)
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    comp = np.ascontiguousarray(comp, dtype=np.int8)
    sizes = (rows[:, 3] + rows[:, 4]) * rows[:, 2]
    offsets = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    walks = np.empty(int(offsets[-1]), dtype=np.int64)
    lib.esa_walk_matches(
        len(rows), _ptr_i64(rows), _ptr_i64(sa), _ptr_i64(ids),
        comp.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        _ptr_i64(offsets), _ptr_i64(walks))
    return walks, offsets


def _graph_args(graph):
    nptr, nind = _csr64(graph.next_csr())
    pptr, pind = _csr64(graph.prev_csr())
    lab = np.ascontiguousarray(graph.labels, dtype=np.uint8)
    return (graph.node_size, _ptr_u8(lab), _ptr_i64(nptr), _ptr_i64(nind),
            _ptr_i64(pptr), _ptr_i64(pind)), (lab, nptr, nind, pptr, pind)


def wfa_po_poa(graph1, graph2, sources1, sources2, sinks1, sinks2, params,
               prune_limit=None):
    """Reference-equal wfa_po_poa (prune_limit None) / pwfa_po_poa
    (prune_limit set). Returns (alignment, score)."""
    lib = get_lib()
    a1, keep1 = _graph_args(graph1)
    a2, keep2 = _graph_args(graph2)
    s1 = np.ascontiguousarray(sources1, dtype=np.int64)
    s2 = np.ascontiguousarray(sources2, dtype=np.int64)
    k1 = np.ascontiguousarray(sinks1, dtype=np.int64)
    k2 = np.ascontiguousarray(sinks2, dtype=np.int64)
    go = np.ascontiguousarray(params.gap_open, dtype=np.int64)
    ge = np.ascontiguousarray(params.gap_extend, dtype=np.int64)
    cap = 2 * (graph1.node_size + graph2.node_size + 4)
    out = np.empty((cap, 2), dtype=np.int64)
    score = np.zeros(1, dtype=np.int64)
    n = lib.wfa_po_poa_native(
        *a1, *a2,
        len(s1), _ptr_i64(s1), len(s2), _ptr_i64(s2),
        len(k1), _ptr_i64(k1), len(k2), _ptr_i64(k2),
        int(params.match), int(params.mismatch), len(go),
        _ptr_i64(go), _ptr_i64(ge),
        0 if prune_limit is None else 1,
        0 if prune_limit is None else int(prune_limit),
        _ptr_i64(out), _ptr_i64(score))
    return out[:n].copy(), int(score[0])


def deletion_wfa_po_poa(short_graph, long_graph, sources_short, sources_long,
                        sinks_short, sinks_long, params):
    """Reference-equal deletion_wfa_po_poa. Returns (alignment, score)."""
    lib = get_lib()
    a1, keep1 = _graph_args(short_graph)
    a2, keep2 = _graph_args(long_graph)
    s1 = np.ascontiguousarray(sources_short, dtype=np.int64)
    s2 = np.ascontiguousarray(sources_long, dtype=np.int64)
    k1 = np.ascontiguousarray(sinks_short, dtype=np.int64)
    k2 = np.ascontiguousarray(sinks_long, dtype=np.int64)
    go = np.ascontiguousarray(params.gap_open, dtype=np.int64)
    ge = np.ascontiguousarray(params.gap_extend, dtype=np.int64)
    cap = 2 * (short_graph.node_size + 2 * long_graph.node_size + 8)
    out = np.empty((cap, 2), dtype=np.int64)
    score = np.zeros(1, dtype=np.int64)
    n = lib.deletion_wfa_po_poa_native(
        *a1, *a2,
        len(s1), _ptr_i64(s1), len(s2), _ptr_i64(s2),
        len(k1), _ptr_i64(k1), len(k2), _ptr_i64(k2),
        int(params.match), int(params.mismatch), len(go),
        _ptr_i64(go), _ptr_i64(ge),
        _ptr_i64(out), _ptr_i64(score))
    return out[:n].copy(), int(score[0])


def _flatten_match_sets(matches, num_sets, weights):
    n = len(matches)
    set_n1 = np.array([len(m.walks1) for m in matches], dtype=np.int64)
    set_n2 = np.array([len(m.walks2) for m in matches], dtype=np.int64)
    set_L = np.array([m.walks1.shape[1] if len(m.walks1) else
                      (m.walks2.shape[1] if len(m.walks2) else 0)
                      for m in matches], dtype=np.int64)
    set_c1 = np.array([m.count1 for m in matches], dtype=np.int64)
    set_c2 = np.array([m.count2 for m in matches], dtype=np.int64)
    set_fl = np.array([m.full_length for m in matches], dtype=np.int64)
    w1_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(set_n1 * set_L, out=w1_off[1:])
    w2_off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(set_n2 * set_L, out=w2_off[1:])
    w1 = (np.concatenate([np.asarray(m.walks1, dtype=np.int64).ravel()
                          for m in matches]) if n else np.empty(0, np.int64))
    w2 = (np.concatenate([np.asarray(m.walks2, dtype=np.int64).ravel()
                          for m in matches]) if n else np.empty(0, np.int64))
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    return (set_n1, set_n2, set_L, set_c1, set_c2, set_fl, weights,
            w1_off[:-1].copy(), np.ascontiguousarray(w1),
            w2_off[:-1].copy(), np.ascontiguousarray(w2))


def chain_sparse_parity(graph1, matches, num_sets, weights, xm1, xm2,
                        sources1, sources2, sinks1, sinks2, masked=None):
    """Reference-exact free-gap sparse chaining. Returns (M,3) int64 rows of
    (set, idx1, idx2) plus (M,) float64 scores."""
    from ..path_merge import xmerge_view_arrays
    lib = get_lib()
    n1ptr, n1ind = _csr64(graph1.next_csr())
    p1ptr, p1ind = _csr64(graph1.prev_csr())
    (set_n1, set_n2, set_L, set_c1, set_c2, set_fl, w,
     w1_off, w1, w2_off, w2) = _flatten_match_sets(matches, num_sets, weights)
    t1, io1, ci1, co1, cn1 = xmerge_view_arrays(xm1)
    t2, io2, ci2, co2, cn2 = xmerge_view_arrays(xm2)

    def ids(x):
        return (np.ascontiguousarray(x, dtype=np.int64) if x is not None
                else np.empty(0, dtype=np.int64))
    s1, s2, k1, k2 = ids(sources1), ids(sources2), ids(sinks1), ids(sinks2)
    ns1 = len(s1) if sources1 is not None else -1
    ns2 = len(s2) if sources2 is not None else -1
    nk1 = len(k1) if sinks1 is not None else -1
    nk2 = len(k2) if sinks2 is not None else -1
    if masked:
        mrows = np.array(sorted(masked), dtype=np.int64).reshape(-1, 3)
    else:
        mrows = np.empty((0, 3), dtype=np.int64)
    cap = int(sum(set_n1[:num_sets] * set_n2[:num_sets])) + 1
    out_rows = np.empty((cap, 5), dtype=np.int64)
    out_f = np.empty((cap, 3), dtype=np.float64)
    V2 = len(ci2)
    width, t1, io1, t2, io2 = _pair_width(t1, io1, t2, io2)
    nout = lib.chain_sparse_parity(
        graph1.node_size, _ptr_i64(n1ptr), _ptr_i64(n1ind),
        _ptr_i64(p1ptr), _ptr_i64(p1ind), V2,
        len(matches), num_sets, _ptr_i64(set_n1), _ptr_i64(set_n2),
        _ptr_i64(set_L), _ptr_i64(set_c1), _ptr_i64(set_c2), _ptr_i64(set_fl),
        _ptr_f64(w), _ptr_i64(w1_off), _ptr_i64(w1), _ptr_i64(w2_off),
        _ptr_i64(w2),
        t1.shape[1], _ptr_i64(t1), _ptr_i64(io1), _ptr_i64(ci1),
        _ptr_i64(co1), _ptr_i64(cn1),
        t2.shape[1], _ptr_i64(t2), _ptr_i64(io2), _ptr_i64(ci2),
        _ptr_i64(co2), _ptr_i64(cn2),
        ns1, _ptr_i64(s1), ns2, _ptr_i64(s2),
        nk1, _ptr_i64(k1), nk2, _ptr_i64(k2),
        len(mrows), _ptr_i64(np.ascontiguousarray(mrows)), width,
        cap, _ptr_i64(out_rows), _ptr_f64(out_f))
    return out_rows[:nout, :3].copy(), out_f[:nout, 0].copy()


def chain_affine_parity(graph1, graph2, matches, num_sets, weights, xm1, xm2,
                        gap_open, gap_extend, local_scale,
                        sources1, sources2, sinks1, sinks2,
                        num_anchors, max_match_size, masked=None):
    """Reference-exact SparseAffine chaining. Returns ((M,5) int64 rows of
    (set, idx1, idx2, gap_before, gap_after), (M,3) float64 of
    (score, gap_score_before, gap_score_after))."""
    from ..path_merge import xmerge_view_arrays
    lib = get_lib()
    n1ptr, n1ind = _csr64(graph1.next_csr())
    p1ptr, p1ind = _csr64(graph1.prev_csr())
    n2ptr, n2ind = _csr64(graph2.next_csr())
    p2ptr, p2ind = _csr64(graph2.prev_csr())
    (set_n1, set_n2, set_L, set_c1, set_c2, set_fl, w,
     w1_off, w1, w2_off, w2) = _flatten_match_sets(matches, num_sets, weights)
    t1, io1, ci1, co1, cn1 = xmerge_view_arrays(xm1)
    t2, io2, ci2, co2, cn2 = xmerge_view_arrays(xm2)

    def ids(x):
        return (np.ascontiguousarray(x, dtype=np.int64) if x is not None
                else np.empty(0, dtype=np.int64))
    s1, s2, k1, k2 = ids(sources1), ids(sources2), ids(sinks1), ids(sinks2)
    ns1 = len(s1) if sources1 is not None else -1
    ns2 = len(s2) if sources2 is not None else -1
    nk1 = len(k1) if sinks1 is not None else -1
    nk2 = len(k2) if sinks2 is not None else -1
    if masked:
        mrows = np.array(sorted(masked), dtype=np.int64).reshape(-1, 3)
    else:
        mrows = np.empty((0, 3), dtype=np.int64)
    go = np.ascontiguousarray(gap_open, dtype=np.float64)
    ge = np.ascontiguousarray(gap_extend, dtype=np.float64)
    # reference width dispatch (anchorer.hpp:1271-1280)
    max_diag_diff = graph1.node_size + graph2.node_size
    use_small = (num_sets < 2**32 - 1 and max_match_size < 2**16 - 1
                 and max_diag_diff < 2**31 - 1 and num_anchors < 2**32 - 1)
    cap = int(sum(set_n1[:num_sets] * set_n2[:num_sets])) + 1
    out_rows = np.empty((cap, 5), dtype=np.int64)
    out_f = np.empty((cap, 3), dtype=np.float64)
    width, t1, io1, t2, io2 = _pair_width(t1, io1, t2, io2)
    nout = lib.chain_affine_parity(
        graph1.node_size, _ptr_i64(n1ptr), _ptr_i64(n1ind),
        _ptr_i64(p1ptr), _ptr_i64(p1ind),
        graph2.node_size, _ptr_i64(n2ptr), _ptr_i64(n2ind),
        _ptr_i64(p2ptr), _ptr_i64(p2ind),
        len(matches), num_sets, _ptr_i64(set_n1), _ptr_i64(set_n2),
        _ptr_i64(set_L), _ptr_i64(set_c1), _ptr_i64(set_c2), _ptr_i64(set_fl),
        _ptr_f64(w), _ptr_i64(w1_off), _ptr_i64(w1), _ptr_i64(w2_off),
        _ptr_i64(w2),
        t1.shape[1], _ptr_i64(t1), _ptr_i64(io1), _ptr_i64(ci1),
        _ptr_i64(co1), _ptr_i64(cn1),
        t2.shape[1], _ptr_i64(t2), _ptr_i64(io2), _ptr_i64(ci2),
        _ptr_i64(co2), _ptr_i64(cn2),
        _ptr_f64(go), _ptr_f64(ge), float(local_scale),
        ns1, _ptr_i64(s1), ns2, _ptr_i64(s2),
        nk1, _ptr_i64(k1), nk2, _ptr_i64(k2),
        len(mrows), _ptr_i64(np.ascontiguousarray(mrows)),
        1 if use_small else 0, width,
        cap, _ptr_i64(out_rows), _ptr_f64(out_f))
    return out_rows[:nout].copy(), out_f[:nout].copy()


def chain_affine_cdq(s1, e1, s2, e2, w32, init32, gap_open, gap_extend,
                     local_scale):
    """SparseAffine chain-DP values on chain x chain inputs via the offline
    CDQ engine (native/chain_affine_cdq.cpp). Inputs are per-anchor chain
    indices (int64) and f32 weights / initial DP values. Returns per-anchor
    (dp f32, bp int64, tie u8, struct u8, stored f32, qshift int64)."""
    lib = get_lib()
    n = len(s1)
    s1 = np.ascontiguousarray(s1, dtype=np.int64)
    e1 = np.ascontiguousarray(e1, dtype=np.int64)
    s2 = np.ascontiguousarray(s2, dtype=np.int64)
    e2 = np.ascontiguousarray(e2, dtype=np.int64)
    w32 = np.ascontiguousarray(w32, dtype=np.float32)
    init32 = np.ascontiguousarray(init32, dtype=np.float32)
    go = np.ascontiguousarray(gap_open, dtype=np.float64)
    ge = np.ascontiguousarray(gap_extend, dtype=np.float64)
    out_dp = np.empty(n, dtype=np.float32)
    out_bp = np.empty(n, dtype=np.int64)
    out_tie = np.empty(n, dtype=np.uint8)
    out_struct = np.empty(n, dtype=np.uint8)
    out_stored = np.empty(n, dtype=np.float32)
    out_qs = np.empty(n, dtype=np.int64)
    rc = lib.chain_affine_cdq(
        n, _ptr_i64(s1), _ptr_i64(e1), _ptr_i64(s2), _ptr_i64(e2),
        w32.ctypes.data_as(ctypes.c_void_p),
        init32.ctypes.data_as(ctypes.c_void_p),
        _ptr_f64(go), _ptr_f64(ge), float(local_scale),
        out_dp.ctypes.data_as(ctypes.c_void_p),
        _ptr_i64(out_bp),
        out_tie.ctypes.data_as(ctypes.c_void_p),
        out_struct.ctypes.data_as(ctypes.c_void_p),
        out_stored.ctypes.data_as(ctypes.c_void_p),
        _ptr_i64(out_qs))
    assert rc == 0
    return out_dp, out_bp, out_tie, out_struct, out_stored, out_qs


def cdq_row_levels(ps1, pe1):
    """The dependency level of each row of a CDQ scan problem in sorted
    order (ps1 non-decreasing): 1 + the level of the latest earlier row
    with pe1 < its ps1, 1 when there is none (native/chain_levels.cpp)."""
    ps1 = np.ascontiguousarray(ps1, dtype=np.int64)
    pe1 = np.ascontiguousarray(pe1, dtype=np.int64)
    level = np.empty(len(ps1), dtype=np.int64)
    get_lib().cdq_row_levels(len(ps1), _ptr_i64(ps1), _ptr_i64(pe1),
                             _ptr_i64(level))
    return level


def chain_event_levels(ev, n):
    """The level of each event (E,) int32 of an event scan's stream `ev`
    (E, 4) int32 over n slots: a query with qhi > 0 is one level above
    every insert before it, every other event has level 0
    (native/chain_levels.cpp). Raises ValueError on a stream the
    level-synchronous kernel does not take (a slot inserted or queried
    twice, a slot out of range, another kind)."""
    ev = np.ascontiguousarray(ev, dtype=np.int32)
    level = np.empty(len(ev), dtype=np.int32)
    depth = get_lib().chain_event_levels(
        len(ev), ev.ctypes.data_as(ctypes.c_void_p), int(n),
        level.ctypes.data_as(ctypes.c_void_p))
    if depth < 0:
        raise ValueError("the event stream inserts or queries a slot twice, "
                         "or holds a slot or kind out of range")
    return level


def _paths_args(graph):
    paths = [graph.path(p) for p in range(graph.path_size)]
    off = np.zeros(len(paths) + 1, dtype=np.int64)
    np.cumsum([len(x) for x in paths], out=off[1:])
    nodes = (np.concatenate(paths).astype(np.int64) if paths
             else np.empty(0, dtype=np.int64))
    return graph.path_size, off, np.ascontiguousarray(nodes)


def anchor_fill_in(graph1, graph2, tableau1, tableau2, xm1, xm2, matches,
                   anchors, algorithm, scale, gap_open, gap_extend,
                   score_function, max_num_match_pairs, masked=None,
                   n_threads=0):
    """Whole fill-in anchoring pass in one native call (extraction,
    projection, divvying, per-gap budgets + PathMerge + parity chaining,
    merge). Returns (rows (N, 5) of (orig_set, idx1, idx2, gap_before,
    gap_after), fvals (N, 3) of (score, gap_score_before, gap_score_after))
    for the merged chain."""
    from ..path_merge import xmerge_view_arrays
    lib = get_lib()
    n1ptr, n1ind = _csr64(graph1.next_csr())
    p1ptr, p1ind = _csr64(graph1.prev_csr())
    n2ptr, n2ind = _csr64(graph2.next_csr())
    p2ptr, p2ind = _csr64(graph2.prev_csr())
    P1, poff1, pnodes1 = _paths_args(graph1)
    P2, poff2, pnodes2 = _paths_args(graph2)
    t1, io1, ci1, _co1, _cn1 = xmerge_view_arrays(xm1)
    t2, io2, ci2, _co2, _cn2 = xmerge_view_arrays(xm2)
    width, t1, io1, t2, io2 = _pair_width(t1, io1, t2, io2)
    zero_w = np.zeros(len(matches))
    (set_n1, set_n2, set_L, set_c1, set_c2, set_fl, _w,
     w1_off, w1, w2_off, w2) = _flatten_match_sets(matches, len(matches),
                                                   zero_w)
    A = len(anchors)
    top_rows = np.empty((A, 5), dtype=np.int64)
    top_fvals = np.empty((A, 3), dtype=np.float64)
    for k, a in enumerate(anchors):
        top_rows[k] = (a.match_set, a.idx1, a.idx2, a.gap_before, a.gap_after)
        top_fvals[k] = (a.score, a.gap_score_before, a.gap_score_after)
    if masked:
        mrows = np.array(sorted(masked), dtype=np.int64).reshape(-1, 3)
    else:
        mrows = np.empty((0, 3), dtype=np.int64)
    go = np.ascontiguousarray(gap_open, dtype=np.float64)
    ge = np.ascontiguousarray(gap_extend, dtype=np.float64)
    sf = score_function
    cap = 4 * A + 1024
    while True:
        out_rows = np.empty((cap, 5), dtype=np.int64)
        out_f = np.empty((cap, 3), dtype=np.float64)
        n = lib.anchor_fill_in_native(
            graph1.node_size, _ptr_i64(n1ptr), _ptr_i64(n1ind),
            _ptr_i64(p1ptr), _ptr_i64(p1ind),
            graph2.node_size, _ptr_i64(n2ptr), _ptr_i64(n2ind),
            _ptr_i64(p2ptr), _ptr_i64(p2ind),
            P1, _ptr_i64(poff1), _ptr_i64(pnodes1),
            P2, _ptr_i64(poff2), _ptr_i64(pnodes2),
            t1.shape[1], _ptr_i64(t1), _ptr_i64(io1), _ptr_i64(ci1),
            t2.shape[1], _ptr_i64(t2), _ptr_i64(io2), _ptr_i64(ci2),
            width,
            len(matches), _ptr_i64(set_n1), _ptr_i64(set_n2), _ptr_i64(set_L),
            _ptr_i64(set_c1), _ptr_i64(set_c2), _ptr_i64(set_fl),
            _ptr_i64(w1_off), _ptr_i64(w1), _ptr_i64(w2_off), _ptr_i64(w2),
            A, _ptr_i64(top_rows), _ptr_f64(top_fvals),
            tableau1.src_id, tableau1.snk_id, tableau2.src_id,
            tableau2.snk_id,
            int(algorithm), float(scale), _ptr_f64(go), _ptr_f64(ge),
            int(sf.anchor_score_function), float(sf.pair_count_power),
            float(sf.length_intercept), float(sf.length_decay_power),
            int(max_num_match_pairs),
            len(mrows), _ptr_i64(np.ascontiguousarray(mrows)),
            int(n_threads),
            cap, _ptr_i64(out_rows), _ptr_f64(out_f))
        if n <= cap:
            return out_rows[:n].copy(), out_f[:n].copy()
        cap = n


def chain_fill_length(graph1, graph2, xm1, xm2, endpoints):
    """Total min fill-in length over the (G, 4) gap endpoints
    (from1, to1, from2, to2) — the native half of estimate_score_scale."""
    from ..path_merge import xmerge_view_arrays
    lib = get_lib()
    n1ptr, n1ind = _csr64(graph1.next_csr())
    n2ptr, n2ind = _csr64(graph2.next_csr())
    t1, io1, ci1, _co1, _cn1 = xmerge_view_arrays(xm1)
    t2, io2, ci2, _co2, _cn2 = xmerge_view_arrays(xm2)
    width, t1, io1, t2, io2 = _pair_width(t1, io1, t2, io2)
    endpoints = np.ascontiguousarray(endpoints, dtype=np.int64)
    return int(lib.chain_fill_length_native(
        graph1.node_size, _ptr_i64(n1ptr), _ptr_i64(n1ind),
        t1.shape[1], _ptr_i64(t1), _ptr_i64(io1), _ptr_i64(ci1),
        graph2.node_size, _ptr_i64(n2ptr), _ptr_i64(n2ind),
        t2.shape[1], _ptr_i64(t2), _ptr_i64(io2), _ptr_i64(ci2),
        width, len(endpoints), _ptr_i64(endpoints)))


def path_merge_build(graph, tableau=None):
    """Native PathMerge construction. Returns (index_on (C,V), path_head (V,),
    table (V,C))."""
    lib = get_lib()
    V = graph.node_size
    P = graph.path_size
    C = P + (1 if tableau is not None else 0)
    nptr, nind = _csr64(graph.next_csr())
    pptr, pind = _csr64(graph.prev_csr())
    paths = [graph.path(p) for p in range(P)]
    off = np.zeros(P + 1, dtype=np.int64)
    np.cumsum([len(x) for x in paths], out=off[1:])
    nodes = (np.concatenate(paths).astype(np.int64) if paths
             else np.empty(0, dtype=np.int64))
    # width dispatch (reference core.hpp:296-357 uint32 tier): int32
    # tables below 2^31 nodes halve the dominant (V x C) memory
    tdt = np.int32 if V < 2**31 - 1 else np.int64
    index_on = np.full((C, V), -1, dtype=tdt)
    path_head = np.full(V, -1, dtype=np.int64)
    table = np.full((V, C), -1, dtype=tdt)
    lib.path_merge_build(
        V, _ptr_i64(nptr), _ptr_i64(nind), _ptr_i64(pptr), _ptr_i64(pind),
        P, _ptr_i64(off), _ptr_i64(nodes),
        tableau.src_id if tableau is not None else -1,
        tableau.snk_id if tableau is not None else -1,
        _ptr_i64(index_on), _ptr_i64(path_head), _ptr_i64(table),
        4 if tdt is np.int32 else 8)
    return index_on, path_head, table


def reference_topological_order(graph):
    """The reference's LIFO-stack Kahn topological order."""
    lib = get_lib()
    V = graph.node_size
    nptr, nind = _csr64(graph.next_csr())
    pptr, pind = _csr64(graph.prev_csr())
    out = np.empty(V, dtype=np.int64)
    lib.ref_topological_order(V, _ptr_i64(nptr), _ptr_i64(nind),
                              _ptr_i64(pptr), _ptr_i64(pind), _ptr_i64(out))
    return out


class SuperbubbleTree:
    """Superbubble decomposition + chain tree + min/max walk distances
    (reference superbubbles.hpp, structure_tree.hpp, structure_distances.hpp).
    """

    def __init__(self, graph, tableau=None):
        lib = get_lib()
        V = graph.node_size
        nptr, nind = _csr64(graph.next_csr())
        pptr, pind = _csr64(graph.prev_csr())
        self.node_begin = np.empty(V, dtype=np.int64)
        self.node_end = np.empty(V, dtype=np.int64)
        bounds = np.empty((max(V, 1), 2), dtype=np.int64)
        sdist = np.empty((max(V, 1), 2), dtype=np.int64)
        chain_of = np.empty(max(V, 1), dtype=np.int64)
        chain_parent = np.empty(max(V, 1), dtype=np.int64)
        chain_dist = np.empty((max(V, 1), 2), dtype=np.int64)
        nch = np.zeros(1, dtype=np.int64)
        S = lib.superbubbles_build(
            V, _ptr_i64(nptr), _ptr_i64(nind), _ptr_i64(pptr), _ptr_i64(pind),
            tableau.src_id if tableau is not None else -1,
            tableau.snk_id if tableau is not None else -1,
            _ptr_i64(self.node_begin), _ptr_i64(self.node_end),
            _ptr_i64(bounds), _ptr_i64(sdist), _ptr_i64(chain_of),
            _ptr_i64(chain_parent), _ptr_i64(chain_dist), _ptr_i64(nch))
        if S < 0:
            raise ValueError(
                "can only find superbubbles in single-source, single-sink "
                "graphs")
        self.structure_size = int(S)
        self.chain_count = int(nch[0])
        self.bounds = bounds[:S].copy()
        self.structure_dists = sdist[:S].copy()
        self.chain_of = chain_of[:S].copy()
        self.chain_parent = chain_parent[:self.chain_count].copy()
        self.chain_dists = chain_dist[:self.chain_count].copy()
        self._chain_structs = None  # built lazily (only the simplifier
        # walks chains; match splitting on big graphs never does)

    @property
    def chain_structs(self):
        if self._chain_structs is None:
            # structures inside each chain, left-to-right boundary order
            self._chain_structs = [[] for _ in range(self.chain_count)]
            order = {}
            for s in range(self.structure_size):
                order.setdefault(int(self.chain_of[s]), []).append(s)
            for c, ss in order.items():
                if len(ss) == 1:
                    self._chain_structs[c] = ss
                    continue
                nxt = {int(self.bounds[s, 0]): s for s in ss}
                ends = {int(self.bounds[s, 1]) for s in ss}
                start = [s for s in ss
                         if int(self.bounds[s, 0]) not in ends][0]
                seq = [start]
                while int(self.bounds[seq[-1], 1]) in nxt:
                    seq.append(nxt[int(self.bounds[seq[-1], 1])])
                self._chain_structs[c] = seq
        return self._chain_structs

    def structures_inside(self, chain_id: int):
        return self.chain_structs[chain_id]

    def chain_containing(self, struct_id: int) -> int:
        return int(self.chain_of[struct_id])

    def structure_beginning_at(self, node_id: int) -> int:
        return int(self.node_begin[node_id])

    def structure_ending_at(self, node_id: int) -> int:
        return int(self.node_end[node_id])

    def structure_boundaries(self, struct_id: int):
        return int(self.bounds[struct_id, 0]), int(self.bounds[struct_id, 1])

    def structure_min_max_dist(self, struct_id: int):
        return (int(self.structure_dists[struct_id, 0]),
                int(self.structure_dists[struct_id, 1]))

    def chain_min_max_dist(self, chain_id: int):
        return (int(self.chain_dists[chain_id, 0]),
                int(self.chain_dists[chain_id, 1]))


def bonder_partition(shared, intervening, deviation, separation,
                     min_opt_proportion, min_length, deviation_drift,
                     separation_drift):
    """Native longest_deviation_constrained_partition. Returns list of
    (begin, end) interval pairs."""
    lib = get_lib()
    n = len(shared)
    shared = np.ascontiguousarray(shared, dtype=np.float64)
    intervening = np.ascontiguousarray(intervening, dtype=np.float64)
    deviation = np.ascontiguousarray(deviation, dtype=np.int64)
    separation = np.ascontiguousarray(separation, dtype=np.float64)
    out = np.empty((n + 1, 2), dtype=np.int64)
    m = lib.bonder_dev_constrained_partition(
        n, _ptr_f64(shared), _ptr_f64(intervening), _ptr_i64(deviation),
        _ptr_f64(separation), 1,
        float(min_opt_proportion), float(min_length),
        float(deviation_drift), float(separation_drift), _ptr_i64(out))
    return [(int(a), int(b)) for a, b in out[:m]]


def chain_merge_build(graph, tableau=None):
    """Native ChainMerge construction. Returns (chain_id (V,),
    chain_index (V,), table (V,C))."""
    lib = get_lib()
    V = graph.node_size
    P = graph.path_size
    C = P + (1 if tableau is not None else 0)
    nptr, nind = _csr64(graph.next_csr())
    pptr, pind = _csr64(graph.prev_csr())
    paths = [graph.path(p) for p in range(P)]
    off = np.zeros(P + 1, dtype=np.int64)
    np.cumsum([len(x) for x in paths], out=off[1:])
    nodes = (np.concatenate(paths).astype(np.int64) if paths
             else np.empty(0, dtype=np.int64))
    chain_id = np.empty(V, dtype=np.int64)
    chain_index = np.empty(V, dtype=np.int64)
    table = np.full((V, C), -1, dtype=np.int64)
    lib.chain_merge_build(
        V, _ptr_i64(nptr), _ptr_i64(nind), _ptr_i64(pptr), _ptr_i64(pind),
        P, _ptr_i64(off), _ptr_i64(nodes),
        tableau.src_id if tableau is not None else -1,
        tableau.snk_id if tableau is not None else -1,
        _ptr_i64(chain_id), _ptr_i64(chain_index), _ptr_i64(table))
    return chain_id, chain_index, table


def three_edge_connected_components(graph):
    """Component id per node (reference Norouzi & Tsin replica); the graph
    must be connected for meaningful results, 2-edge-connected for validity
    of the 3ECC partition (bridges are censored like the reference)."""
    lib = get_lib()
    V = graph.node_size
    nptr, nind = _csr64(graph.next_csr())
    pptr, pind = _csr64(graph.prev_csr())
    out = np.empty(V, dtype=np.int64)
    n = lib.three_edge_connected_components(
        V, _ptr_i64(nptr), _ptr_i64(nind), _ptr_i64(pptr), _ptr_i64(pind),
        _ptr_i64(out))
    return out, int(n)


class SnarlTree:
    """Snarl decomposition of a (possibly cyclic) sentinel-flanked graph via
    the cactus tree (reference snarls.hpp / cactus.hpp replicas)."""

    def __init__(self, graph, tableau):
        lib = get_lib()
        V = graph.node_size
        nptr, nind = _csr64(graph.next_csr())
        pptr, pind = _csr64(graph.prev_csr())
        cap = max(2 * V + 16, 64)
        self.node_begin = np.empty(V, dtype=np.int64)
        self.node_end = np.empty(V, dtype=np.int64)
        bounds = np.empty((cap, 2), dtype=np.int64)
        chain_of = np.empty(cap, dtype=np.int64)
        chain_parent = np.empty(cap, dtype=np.int64)
        sa = np.empty(cap, dtype=np.int64)
        na = np.empty(cap, dtype=np.int64)
        ca = np.empty(cap, dtype=np.int64)
        tc = np.empty(cap, dtype=np.int64)
        nch = np.zeros(1, dtype=np.int64)
        S = lib.snarl_tree_build(
            V, _ptr_i64(nptr), _ptr_i64(nind), _ptr_i64(pptr), _ptr_i64(pind),
            tableau.src_id, tableau.snk_id, cap,
            _ptr_i64(self.node_begin), _ptr_i64(self.node_end),
            _ptr_i64(bounds), _ptr_i64(chain_of), _ptr_i64(chain_parent),
            _ptr_i64(sa), _ptr_i64(na), _ptr_i64(ca), _ptr_i64(tc),
            _ptr_i64(nch))
        if S < 0:
            raise RuntimeError("snarl capacity exceeded")
        self.structure_size = int(S)
        self.chain_count = int(nch[0])
        self.bounds = bounds[:S].copy()
        self.chain_of = chain_of[:S].copy()
        self.chain_parent = chain_parent[:self.chain_count].copy()
        self.snarl_acyclic = sa[:S].astype(bool)
        self.net_acyclic = na[:S].astype(bool)
        self.chain_acyclic = ca[:self.chain_count].astype(bool)
        self.trivial_chain = tc[:self.chain_count].astype(bool)
        # structures inside each chain in order
        self.chain_structs = [[] for _ in range(self.chain_count)]
        # chains are formed left-to-right; reconstruct by walking
        order = {}
        for s in range(S):
            order.setdefault(int(chain_of[s]), []).append(s)
        # order within chain: by boundary start position along the chain —
        # consecutive snarls share boundaries; sort by linking
        for c, ss in order.items():
            if len(ss) == 1:
                self.chain_structs[c] = ss
                continue
            nxt = {int(self.bounds[s, 0]): s for s in ss}
            ends = {int(self.bounds[s, 1]) for s in ss}
            start = [s for s in ss if int(self.bounds[s, 0]) not in ends][0]
            seq = [start]
            while int(self.bounds[seq[-1], 1]) in nxt:
                seq.append(nxt[int(self.bounds[seq[-1], 1])])
            self.chain_structs[c] = seq

    def structure_boundaries(self, s):
        return int(self.bounds[s, 0]), int(self.bounds[s, 1])

    def structure_beginning_at(self, v):
        return int(self.node_begin[v])

    def structure_ending_at(self, v):
        return int(self.node_end[v])

    def chain_containing(self, s):
        return int(self.chain_of[s])

    def structures_inside(self, c):
        return self.chain_structs[c]

    def snarl_is_acyclic(self, s):
        return bool(self.snarl_acyclic[s])

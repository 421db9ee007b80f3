"""Build the CUDA sources of the package with nvcc at first use.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, ``_build/lib<name>-<hash>.so``, named by the hash of its source
and of the headers it includes (``HEADERS``) so an edited source builds
anew and an unchanged one loads the library already built. nvcc's output
(its ptxas report) stays beside the library as ``lib<name>-<hash>.log``,
so a library built by an earlier process still has its report. Only sources of the checkout go into the build. A missing
nvcc raises: there is no fallback to another implementation.

With CENTROLIGN_TPU_NATIVE_SANITIZE=1 (native/__init__.py's sanitizer
tier) each source builds instead into ``_build/lib<name>_san-<hash>.so``,
its host side (the launchers' offsets, shared-memory sizes, streams and
events) under ASan and UBSan; the device code keeps ``NVCC_FLAGS``, so the
kernels are the same machine code. Such a library loads only into a process
with the sanitizer runtimes preloaded.

The jitter build (``build_jitter_libraries``, ``load_library(name,
jitter=True)``) adds ``-DCENTROLIGN_JITTER=1`` to ``NVCC_FLAGS`` and goes
to ``_build/lib<name>_jit-<hash>.so``: every JITTER(site) of the source
(csrc/jitter.cuh) sleeps a seeded pseudo-random time, set by
``set_jitter``, to hunt races. Only an explicit argument selects it; the
kernel wrappers' own libraries are the plain ones.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

from .. import metrics, native

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# added for the sanitizer tier: host compile and host link only (one
# sanitizer a flag: nvcc splits -Xcompiler's argument at commas)
SAN_FLAGS = ["-Xcompiler", "-fsanitize=address", "-Xcompiler",
             "-fsanitize=undefined", "-Xcompiler", "-fno-sanitize-recover=all",
             "-Xcompiler", "-g"]
# added for the jitter build
JITTER_FLAGS = ["-DCENTROLIGN_JITTER=1"]
# headers every source includes, hashed into each library's name
HEADERS = ["jitter.cuh"]

_libs: dict = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(put the CUDA toolkit's bin directory on PATH)")
    return nvcc


def _library_path(name: str, sanitize: bool | None = None,
                  jitter: bool = False) -> str:
    """The library of csrc/<name>.cu: the jitter one with `jitter`, else
    the sanitized one with `sanitize`, which defaults to the switch."""
    h = hashlib.sha256()
    for src in (f"{name}.cu", *HEADERS):
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    if sanitize is None:
        sanitize = native.sanitizing()
    tag = "_jit" if jitter else "_san" if sanitize else ""
    return os.path.join(BUILD_DIR, f"lib{name}{tag}-{h.hexdigest()[:16]}.so")


def _log_path(so: str) -> str:
    return so[:-len(".so")] + ".log"


def build_log(name: str, sanitize: bool | None = None,
              jitter: bool = False) -> str:
    """nvcc's output for the built library of csrc/<name>.cu (see
    `_library_path`), or "" if it is not built."""
    path = _log_path(_library_path(name, sanitize, jitter))
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def nvcc_command(nvcc: str, out: str, src: str, jitter: bool = False) -> list:
    """The nvcc command line that builds `src` into `out`."""
    extra = (JITTER_FLAGS if jitter else
             SAN_FLAGS if native.sanitizing() else [])
    return [nvcc, *NVCC_FLAGS, *extra, "-o", out, src]


def build_libraries(names) -> None:
    """Build every csrc/<name>.cu of `names` that is not built yet, one
    nvcc process per source, all started together."""
    _build_all(names, jitter=False)


def build_jitter_libraries(names) -> None:
    """`build_libraries` for the jitter build."""
    _build_all(names, jitter=True)


def _build_all(names, jitter: bool) -> None:
    def path(name):
        return _library_path(name, jitter=jitter)

    todo = [n for n in names
            if not all(map(os.path.exists, (path(n), _log_path(path(n)))))]
    if not todo:
        return
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in todo:
        so = path(name)
        tmp = f"{so}.{os.getpid()}.tmp"
        src = os.path.join(CSRC, f"{name}.cu")
        procs.append((name, so, tmp, src, subprocess.Popen(
            nvcc_command(nvcc, tmp, src, jitter), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, src, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{log}")
            continue
        with open(f"{tmp}.log", "w") as f:
            f.write(log)
        os.replace(f"{tmp}.log", _log_path(so))
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str, jitter: bool = False) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (its jitter build with
    `jitter`), built first if needed."""
    key = f"{name}_jit" if jitter else name
    if key in _libs:
        return _libs[key]
    with metrics.process_span("load.cuda"):
        if jitter:
            build_jitter_libraries([name])
            _libs[key] = native.open_library(
                _library_path(name, jitter=True), False)
        else:
            build_libraries([name])
            _libs[key] = native.open_library(_library_path(name),
                                             native.sanitizing())
    return _libs[key]


def set_jitter(name: str, seed: int, max_ns: int) -> None:
    """Every later launch from the jitter build of csrc/<name>.cu sleeps
    up to `max_ns` ns at each JITTER site (0: not at all), the delays drawn
    from `seed`."""
    fn = load_library(name, jitter=True).centrolign_jitter_set
    fn.argtypes = [ctypes.c_uint64, ctypes.c_uint]
    fn.restype = ctypes.c_int
    err = fn(seed, max_ns)
    if err != 0:
        raise RuntimeError(f"centrolign_jitter_set failed on {name}: CUDA "
                           f"error {err}")

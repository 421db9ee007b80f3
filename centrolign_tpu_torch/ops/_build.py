"""Build the CUDA sources of the package with nvcc at first use.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, ``_build/lib<name>-<hash>.so``, named by the hash of its source
so an edited source builds anew and an unchanged one loads the library
already built. nvcc's output (its ptxas report) stays beside the library as
``lib<name>-<hash>.log``, so a library built by an earlier process still
has its report. Only sources of the checkout go into the build. A missing
nvcc raises: there is no fallback to another implementation.

With CENTROLIGN_TPU_NATIVE_SANITIZE=1 (native/__init__.py's sanitizer
tier) each source builds instead into ``_build/lib<name>_san-<hash>.so``,
its host side (the launchers' offsets, shared-memory sizes, streams and
events) under ASan and UBSan; the device code keeps ``NVCC_FLAGS``, so the
kernels are the same machine code. Such a library loads only into a process
with the sanitizer runtimes preloaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

from .. import native

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

_libs: dict = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(put the CUDA toolkit's bin directory on PATH)")
    return nvcc


def _library_path(name: str, sanitize: bool | None = None) -> str:
    """The library of csrc/<name>.cu: the sanitized one with `sanitize`,
    which defaults to the switch."""
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    if sanitize is None:
        sanitize = native.sanitizing()
    san = "_san" if sanitize else ""
    return os.path.join(BUILD_DIR, f"lib{name}{san}-{digest}.so")


def _log_path(so: str) -> str:
    return so[:-len(".so")] + ".log"


def build_log(name: str, sanitize: bool | None = None) -> str:
    """nvcc's output for the built library of csrc/<name>.cu (see
    `_library_path`), or "" if it is not built."""
    path = _log_path(_library_path(name, sanitize))
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def nvcc_command(nvcc: str, out: str, src: str) -> list:
    """The nvcc command line that builds `src` into `out`."""
    san = SAN_FLAGS if native.sanitizing() else []
    return [nvcc, *NVCC_FLAGS, *san, "-o", out, src]


def build_libraries(names) -> None:
    """Build every csrc/<name>.cu of `names` that is not built yet, one
    nvcc process per source, all started together."""
    todo = [n for n in names
            if not all(map(os.path.exists, (_library_path(n),
                                            _log_path(_library_path(n)))))]
    if not todo:
        return
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in todo:
        so = _library_path(name)
        tmp = f"{so}.{os.getpid()}.tmp"
        src = os.path.join(CSRC, f"{name}.cu")
        procs.append((name, so, tmp, src, subprocess.Popen(
            nvcc_command(nvcc, tmp, src), stdout=subprocess.PIPE,
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


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    if name not in _libs:
        build_libraries([name])
        _libs[name] = native.open_library(_library_path(name),
                                          native.sanitizing())
    return _libs[name]

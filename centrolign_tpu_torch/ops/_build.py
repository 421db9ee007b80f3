"""Build the CUDA sources of the package with nvcc at first use.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, ``_build/lib<name>-<hash>.so``, named by the hash of its source
so an edited source builds anew and an unchanged one loads the library
already built. Only sources of the checkout go into the build. A missing
nvcc raises: there is no fallback to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
# per library: (seconds spent building in this process, nvcc's output)
build_info: dict = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(put the CUDA toolkit's bin directory on PATH)")
    return nvcc


def _library_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_libraries(names) -> None:
    """Build every csrc/<name>.cu of `names` that is not built yet, one
    nvcc process per source, all started together."""
    todo = [n for n in names if not os.path.exists(_library_path(n))]
    if not todo:
        return
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        so = _library_path(name)
        tmp = f"{so}.{os.getpid()}.tmp"
        src = os.path.join(CSRC, f"{name}.cu")
        procs.append((name, so, tmp, src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, src, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{log}")
            continue
        os.replace(tmp, so)
        build_info[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    if name not in _libs:
        build_libraries([name])
        _libs[name] = ctypes.CDLL(_library_path(name))
    return _libs[name]

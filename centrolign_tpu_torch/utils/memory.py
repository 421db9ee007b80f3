"""Memory observability (reference utility.hpp:78-85, src/utility.cpp:161-
268): current/peak RSS, human formatting, and leveled logging — called at
every pipeline stage like the reference. When the run's device tier is on
a CUDA card, the card's peak allocated memory is reported too (the scaling
constraints here are host RSS *and* device memory).

Copy of centrolign_tpu/utils/memory.py, with the jax memory_stats() query
replaced by torch.cuda.max_memory_allocated."""

from __future__ import annotations

import os
import resource

from .. import logging as logmod


def current_memory_usage() -> int:
    """Resident set size in bytes (reference src/utility.cpp:161)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return -1


def max_memory_usage() -> int:
    """Peak RSS in bytes (reference src/utility.cpp:202, getrusage)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_maxrss * 1024  # linux reports KiB


_malloc_trim = None


def release_free_heap() -> None:
    """Hand the C heap's free pages back to the system: glibc's
    malloc_trim(0), over the main arena and every thread's; a no-op where
    the C library has none. A stage's freed memory otherwise stays
    resident under the next stage's peak, in amounts that vary from run to
    run with which threads freed it."""
    global _malloc_trim
    if _malloc_trim is None:
        import ctypes
        _malloc_trim = getattr(ctypes.CDLL(None), "malloc_trim", False)
    if _malloc_trim:
        _malloc_trim(0)


def format_memory_usage(mem: int) -> str:
    """Reader-friendly size (reference src/utility.cpp:222-246)."""
    memd = float(mem)
    for unit in ("", "k", "M", "G", "T", "P"):
        if memd < 1024.0 or unit == "P":
            return f"{memd:.2f} {unit}B"
        memd /= 1024.0


def device_memory_usage() -> int:
    """Peak bytes allocated on the current CUDA device, or -1 when this
    process has not used a card (the device tier is on the CPU or off)."""
    import sys
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return -1
    return int(torch.cuda.max_memory_allocated())


def log_memory_usage(level: int) -> None:
    """(reference src/utility.cpp:248-268)"""
    if logmod.level < level:
        return
    peak = max_memory_usage()
    if peak < 0:
        logmod.log(level, "Failed to measure peak memory usage.")
    else:
        logmod.log(level, "Peak memory usage so far: "
                   + format_memory_usage(peak) + ".")
    if level == logmod.Debug:
        curr = current_memory_usage()
        if curr < 0:
            logmod.log(level, "Failed to measure current memory usage.")
        else:
            logmod.log(level, "Current memory usage: "
                       + format_memory_usage(curr) + ".")
        dev = device_memory_usage()
        if dev >= 0:
            logmod.log(level, "Peak device memory allocated: "
                       + format_memory_usage(dev) + ".")

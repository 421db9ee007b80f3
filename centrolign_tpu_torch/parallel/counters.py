"""Kernel-launch counters across processes.

Every wrapper of a hand-written kernel counts its launches in module-level
integers (ops/*_cuda.py). A worker of the pool executor or a rank of the
torch.distributed executor counts in its own process, so it sends a
snapshot back with its result and the parent adds it up in `MERGED`,
apart from its own counters: after a run, `MERGED` holds the workers'
launches, and a caller can show that their work went through the kernels.
`foreign` lists the modules of jax or of the JAX package that the process
has loaded (the port loads none).
"""

from __future__ import annotations

import importlib
import sys

# module of ops/ -> its counters
COUNTERS = {
    "gotoh_cuda": ("FILL_LAUNCHES", "TRACEBACK_LAUNCHES", "DISPATCHED_JOBS"),
    "popoa_dag_cuda": ("FILL_LAUNCHES", "TRACEBACK_LAUNCHES",
                       "DISPATCHED_JOBS"),
    "chain_cdq_cuda": ("LAUNCHES", "PROBLEMS", "ANCHORS", "PLAIN_PROBLEMS",
                       "PLAIN_ANCHORS"),
    "chain_scan_cuda": ("LAUNCHES", "PROBLEMS", "ANCHORS", "PLAIN_PROBLEMS",
                        "PLAIN_ANCHORS"),
    "sharded_gotoh_cuda": ("LAUNCHES", "HALO_COPIES", "EVENT_WAITS",
                           "PROBLEMS", "PLAIN_PROBLEMS"),
}


def _module(name):
    return importlib.import_module(f"centrolign_tpu_torch.ops.{name}")


def foreign_modules() -> list:
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "centrolign_tpu" or m.startswith("centrolign_tpu."))


# the device this worker or rank resolved (str), sent with its snapshot
DEVICE = None


def snapshot() -> dict:
    """{"module.COUNTER": value, ..., "foreign": [module names],
    "device": DEVICE}."""
    out = {f"{name}.{c}": getattr(_module(name), c)
           for name, cs in COUNTERS.items() for c in cs}
    out["foreign"] = foreign_modules()
    out["device"] = DEVICE
    return out


def reset() -> None:
    for name in COUNTERS:
        _module(name).reset_counters()


# over this process's life: the foreign modules and the devices that
# workers and ranks reported, and the sum of their counters
FOREIGN: set = set()
DEVICES: set = set()
MERGED: dict = {}


def merge(snap: dict) -> None:
    """Add a worker's snapshot to MERGED, FOREIGN and DEVICES."""
    for key, value in snap.items():
        if key == "foreign":
            FOREIGN.update(value)
        elif key == "device":
            DEVICES.add(value)
        else:
            MERGED[key] = MERGED.get(key, 0) + value

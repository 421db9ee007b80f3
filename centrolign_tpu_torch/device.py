"""Device selection for the port (twin of centrolign_tpu/device.py).

One setting, ``CENTROLIGN_TORCH_DEVICE``, read only at the entry points:

- ``cuda`` (default): the device tier runs the hand-written kernels on the
  current CUDA device; a process without a usable card raises.
- ``cpu``: the device tier runs the plain PyTorch versions on the CPU.
- ``none``: no device tier; every gap is aligned by the host engines, as
  ``CENTROLIGN_TPU_USE_DEVICE=0`` does in the JAX package.

There is no probe and no fallback: the chosen device is what runs.
"""

from __future__ import annotations

import os

import torch

from . import metrics

ENV = "CENTROLIGN_TORCH_DEVICE"

# the modes resolved in this process (the first resolution of each is the
# process span device.init) and the cards whose CUDA context is made
_resolved: set = set()
_contexts: set = set()


def resolve_device(mode: str | None = None) -> torch.device | None:
    """The device named by `mode` (default: the environment setting), or
    None for ``none``. Raises if ``cuda`` is asked for and there is no card."""
    if mode is None:
        mode = os.environ.get(ENV, "cuda")
    if mode in _resolved:
        return _device(mode)
    with metrics.process_span("device.init"):
        device = _device(mode)
    _resolved.add(mode)
    return device


def make_context(device: torch.device) -> None:
    """Make a card's CUDA context, once a process (the process span
    device.context); the device tier calls it before its first copy to the
    card. Not at resolve_device: made before a process's first host work,
    the context's host memory (about 135 MiB on an H100's host) adds to
    that work's peak resident set instead of filling what it freed."""
    if device.type != "cuda" or device.index in _contexts:
        return
    with metrics.process_span("device.context"):
        torch.cuda.synchronize(device)
    _contexts.add(device.index)


def _device(mode: str) -> torch.device | None:
    if mode == "none":
        return None
    if mode == "cpu":
        return torch.device("cpu")
    if mode == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{ENV}=cuda but torch.cuda.is_available() is false; set "
                f"{ENV}=cpu to run the device tier on the CPU or {ENV}=none "
                "to run without it")
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"{ENV} must be cuda, cpu or none, not {mode!r}")


def device_kind(device: torch.device | None) -> str:
    """The card's name for a CUDA device, else 'cpu' or 'none'."""
    if device is None:
        return "none"
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type

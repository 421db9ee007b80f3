"""Guard bands around a kernel launch's tensors: a check that a launch
writes nothing past its own tensors and changes none of its inputs.

A `Guard` places each tensor of a launch, inputs included, as a typed view
inside a uint8 buffer of its own: a band, the payload, a band. Each band
is at least BAND_MIN bytes and at least one row of the tensor's last two
dimensions (all of a 1-D tensor), and the payload starts on a multiple of
ALIGN bytes, the alignment the launchers' 16-byte loads and cp.async
copies assume. The whole buffer is first filled with the guard's pattern
byte, so an output or scratch tensor whose spec has no init (torch.empty
in the launchers) starts as the pattern too. `check()` then names every
byte of a band that changed and every byte of an input's payload that
changed. A kernel that reads a band and lets it reach an output shows as
an output that differs between two guards of other patterns.

Used by chip_smoke.py (phases 13 and 14) and the tests; nothing on the
package's path uses it.
"""

from __future__ import annotations

from collections import namedtuple
from math import prod

import torch

BAND_MIN = 64 << 10
ALIGN = 256

# a changed byte: the tensor's name, where ("before" or "after" its payload,
# or "payload" of an input), its offset from the payload's first byte and
# its value
Change = namedtuple("Change", "tensor where offset value")


def band_bytes(shape, dtype) -> int:
    """A band's bytes for a tensor: BAND_MIN or one row of its last two
    dimensions, the larger, rounded up to ALIGN."""
    row = prod(tuple(shape)[-2:]) * torch.empty((), dtype=dtype).element_size()
    return -(-max(BAND_MIN, row) // ALIGN) * ALIGN


class Guard:
    """Guarded tensors, their bands filled with `pattern`."""

    def __init__(self, pattern: int):
        self.pattern = pattern
        # name -> (buffer, band bytes, payload bytes, the input's bytes
        # or None)
        self.entries = {}

    def empty(self, name: str, shape, dtype, device,
              init=None) -> torch.Tensor:
        """A tensor of `shape` and `dtype` on `device` between two bands;
        its payload left at the pattern (init None) or filled with init."""
        if name in self.entries:
            raise ValueError(f"{name!r} is guarded already")
        shape = tuple(shape)
        size = torch.empty((), dtype=dtype).element_size()
        nbytes = prod(shape) * size
        band = band_bytes(shape, dtype)
        total = 2 * band + nbytes
        raw = torch.empty(total + ALIGN, dtype=torch.uint8, device=device)
        start = -raw.data_ptr() % ALIGN
        buf = raw[start:start + total]
        buf.fill_(self.pattern)
        x = buf[band:band + nbytes].view(dtype).view(shape)
        if init is not None:
            x.fill_(init)
        self.entries[name] = (buf, band, nbytes, None)
        return x

    def buffers(self, specs, device, prefix: str = "") -> dict:
        """Each (name, shape, dtype, init) of `specs` (a launcher's
        `*_buffers`) guarded on `device`, as a dict by name; `prefix` goes
        before each name in the reports."""
        return {name: self.empty(prefix + name, shape, dtype, device, init)
                for name, shape, dtype, init in specs}

    def input(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A guarded copy of input `x` on its device, its bytes kept to
        compare."""
        g = self.empty(name, x.shape, x.dtype, x.device)
        g.copy_(x)
        buf, band, nbytes, _ = self.entries[name]
        self.entries[name] = (buf, band, nbytes,
                              buf[band:band + nbytes].clone())
        return g

    def check(self) -> list:
        """Every changed byte, as Changes in the order the tensors were
        guarded: each band byte that is no longer the pattern, each input
        payload byte that is no longer the input's."""
        found = []
        for name, (buf, band, nbytes, kept) in self.entries.items():
            parts = [("before", buf[:band], -band, None),
                     ("after", buf[band + nbytes:], nbytes, None)]
            if kept is not None:
                parts.append(("payload", buf[band:band + nbytes], 0, kept))
            for where, part, base, want in parts:
                bad = (part != self.pattern if want is None
                       else part != want).nonzero().flatten()
                if len(bad):
                    values = part[bad].tolist()
                    found += [Change(name, where, base + i, v)
                              for i, v in zip(bad.tolist(), values)]
        return found


def report(changes, limit: int = 20) -> str:
    """`changes` as text, the first `limit` of them one a line."""
    lines = [f"{c.tensor}: {c.where} the payload, offset {c.offset}, byte "
             f"{c.value:#04x}" if c.where != "payload" else
             f"{c.tensor}: input changed at offset {c.offset}, byte "
             f"{c.value:#04x}" for c in changes[:limit]]
    if len(changes) > limit:
        lines.append(f"... {len(changes) - limit} more")
    return "\n".join(lines)

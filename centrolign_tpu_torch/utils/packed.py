"""Bit-packed integer containers (reference packed_vector.hpp:16-97,
paged_vector.hpp:18, vector_support.hpp): drop-in integer-vector substitutes
that trade access latency for memory. Here they are numpy-backed: values are
packed into a uint64 word array at a fixed bit width chosen from the maximum
magnitude (the reference grows width dynamically per append; these are
built in bulk, so the width is chosen once from the data).

These back the PackedPathMerge memory tier selected above
``memory_restraint_size`` (reference core.hpp:310-327).

Copy of centrolign_tpu/utils/packed.py."""

from __future__ import annotations

import numpy as np

_U64 = np.uint64


def _width_for(maxval: int) -> int:
    return max(1, int(maxval).bit_length())


class PackedArray:
    """Fixed-width bit-packed unsigned integer array
    (reference packed_vector.hpp:16)."""

    def __init__(self, values=None, width: int | None = None, size: int = 0):
        if values is None:
            self.width = width or 1
            self.size = size
            n_bits = self.size * self.width
            self.words = np.zeros((n_bits + 63) // 64, dtype=_U64)
            return
        values = np.asarray(values, dtype=np.uint64)
        self.size = len(values)
        self.width = width or _width_for(int(values.max()) if self.size else 0)
        assert self.width <= 63
        n_bits = self.size * self.width
        self.words = np.zeros((n_bits + 63) // 64, dtype=_U64)
        self._bulk_set(np.arange(self.size), values)

    def _bulk_set(self, idx, values):
        w = np.uint64(self.width)
        bit = np.asarray(idx, dtype=_U64) * w
        word = (bit // np.uint64(64)).astype(np.int64)
        off = bit % np.uint64(64)
        mask = (np.uint64(1) << w) - np.uint64(1)
        values = np.asarray(values, dtype=_U64) & mask
        # clear then set low part
        np.bitwise_and.at(self.words, word, ~(mask << off))
        np.bitwise_or.at(self.words, word, values << off)
        # spill into the next word where the field straddles the boundary
        spill = off + w > np.uint64(64)
        if spill.any():
            sw = word[spill] + 1
            soff = np.uint64(64) - off[spill]
            np.bitwise_and.at(self.words, sw, ~(mask >> soff))
            np.bitwise_or.at(self.words, sw, values[spill] >> soff)

    def get(self, idx):
        idx = np.asarray(idx, dtype=_U64)
        w = np.uint64(self.width)
        bit = idx * w
        word = (bit // np.uint64(64)).astype(np.int64)
        off = bit % np.uint64(64)
        mask = (np.uint64(1) << w) - np.uint64(1)
        lo = self.words[word] >> off
        spill = off + w > np.uint64(64)
        if spill.any():
            hi = np.zeros_like(lo)
            hi[spill] = self.words[word[spill] + 1] << (
                np.uint64(64) - off[spill])
            lo = lo | hi
        return lo & mask

    def to_array(self) -> np.ndarray:
        return self.get(np.arange(self.size)).astype(np.uint64)

    def memory_bytes(self) -> int:
        return self.words.nbytes

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        return int(self.get(np.asarray([idx]))[0])


class PackedVector(PackedArray):
    """Unsigned packed vector (reference packed_vector.hpp:54)."""


class SignedPackedVector:
    """Signed values via zigzag encoding (reference packed_vector.hpp:97
    stores sign in the low bit)."""

    def __init__(self, values):
        values = np.asarray(values, dtype=np.int64)
        zig = (values.astype(np.uint64) << np.uint64(1)) ^ (
            (values >> np.int64(63)).astype(np.uint64))
        self._arr = PackedArray(zig)

    def get(self, idx):
        zig = self._arr.get(idx)
        return (zig >> np.uint64(1)).astype(np.int64) ^ -(
            zig & np.uint64(1)).astype(np.int64)

    def to_array(self) -> np.ndarray:
        return self.get(np.arange(len(self._arr)))

    def memory_bytes(self) -> int:
        return self._arr.memory_bytes()

    def __len__(self):
        return len(self._arr)

    def __getitem__(self, idx):
        return int(self.get(np.asarray([idx]))[0])


class PagedVector:
    """Page-anchored difference coding (reference paged_vector.hpp:18):
    values are stored as packed differences from their page's anchor, so
    locally-smooth sequences (like reachability tables) pack tightly even
    when absolute values are large."""

    PAGE = 2048

    def __init__(self, values):
        values = np.asarray(values, dtype=np.int64)
        self.size = len(values)
        n_pages = (self.size + self.PAGE - 1) // self.PAGE
        pad = n_pages * self.PAGE - self.size
        padded = np.concatenate([values, np.zeros(pad, dtype=np.int64)])
        pages = padded.reshape(n_pages, self.PAGE)
        self.anchors = pages[:, 0].copy()
        diffs = pages - self.anchors[:, None]
        self._diffs = SignedPackedVector(diffs.ravel())

    def get(self, idx):
        idx = np.asarray(idx, dtype=np.int64)
        d = self._diffs.get(idx.astype(np.uint64))
        return self.anchors[idx // self.PAGE] + d

    def to_array(self) -> np.ndarray:
        return self.get(np.arange(self.size))

    def memory_bytes(self) -> int:
        return self._diffs.memory_bytes() + self.anchors.nbytes

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        return int(self.get(np.asarray([idx]))[0])


class VectorPair:
    """Two vectors exposed as a vector of pairs (reference
    vector_support.hpp VectorPair)."""

    def __init__(self, first, second):
        self.first = first
        self.second = second
        assert len(first) == len(second)

    def __len__(self):
        return len(self.first)

    def __getitem__(self, idx):
        return (self.first[idx], self.second[idx])

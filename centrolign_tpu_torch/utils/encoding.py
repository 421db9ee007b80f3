"""Base encoding: ACGTN -> 0..4 (case-insensitive), anything else -> 5.

Matches the reference lookup table (reference src/utility.cpp:324-345): only
A/C/G/T/N (upper or lower) map to 0/1/2/3/4, every other byte maps to 5.
Decoding maps 0..4 -> 'A','C','G','T','N'.  Sentinel codes 5-8 are used for
graph source/sink sentinels (reference src/core.cpp, core.hpp:287-288).

Copy of centrolign_tpu/utils/encoding.py.
"""

import numpy as np

_ENC = np.full(256, 5, dtype=np.uint8)
for _i, _c in enumerate("ACGTN"):
    _ENC[ord(_c)] = _i if _c != "N" else 4
_ENC[ord("A")] = 0
_ENC[ord("C")] = 1
_ENC[ord("G")] = 2
_ENC[ord("T")] = 3
_ENC[ord("N")] = 4
for _c, _v in zip("acgtn", (0, 1, 2, 3, 4)):
    _ENC[ord(_c)] = _v

_DEC = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode_base(ch: str) -> int:
    return int(_ENC[ord(ch)])


def encode_seq(seq: str) -> np.ndarray:
    """Encode an ASCII DNA string to a uint8 array of codes 0..5."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ENC[raw]


def decode_base(code: int) -> str:
    return chr(_DEC[code])


def decode_seq(codes: np.ndarray) -> str:
    """Decode an array of codes 0..4 back to an ACGTN string."""
    return _DEC[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")

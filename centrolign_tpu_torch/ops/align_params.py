"""Piecewise-affine alignment scoring parameters.

Defaults are the reference's stitching parameters (reference
src/parameters.cpp:76-79): match=20, mismatch=80, gap_open={60,800,2500},
gap_extend={30,5,1}. DP cells are int32 (reference alignment.hpp:736 IntDP).

Copy of centrolign_tpu/ops/align_params.py.
"""

from __future__ import annotations

from dataclasses import dataclass

MININF = -(2**31) // 2  # reference cell_t::mininf (alignment.hpp:739)


@dataclass(frozen=True)
class AlignmentParams:
    match: int = 20
    mismatch: int = 80
    gap_open: tuple = (60, 800, 2500)
    gap_extend: tuple = (30, 5, 1)

    @property
    def num_pw(self) -> int:
        return len(self.gap_open)

    def truncated(self, num_pw: int) -> "AlignmentParams":
        return AlignmentParams(
            self.match, self.mismatch,
            self.gap_open[:num_pw], self.gap_extend[:num_pw])


def params_from_arrays(match, mismatch, gap_open, gap_extend) -> AlignmentParams:
    """The port's AlignmentParams from scalars and per-piece gap arrays
    (numpy arrays, lists or tuples), as another implementation's
    parameters hand them over."""
    return AlignmentParams(int(match), int(mismatch),
                           tuple(int(x) for x in gap_open),
                           tuple(int(x) for x in gap_extend))

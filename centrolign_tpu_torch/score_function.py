"""Anchor scoring function (reference include/centrolign/score_function.hpp).

Four weight formulas selected by enum; the default ConcaveLengthScaleInverseCount
is fraction * (length / count^p - (length/intercept)^q * intercept), with the
global score_scale calibrated per run (reference default 0.303092).

Copy of centrolign_tpu/score_function.py."""

from __future__ import annotations

from dataclasses import dataclass


class AnchorScore:
    InverseCount = 0
    LengthScaleInverseCount = 1
    ConcaveLengthScaleInverseCount = 2
    ConcaveLengthScaleCountDifference = 3


@dataclass
class ScoreFunction:
    anchor_score_function: int = AnchorScore.ConcaveLengthScaleInverseCount
    pair_count_power: float = 0.5
    length_intercept: float = 2250.0
    length_decay_power: float = 2.0
    score_scale: float = 0.303092

    def anchor_weight(self, count1: int, count2: int, length: int,
                      full_length: int | None = None) -> float:
        if full_length is None:
            full_length = length
        count = float(count1 * count2)
        fraction = float(length) / float(full_length)
        f = self.anchor_score_function
        if f == AnchorScore.InverseCount:
            return fraction / count ** self.pair_count_power
        if f == AnchorScore.LengthScaleInverseCount:
            return fraction * length / count ** self.pair_count_power
        if f == AnchorScore.ConcaveLengthScaleInverseCount:
            return fraction * (
                length / count ** self.pair_count_power
                - (length / self.length_intercept) ** self.length_decay_power
                * self.length_intercept)
        if f == AnchorScore.ConcaveLengthScaleCountDifference:
            return fraction * (
                length - count
                * (length / self.length_intercept) ** self.length_decay_power
                * self.length_intercept)
        raise ValueError(f"Unrecognized anchor scoring function {f}")

"""The yardstick of the kernels' rooflines: the work a chain-tier Gotoh
job needs, counted from its recurrence, and the card's peaks.

Work of a job of V1 x V2 with P gap pieces, whatever kernel computes it
(so a later change to how the kernels work cannot change the count). Each
addition, subtraction, comparison or selection of two int32 values is one
operation, and a max of k terms k - 1:

- an interior cell (V1 V2 of them): the substitution score (a comparison
  that selects match or -mismatch, 1), the diagonal's sum (1), per piece
  I_p and D_p (each an opening sum, an extension sum and their max: 3 + 3),
  and M, the max of 1 + 2P terms (2P): 2 + 8P;
- a cell of the first row or column (V1 + V2 of them, the corner aside):
  one gap kind, 3 per piece, and M over its P terms (P - 1): 4P - 1.

Bytes: the two sequences in, a byte a base; the parameters in, 4 bytes
each of match, mismatch and the P opening and extension costs; the
alignment out, two int32 indices a column, L columns; the score out, 4.

The int32 rate is derived, not published: 64 int32 lanes an SM x 132 SMs x
1,980 MHz (H100 SXM's boost clock), one operation a lane a clock; the HBM3
rate is NVIDIA's published 3.35 TB/s for the H100 SXM. The same constants
as chip_smoke.py (INT32_OPS_PER_S, HBM_BYTES_PER_S). The harness prints
the card's name and power limit beside every run.
"""

from __future__ import annotations

INT32_OPS_PER_S = 64 * 132 * 1.98e9
HBM_BYTES_PER_S = 3.35e12


def gotoh_ops(V1: int, V2: int, P: int) -> int:
    return V1 * V2 * (2 + 8 * P) + (V1 + V2) * (4 * P - 1)


def gotoh_bytes(V1: int, V2: int, P: int, L: int) -> int:
    return (V1 + V2) + 4 * (2 + 2 * P) + 8 * L + 4


def least_seconds(jobs) -> float:
    """The least time the card needs for jobs of (V1, V2, P, L): the larger
    of their operations over the int32 rate and their bytes over the HBM
    rate."""
    ops = sum(gotoh_ops(V1, V2, P) for V1, V2, P, _ in jobs)
    nbytes = sum(gotoh_bytes(V1, V2, P, L) for V1, V2, P, L in jobs)
    return max(ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def timed(fn, reps):
    """(last result, CUDA-event ms per call) after one warm-up call.
    Frozen copy of chip_smoke.py::timed."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1) / reps

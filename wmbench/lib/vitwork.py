"""The work of the Viterbi decode stage, counted from its inputs and
outputs, whatever implements it.

A decode takes coded soft rows (B rows of `n_coded` float32, rate 6 for A
and B blocks, 12 for AB) and gives the bits (int32, one per step) and the
error (float32) of each row.  Its operations, per row, step and one of the
32768 states of the order-15 code: the branch metric, the squared distance
of the step's `rate` soft bits to the state's coded bits (a subtraction, a
square and an add each: 3 * rate), and the add-compare-select (an add and
a compare: 2).  The bytes: the rows read once, the bits and errors written
once.  Whether the branch metrics are materialised (as the port does
today) or computed inside the trellis does not change these counts.
"""

from __future__ import annotations

STATES = 1 << 15


def ops(rows: int, steps: int, rate: int) -> float:
    return float(rows) * steps * STATES * (3 * rate + 2)


def bytes_moved(rows: int, steps: int, rate: int) -> float:
    return float(rows) * (steps * rate * 4 + steps * 4 + 4)


def least_seconds(work_ops: float, work_bytes: float, peak_flops: float,
                  peak_bytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(work_ops / peak_flops, work_bytes / peak_bytes)

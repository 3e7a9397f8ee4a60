"""Statistics of a run's requests."""

from __future__ import annotations

import statistics
from typing import Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The p-th percentile of all values, interpolated linearly between
    the two nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    r = p / 100.0 * (len(v) - 1)
    lo = int(r)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (r - lo)


def spread(values: Sequence[float]) -> float:
    """Interquartile distance over the median, by Python's
    statistics.quantiles(values, n=4)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2

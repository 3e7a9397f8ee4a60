"""Judging a speed scan's answers against the plain reference
(reference/speed.py), through judge.py's numbers.

Per file: whether the program accepts a speed where a branch of the
reference (upstream's own path, or one that qualities tied to rounding
could take) accepts one, how far the program's speed lies from the
nearest such branch's (`speed_gap`: outside the span of grid speeds whose
smoothed quality ties the best's, which is the argmax alone where the
curve has a peak), and the files where it accepts one
and no branch can, or accepts none and every branch must
(`speed_disagree`, a count); the speed-1 patterns judged against the
reference's patterns of the file; the program's input resampled at its
speed against the reference's resample at that speed (`resample_lsb`),
and the patterns at the detected speed against the reference's decode of
that same input.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from . import judge
from .keyed import Geom
from .speed import TIE, Branch, Reference, SpeedGeom, accepts, rejects


def speed_numbers(prog: Optional[float], ref: Reference, sg: SpeedGeom
                  ) -> Tuple[Dict[str, float], Optional[Branch]]:
    """The numbers, and the branch the program's accepted speed is held
    to."""
    branches = ref.detected.branches
    if prog is None:
        ok = any(rejects(b, sg, TIE) for b in branches) or not branches
        return {"speed_gap": 0.0, "speed_disagree": 0.0 if ok else 1.0}, None
    can = [b for b in branches if accepts(b, sg, TIE)]
    if not can:
        return {"speed_gap": 0.0, "speed_disagree": 1.0}, None
    b = min(can, key=lambda b: _outside(prog, b))
    return {"speed_gap": _outside(prog, b), "speed_disagree": 0.0}, b


def _outside(speed: float, b: Branch) -> float:
    """How far `speed` lies outside the span of b's argmax."""
    lo, hi = b.span
    return max(lo - speed, speed - hi, 0.0)


def on_reference_timeline(patterns: List[dict], speed: float,
                          g: Geom) -> List[dict]:
    """The program's patterns at `speed` with the times of the reference's
    input resampled there: a pattern's time is its sample index over the
    program's rate at that speed (int(44100 speed), upstream's name for
    the resampled rate), the reference's the index over 44100."""
    rate = int(g.mark_sample_rate * speed)
    return [dict(p, time=int(round(p["time"] * rate)) / g.mark_sample_rate)
            for p in patterns]


def file_numbers(patterns: List[dict], prog_speed: Optional[float],
                 ref: Reference, at: Optional[list],
                 truth: Optional[np.ndarray], g: Geom, sg: SpeedGeom,
                 detail: Optional[list] = None) -> Dict[str, float]:
    """One file's answer (its patterns, each with its `speed`, and the
    speed the program accepted) against its reference; `at` is the
    reference's patterns of the program's own input at its speed, given
    where that speed is held to a branch's.  (At a speed where the input
    holds no mark, noise-level candidates tie, and a float32 resample's
    1e-7 moves them past reference/scan.py's ties: the resample is judged
    by itself, `resample_lsb`, and the decode on the same input, as the
    speed-1 decode is.)  `detail` gets judge.py's rows, each with "1" or
    "at" appended."""
    rate = g.mark_sample_rate
    nums, branch = speed_numbers(prog_speed, ref, sg)
    groups = [("1", [p for p in patterns if p["speed"] == 1],
               ref.patterns)]
    if branch is not None and at is not None:
        groups.append(("at", on_reference_timeline(
            [p for p in patterns if p["speed"] == prog_speed], prog_speed,
            g), at))
    rows = []
    for tag, prog, refs in groups:
        rows_detail = [] if detail is not None else None
        rows.append(judge.scan_numbers(prog, refs, truth, rate, rows_detail))
        if detail is not None:
            detail.extend(d + (tag,) for d in rows_detail)
    out = judge.worst(rows)
    out.update(nums)
    return out


def resample_lsb(prog: np.ndarray, ref: np.ndarray) -> float:
    """The largest difference, in 16-bit steps, of the program's input
    resampled at its speed from the reference's at the same speed (both
    (n', C) on the int16 scale)."""
    if prog.shape != ref.shape:
        return float("inf")
    return float(np.abs(prog - ref).max(initial=0.0))


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    """judge.worst over the files, `speed_disagree` summed."""
    out = judge.worst(rows)
    out["speed_disagree"] = float(sum(r["speed_disagree"] for r in rows))
    return out

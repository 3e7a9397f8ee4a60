"""Judging the program's answers against the plain reference.

Each compared number is a worst case over the sampled answers of a run.
`gap` numbers are absolute differences of floats; `count` numbers are
exact (their limit is 0).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .scan import RefPattern

# how far a refined block position may move between two near-equal grid
# qualities (one refinement reach, src/syncfinder.cc:427-442)
_REACH = 256


def mark_numbers(prog: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """int16 samples written against the reference's."""
    if prog.shape != ref.shape:
        return {"mark_lsb_max": float("inf"), "mark_lsb_share": 1.0}
    d = np.abs(prog.astype(np.int32) - ref.astype(np.int32))
    return {"mark_lsb_max": float(d.max(initial=0)),
            "mark_lsb_share": float(np.count_nonzero(d) / max(d.size, 1))}


def _candidates(p: dict, refs: Sequence[RefPattern], rate: int):
    idx = int(round(p["time"] * rate))
    out = []
    for r in refs:
        if r.kind != p["kind"] or r.block_type != p["block_type"]:
            continue
        if r.kind == "block" and abs(r.index - idx) > _REACH:
            continue
        if r.kind == "clip" and r.index != idx:
            continue
        out.append(r)
    return out


def scan_numbers(prog: List[dict], refs: List[RefPattern],
                 truth: Optional[np.ndarray], rate: int,
                 detail: Optional[list] = None) -> Dict[str, float]:
    """The program's patterns of one file against the reference's superset.

    Every program pattern is matched to the reference pattern of its kind
    and block type (a block within one refinement reach) whose quality and
    decode error lie nearest; the numbers are the worst gaps, the patterns
    with no counterpart, the bits of true marks the program got wrong, and
    the reference's own core true-mark blocks the program does not
    report."""
    q_gap = e_gap = 0.0
    unmatched = bit_errors = 0
    for p in prog:
        cands = _candidates(p, refs, rate)
        if not cands:
            unmatched += 1
            continue
        r = min(cands, key=lambda r: max(abs(r.quality - p["quality"]),
                                         abs(r.error - p["error"])))
        q_gap = max(q_gap, abs(r.quality - p["quality"]))
        e_gap = max(e_gap, abs(r.error - p["error"]))
        if detail is not None:
            detail.append((abs(r.error - p["error"]),
                           abs(r.quality - p["quality"]), p["kind"],
                           p["block_type"], int(round(p["time"] * rate)),
                           p["quality"], r.quality, p["error"], r.error,
                           r.index))
        if truth is not None and np.array_equal(r.bits, truth) \
                and not np.array_equal(np.asarray(p["bits"]), truth):
            bit_errors += 1
    missed = 0
    if truth is not None:
        for r in refs:
            if r.kind == "block" and r.core and r.block_type != "ab" \
                    and np.array_equal(r.bits, truth):
                if not any(p["kind"] == "block" and
                           p["block_type"] == r.block_type and
                           abs(int(round(p["time"] * rate)) - r.index)
                           <= _REACH and
                           np.array_equal(np.asarray(p["bits"]), truth)
                           for p in prog):
                    missed += 1
    return {"scan_quality_gap": q_gap, "scan_error_gap": e_gap,
            "scan_unmatched": float(unmatched),
            "scan_mark_bit_errors": float(bit_errors),
            "scan_marks_missed": float(missed)}


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def fleet_numbers(out: Dict[str, np.ndarray], row: int,
                  refs: List[RefPattern], truth: Optional[np.ndarray],
                  rate: int, top_k: int,
                  detail: Optional[list] = None) -> Dict[str, float]:
    """One stream of a detect_batch answer: its eligible slots judged as
    block patterns, and the slots it leaves ineligible where the reference
    has candidates for them."""
    prog = []
    for k in range(out["positions"].shape[1]):
        if not out["eligible"][row, k]:
            continue
        prog.append({"kind": "block",
                     "block_type": "a" if out["block_is_a"][row, k] else "b",
                     "time": float(out["positions"][row, k]) / rate,
                     "quality": float(out["qualities"][row, k]),
                     "error": float(out["errors"][row, k]),
                     "bits": list(out["bits"][row, k])})
    nums = scan_numbers(prog, refs, truth, rate, detail)
    n_ref = sum(1 for r in refs if r.kind == "block" and r.block_type != "ab")
    nums["fleet_ineligible"] = float(max(0, min(top_k, n_ref) - len(prog)))
    return nums

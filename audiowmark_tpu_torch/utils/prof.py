"""Wall-clock phase accounting for the add and get pipelines.

Copy of audiowmark_tpu/utils/prof.py.  With AUDIOWMARK_PROFILE_PHASES=1 (or
`prof.enabled = True`) every `with prof.phase(name)` adds its wall time to
`totals[name]`: file IO, chunk loading and the wait for the prefetch
thread, the group and clip searches.  CUDA launches are asynchronous, so a
phase's time is where the HOST blocks (the cost of enqueueing, or the
read-back that waits for all the enqueued device work), which is the right
attribution for a wall-clock breakdown.

Near-zero overhead when disabled (one attribute check per phase)."""

from __future__ import annotations

import collections
import contextlib
import os
import time

enabled = bool(int(os.environ.get("AUDIOWMARK_PROFILE_PHASES", "0") or 0))
totals = collections.defaultdict(float)
counts = collections.defaultdict(int)


@contextlib.contextmanager
def phase(name: str):
    if not enabled:
        yield
        return
    t0 = time.monotonic()
    try:
        yield
    finally:
        totals[name] += time.monotonic() - t0
        counts[name] += 1


def reset() -> None:
    totals.clear()
    counts.clear()


def report() -> dict:
    """{phase: seconds} sorted by cost, plus call counts."""
    return {k: {"s": round(v, 4), "n": counts[k]}
            for k, v in sorted(totals.items(), key=lambda kv: -kv[1])}

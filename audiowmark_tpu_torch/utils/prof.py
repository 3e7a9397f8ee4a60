"""The port's tracer: wall-clock spans and build counters of the add, get
and fleet paths, on the device trace's clock.

Off by default; `prof.enabled = True` (AUDIOWMARK_PROFILE=<dir> on the
command line, the benchmark's traced run) switches it on.  Then

* every `with prof.phase(name)` adds its wall time to `totals[name]` and
  one to `counts[name]`, and, while a torch.profiler trace is recording,
  is also a `record_function(name)` annotation: the span lies in the same
  Chrome trace as the card's kernels and copies, on Kineto's clock, nested
  on its own thread.  CUDA launches are asynchronous, so a span's wall
  time is where the HOST blocks (the cost of enqueueing, or the read-back
  that waits for all the enqueued device work);
* every `prof.count(name)` adds to `counters[name]`: the builds of what
  the program caches (`build.key_tables`, `build.tables_upload`,
  `build.viterbi_decoder`, `build.k1`, `build.detector`).

Span names are `<path>.<stage>` (`add.read`, `get.extract`, `fleet.enqueue`,
`detect.refine`, ...); spans that one metric adds together are siblings,
never nested on one thread.

Disabled, `phase()` returns one shared no-op context object and `count()`
returns at once: one attribute check and one call each.  torch is
imported on the enabled path only.  `report()` is that of the JAX
package's utils/prof.py, which has spans of wall time alone; `reset()`
also clears the counters.
"""

from __future__ import annotations

import collections
import threading
import time

enabled = False
totals = collections.defaultdict(float)
counts = collections.defaultdict(int)
counters = collections.defaultdict(int)

_lock = threading.Lock()      # spans end on the prefetch thread too


class _Off:
    """The disabled span: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "t0", "annotation")

    def __init__(self, name: str):
        self.name = name
        self.annotation = None

    def __enter__(self):
        from torch.autograd import profiler
        # the annotation only shows in a recording trace; outside one it
        # would cost a dispatcher call for nothing
        if profiler._is_profiler_enabled:
            self.annotation = profiler.record_function(self.name)
            self.annotation.__enter__()
        self.t0 = time.monotonic()
        return None

    def __exit__(self, *exc):
        dt = time.monotonic() - self.t0
        with _lock:
            totals[self.name] += dt
            counts[self.name] += 1
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def phase(name: str):
    """`with prof.phase(name):` times the block as span `name`."""
    if not enabled:
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`."""
    if not enabled:
        return
    with _lock:
        counters[name] += n


def reset() -> None:
    totals.clear()
    counts.clear()
    counters.clear()


def report() -> dict:
    """{phase: seconds} sorted by cost, plus call counts."""
    return {k: {"s": round(v, 4), "n": counts[k]}
            for k, v in sorted(totals.items(), key=lambda kv: -kv[1])}

"""Spans the benchmark puts around the program's calls in the traced run,
from its own files.

* `wmbench.viterbi` around every ViterbiDecoder.forward (the one decode
  entry of the get's batched decodes and of the fleet detector), with the
  work of each call (wmbench/lib/vitwork.py) in counters["viterbi"];
* the program's own phases (utils/prof.py: get.load, get.load_join,
  get.search_*), switched on and also shown as spans in the trace.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def program_spans(counters: dict):
    from torch.profiler import record_function

    from audiowmark_tpu_torch.codec import convcode
    from audiowmark_tpu_torch.utils import prof

    from . import vitwork

    forward0 = convcode.ViterbiDecoder.forward
    phase0 = prof.phase
    work = counters.setdefault("viterbi", [])

    def forward(self, groups):
        ops = moved = 0.0
        for block_type, coded in groups:
            rate = self.table(block_type).shape[1]
            rows, steps = coded.shape[0], coded.shape[1] // rate
            ops += vitwork.ops(rows, steps, rate)
            moved += vitwork.bytes_moved(rows, steps, rate)
        work.append((ops, moved))
        with record_function("wmbench.viterbi"):
            return forward0(self, groups)

    @contextlib.contextmanager
    def phase(name):
        with record_function(name), phase0(name):
            yield

    convcode.ViterbiDecoder.forward = forward
    prof.phase = phase
    try:
        yield
    finally:
        convcode.ViterbiDecoder.forward = forward0
        prof.phase = phase0

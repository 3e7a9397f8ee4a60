"""The Viterbi decode stage's share of its roofline.

Time: the device time (union) of the kernels launched inside the
benchmark's `wmbench.viterbi` spans around ViterbiDecoder.forward (the
branch metrics and kernel K1).  Work: wmbench/lib/vitwork.py, counted from
the decode's rows and coded length.  Bound: the published H100 float32
peak and HBM bandwidth (wmbench/lib/peaks.py); the run prints the card's
power limit beside it."""

from wmbench.lib import peaks, trace, vitwork


def read(run):
    work = run.counters.get("viterbi")
    if run.trace is None or not work:
        return None
    ks = trace.kernels_in_spans(run.trace, "wmbench.viterbi")
    busy = sum(e - s for s, e in trace.union(
        [(k["ts"], k["ts"] + k["dur"]) for k in ks])) / 1e6
    if busy <= 0:
        return None
    least = vitwork.least_seconds(sum(w[0] for w in work),
                                  sum(w[1] for w in work),
                                  peaks.F32_FLOPS, peaks.HBM_BYTES_PER_S)
    return 100.0 * least / busy

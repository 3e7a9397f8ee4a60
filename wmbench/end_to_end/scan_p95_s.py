"""95th percentile of the latency of every scan request completed in the
window, each from its start to its result on the host."""

from wmbench.lib.stats import percentile


def read(run):
    return percentile([r.end - r.start for r in run.done()], 95)

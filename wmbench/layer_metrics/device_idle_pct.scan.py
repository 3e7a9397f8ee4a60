"""100 minus the cards' busy share: the union of each card's kernel and
copy intervals over the traced window, averaged over the cards the cell
uses."""

from wmbench.lib import trace


def read(run):
    if run.trace is None or not run.trace.device or run.window_s <= 0:
        return None
    busy, _ = trace.busy_intervals(run.trace.device)
    mean = sum(busy.get(i, 0.0) for i in range(run.chips)) / run.chips
    return 100.0 * (1.0 - mean / run.window_s)

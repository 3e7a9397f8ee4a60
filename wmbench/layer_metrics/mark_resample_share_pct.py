"""The resampler pair's share of the add's time: the program's own span
`add.resample` (utils/prof.py: host wall time of every write into and read
from the streaming resamplers 48 -> 44.1 and 44.1 -> 48 kHz, where their
per-tap launches are enqueued) over the summed walls of the traced
window's completed requests.  None where the program has no such span."""


def read(run):
    if "add.resample" not in run.phases:
        return None
    walls = sum(r.end - r.start for r in run.done())
    return 100.0 * run.phases["add.resample"] / walls if walls > 0 else None

"""The fleet detectors' enqueue's share of the scan's time: the program's
own span `fleet.enqueue` (utils/prof.py: host wall time of each card's
detector call, which launches the per-stream stages from the one host
thread) over the summed walls of the traced window's completed requests.
None where the program has no such span."""


def read(run):
    if "fleet.enqueue" not in run.phases:
        return None
    walls = sum(r.end - r.start for r in run.done())
    return 100.0 * run.phases["fleet.enqueue"] / walls if walls > 0 else None

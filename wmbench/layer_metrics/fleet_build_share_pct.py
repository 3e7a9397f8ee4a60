"""The fleet detectors' construction's share of the scan's time: the
program's own span `fleet.build` (utils/prof.py: host wall time of every
build_detector call of detect_batch, one per card and call) over the
summed walls of the traced window's completed requests.  None where the
program has no such span."""


def read(run):
    if "fleet.build" not in run.phases:
        return None
    walls = sum(r.end - r.start for r in run.done())
    return 100.0 * run.phases["fleet.build"] / walls if walls > 0 else None

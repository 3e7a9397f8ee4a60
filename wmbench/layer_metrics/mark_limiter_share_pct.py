"""The host limiter's share of the add's time: the program's own span
`add.limiter` (utils/prof.py: host wall time of every
StreamingLimiter.process of the mixed samples) over the summed walls of
the traced window's completed requests.  None where the program has no
such span."""


def read(run):
    if "add.limiter" not in run.phases:
        return None
    walls = sum(r.end - r.start for r in run.done())
    return 100.0 * run.phases["add.limiter"] / walls if walls > 0 else None

"""The sample reader's share of the add's time: the program's own span
`add.read` (utils/prof.py: host wall time of every read of the input
stream, the WAV decode) over the summed walls of the traced window's
completed requests.  None where the program has no such span."""


def read(run):
    if "add.read" not in run.phases:
        return None
    walls = sum(r.end - r.start for r in run.done())
    return 100.0 * run.phases["add.read"] / walls if walls > 0 else None

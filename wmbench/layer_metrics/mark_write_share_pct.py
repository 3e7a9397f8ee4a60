"""The sample writer's share of the add's time: the program's own span
`add.write` (utils/prof.py: host wall time of every write to the output
stream, the encode) over the summed walls of the traced window's
completed requests.  None where the program has no such span."""


def read(run):
    if "add.write" not in run.phases:
        return None
    walls = sum(r.end - r.start for r in run.done())
    return 100.0 * run.phases["add.write"] / walls if walls > 0 else None

"""Speed detection's share of the get's time: the program's span
`get.speed` (utils/prof.py: the whole detect_speed call of a chunk, host
wall time) over the summed walls of the traced window's completed
requests.  None where the program has no such span."""


def read(run):
    walls = sum(r.end - r.start for r in run.done())
    if "get.speed" not in run.phases or walls <= 0:
        return None
    return 100.0 * run.phases["get.speed"] / walls

"""The chunk loader's share of the get's time: the program's own phases
`get.load` and `get.load_join` (utils/prof.py: host wall time where the
get blocks on loading) over the summed walls of the window's requests."""


def read(run):
    if not run.phases:
        return None
    walls = sum(r.end - r.start for r in run.done())
    s = run.phases.get("get.load", 0.0) + run.phases.get("get.load_join",
                                                          0.0)
    return 100.0 * s / walls if walls > 0 else None

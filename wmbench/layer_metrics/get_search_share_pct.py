"""The sync search's share of the get's time: the program's phases
`get.search_block`, `get.search_clip` and `get.search_group` (utils/prof.py)
over the summed walls of the window's requests."""


def read(run):
    s = sum(v for k, v in run.phases.items() if k.startswith("get.search_"))
    walls = sum(r.end - r.start for r in run.done())
    return 100.0 * s / walls if s > 0 and walls > 0 else None

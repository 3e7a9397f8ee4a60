"""The speed search's clip choice as a share of the get's time: the
program's span `speed.clip` (the keyed, content-hashed clip locations and
their energy sums, on the host) over the summed walls of the traced
window's completed requests.  None where the program has no such span."""


def read(run):
    walls = sum(r.end - r.start for r in run.done())
    if "speed.clip" not in run.phases or walls <= 0:
        return None
    return 100.0 * run.phases["speed.clip"] / walls

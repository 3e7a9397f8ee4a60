"""Extraction and decoding's share of the get's time: the program's own
spans `get.extract` (the block and clip decoders' soft bits, joins and
chains after their search) and `viterbi.forward` (the trellis's branch
metrics and launch), siblings on the get's thread (utils/prof.py: host
wall time), over the summed walls of the traced window's completed
requests.  None where the program has no such span."""


def read(run):
    if "get.extract" not in run.phases:
        return None
    walls = sum(r.end - r.start for r in run.done())
    s = run.phases["get.extract"] + run.phases.get("viterbi.forward", 0.0)
    return 100.0 * s / walls if walls > 0 else None

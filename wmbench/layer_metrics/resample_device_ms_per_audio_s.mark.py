"""Device milliseconds of the resampler pair per second of audio marked:
the union of the intervals of the kernels launched inside the program's
`add.resample` spans (utils/prof.py; wmbench/lib/trace.kernels_in_spans)
over the seconds of audio of the traced window's completed requests.
None where the trace has no such span or no kernel in one."""

from wmbench.lib import trace


def read(run):
    audio = run.audio_s()
    if run.trace is None or audio <= 0:
        return None
    ks = trace.kernels_in_spans(run.trace, "add.resample")
    if not ks:
        return None
    us = sum(e - s for s, e in trace.union(
        [(k["ts"], k["ts"] + k["dur"]) for k in ks]))
    return us / 1e3 / audio

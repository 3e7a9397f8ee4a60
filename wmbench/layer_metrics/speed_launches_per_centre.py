"""Kernel launches of speed detection per centre speed scanned: the kernel
events launched inside the program's `get.speed` spans
(wmbench/lib/trace.kernels_in_spans) over the program's counter
`speed.centres` (utils/prof.py: the mag matrices built, one per centre of
each scan), which the traced run resets as it starts and which counts
while its trace records.  None where the program has no such span or
counter."""

from wmbench.lib import trace


def read(run):
    from audiowmark_tpu_torch.utils import prof
    centres = getattr(prof, "counters", {}).get("speed.centres", 0)
    if run.trace is None or centres <= 0:
        return None
    ks = trace.kernels_in_spans(run.trace, "get.speed")
    return len(ks) / centres if ks else None

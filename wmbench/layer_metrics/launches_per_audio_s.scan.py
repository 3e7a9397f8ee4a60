"""Kernel launches in the traced window over the seconds of audio
scanned."""


def read(run):
    audio = run.audio_s()
    if run.trace is None or not run.trace.device or audio <= 0:
        return None
    return len(run.trace.kernels()) / audio

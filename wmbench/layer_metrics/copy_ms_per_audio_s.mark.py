"""Device milliseconds of host-to-card and card-to-host copies in the
traced window over the seconds of audio marked."""


def read(run):
    audio = run.audio_s()
    if run.trace is None or not run.trace.device or audio <= 0:
        return None
    ms = sum(e["dur"] for e in run.trace.device
             if e["cat"] == "gpu_memcpy"
             and ("HtoD" in e["name"] or "DtoH" in e["name"])) / 1e3
    return ms / audio

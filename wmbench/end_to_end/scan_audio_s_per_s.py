"""Seconds of input audio of every scan request completed in the window,
over the window's seconds (host clock)."""


def read(run):
    return run.audio_s() / run.window_s

"""Seconds of audio of every mark request completed in the window (its
output fully written), over the window's seconds (host clock)."""


def read(run):
    return run.audio_s() / run.window_s

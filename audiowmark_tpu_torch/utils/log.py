"""Leveled stderr logging (reference: src/utils.hh:76-84, src/utils.cc).

All informational output goes to stderr; stdout is reserved for
machine-readable results (pattern/match_count lines, JSON).
"""

from __future__ import annotations

import sys
import time
from enum import IntEnum


class Log(IntEnum):
    ERROR = 1
    WARNING = 2
    INFO = 3
    DEBUG = 4


_log_level = Log.INFO


def set_log_level(level: Log):
    global _log_level
    _log_level = level


def _log(level: Log, msg: str):
    if level <= _log_level:
        sys.stderr.write(msg)
        sys.stderr.flush()


def error(msg: str):
    _log(Log.ERROR, msg)


def warning(msg: str):
    _log(Log.WARNING, msg)


def info(msg: str):
    _log(Log.INFO, msg)


def debug(msg: str):
    _log(Log.DEBUG, msg)


def get_time() -> float:
    """Monotonic wall-clock seconds (reference: src/utils.cc:35-43)."""
    return time.monotonic()


def print_memory_usage(label: str = ""):
    """Peak/current RSS to stderr (reference: src/utils.cc:45-81)."""
    try:
        import resource
        peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        import os
        rss_kb = rss_pages * os.sysconf("SC_PAGE_SIZE") // 1024
        info("memory usage%s: peak %.1f MB, current %.1f MB\n"
             % ((" " + label if label else ""), peak_kb / 1024,
                rss_kb / 1024))
    except (OSError, ImportError, ValueError):
        pass

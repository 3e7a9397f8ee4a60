"""ctypes binding to libmpg123 — the same decoder library the reference
links for MP3 input (reference: src/mp3inputstream.cc).

Only the handful of entry points the reference uses are bound: handle
lifecycle, format forcing (float32 at every MPEG rate), open/feed, scan /
length, and read.  The binding degrades cleanly: `available()` is False when
the shared library is absent and MP3 input reports a clear error.
"""

from __future__ import annotations

import ctypes
from typing import Optional

_OK = 0
_DONE = -12
_NEW_FORMAT = -11
_NEED_MORE = -10

_ENC_FLOAT_32 = 0x200
_MONO_STEREO = 0x3           # MPG123_MONO | MPG123_STEREO
_ADD_FLAGS = 2               # enum mpg123_parms
_QUIET = 0x20                # MPG123_QUIET flag

_RATES = (8000, 11025, 12000, 16000, 22050, 24000, 32000, 44100, 48000)

_lib = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    for name in ("libmpg123.so.0", "libmpg123.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.mpg123_init()
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_strerror.restype = ctypes.c_char_p
        lib.mpg123_strerror.argtypes = [ctypes.c_void_p]
        lib.mpg123_param.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_long, ctypes.c_double]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                      ctypes.c_int, ctypes.c_int]
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
        lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_size_t]
        lib.mpg123_getformat.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_long),
                                         ctypes.POINTER(ctypes.c_int),
                                         ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_scan.argtypes = [ctypes.c_void_p]
        lib.mpg123_length.restype = ctypes.c_long
        lib.mpg123_length.argtypes = [ctypes.c_void_p]
        lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_size_t)]
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
    _load_failed = True
    return None


def available() -> bool:
    return _load() is not None


class Mpg123Error(Exception):
    pass


class Mpg123:
    """One decoder handle forced to float32 output at every MPEG rate
    (reference: src/mp3inputstream.cc:67-81)."""

    def __init__(self):
        lib = _load()
        if lib is None:
            raise Mpg123Error("libmpg123 is not available")
        self._lib = lib
        err = ctypes.c_int(0)
        self.h = lib.mpg123_new(None, ctypes.byref(err))
        if not self.h:
            raise Mpg123Error("mpg123_new failed (%d)" % err.value)
        lib.mpg123_param(self.h, _ADD_FLAGS, _QUIET, 0.0)
        lib.mpg123_format_none(self.h)
        for rate in _RATES:
            lib.mpg123_format(self.h, rate, _MONO_STEREO, _ENC_FLOAT_32)
        self._open = False

    def _err(self, what: str) -> Mpg123Error:
        msg = self._lib.mpg123_strerror(self.h)
        return Mpg123Error("%s: %s" % (what, (msg or b"?").decode()))

    def open(self, path: str):
        if self._lib.mpg123_open(self.h, path.encode()) != _OK:
            raise self._err("mpg123_open")
        self._open = True

    def open_feed(self):
        if self._lib.mpg123_open_feed(self.h) != _OK:
            raise self._err("mpg123_open_feed")
        self._open = True

    def feed(self, data: bytes) -> int:
        return self._lib.mpg123_feed(self.h, data, len(data))

    def getformat(self):
        rate = ctypes.c_long()
        ch = ctypes.c_int()
        enc = ctypes.c_int()
        rc = self._lib.mpg123_getformat(self.h, ctypes.byref(rate),
                                        ctypes.byref(ch), ctypes.byref(enc))
        if rc != _OK:
            raise self._err("mpg123_getformat")
        return rate.value, ch.value, enc.value

    def scan_length(self) -> Optional[int]:
        """Exact per-channel sample count via a full stream scan
        (reference: src/mp3inputstream.cc:89-92); None if unknown."""
        if self._lib.mpg123_scan(self.h) != _OK:
            return None
        n = self._lib.mpg123_length(self.h)
        return n if n >= 0 else None

    def read(self, max_bytes: int):
        """Returns (rc, bytes); rc is one of OK/DONE/NEW_FORMAT/NEED_MORE
        or a negative error."""
        buf = ctypes.create_string_buffer(max_bytes)
        done = ctypes.c_size_t(0)
        rc = self._lib.mpg123_read(self.h, buf, max_bytes,
                                   ctypes.byref(done))
        return rc, buf.raw[: done.value]

    def close(self):
        if self._open:
            self._lib.mpg123_close(self.h)
            self._open = False

    def delete(self):
        self.close()
        if self.h:
            self._lib.mpg123_delete(self.h)
            self.h = None

    def __del__(self):
        try:
            self.delete()
        except Exception:
            pass


OK = _OK
DONE = _DONE
NEW_FORMAT = _NEW_FORMAT
NEED_MORE = _NEED_MORE

"""ctypes binding to libmp3lame — MP3 *encoding* for test fixtures and the
BER attack harness (the reference's test suite shells out to `lame`, e.g.
tests in src/ber-mp3.sh; this image has the library but no CLI).

Not part of the watermarking surface: the reference never encodes MP3.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

_lib = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    for name in ("libmp3lame.so.0", "libmp3lame.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.lame_init.restype = ctypes.c_void_p
        for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
                   "lame_set_brate", "lame_set_quality",
                   "lame_set_mode"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lame_init_params.argtypes = [ctypes.c_void_p]
        lib.lame_encode_buffer_interleaved_ieee_float.restype = ctypes.c_int
        lib.lame_encode_buffer_interleaved_ieee_float.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int]
        lib.lame_encode_flush.restype = ctypes.c_int
        lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int]
        lib.lame_get_lametag_frame.restype = ctypes.c_size_t
        lib.lame_get_lametag_frame.argtypes = [ctypes.c_void_p,
                                               ctypes.c_void_p,
                                               ctypes.c_size_t]
        lib.lame_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
    _load_failed = True
    return None


def available() -> bool:
    return _load() is not None


def encode_mp3(samples: np.ndarray, n_channels: int, sample_rate: int,
               bitrate_kbps: int = 128, quality: int = 2) -> bytes:
    """Encode interleaved float32 samples (+-1 range) to an MP3 byte string
    at a constant bitrate."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libmp3lame is not available")
    x = np.asarray(samples, dtype=np.float32).reshape(-1, n_channels)
    if n_channels == 1:
        # the interleaved float API requires 2 channels; duplicate mono
        x = np.repeat(x, 2, axis=1)
    x = np.ascontiguousarray(x)
    n = x.shape[0]

    gf = lib.lame_init()
    try:
        lib.lame_set_in_samplerate(gf, sample_rate)
        lib.lame_set_num_channels(gf, n_channels)
        lib.lame_set_brate(gf, bitrate_kbps)
        lib.lame_set_quality(gf, quality)
        if n_channels == 1:
            lib.lame_set_mode(gf, 3)        # MONO
        if lib.lame_init_params(gf) < 0:
            raise RuntimeError("lame_init_params failed "
                               "(rate %d not supported?)" % sample_rate)
        out = bytearray()
        buf = ctypes.create_string_buffer(int(1.25 * n) + 7200)
        nb = lib.lame_encode_buffer_interleaved_ieee_float(
            gf, x.ctypes.data_as(ctypes.c_void_p), n, buf, len(buf))
        if nb < 0:
            raise RuntimeError("lame encode failed (%d)" % nb)
        out += buf.raw[:nb]
        nb = lib.lame_encode_flush(gf, buf, len(buf))
        if nb < 0:
            raise RuntimeError("lame flush failed (%d)" % nb)
        out += buf.raw[:nb]
        # patch the Xing/LAME info frame so decoders can trim the encoder
        # delay/padding (the lame CLI rewrites it in place the same way)
        tag_size = lib.lame_get_lametag_frame(gf, buf, len(buf))
        if 0 < tag_size <= len(out):
            out[:tag_size] = buf.raw[:tag_size]
        return bytes(out)
    finally:
        lib.lame_close(gf)

"""ctypes binding for the native libav codec shim (native/libffshim.so).

Provides the capabilities the reference gets from its media libraries:

* `FFInputStream` — streaming decode of any audio container/codec the
  FFmpeg libraries know (Opus, ALAC, AAC/M4A, MPEG-TS, ...); the input
  factory uses it as the fallback after the WAV/FLAC/Vorbis/MP3 native
  detectors, mirroring libsndfile's role in the reference
  (src/sfinputstream.cc:75-149).
* `probe()` — stream parameters for hls-prepare validation (the reference
  shells out to ffprobe, src/hls.cc:164-211).
* `encode_file()` — one-shot PCM -> compressed file (test fixtures and the
  BER harness attack transforms, reference src/ber-test.sh).
* `HLSSegmentWriter` — AAC encode + cut/keep frame window + MPEG-TS mux at
  the original PTS (the reference's libav HLSOutputStream,
  src/hlsoutputstream.cc).
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional

import numpy as np

from .streams import AudioInputStream, StreamError

_lib = None
_tried = False

_ERRLEN = 512


def _find_lib() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # an explicit FFSHIM_LIB must win over the repo default
    for cand in (os.environ.get("FFSHIM_LIB", ""),
                 os.path.join(here, "native", "libffshim.so")):
        if cand and os.path.exists(cand):
            return cand
    return None


def get_lib():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        _lib = None
        return None
    c = ctypes
    lib.ffs_open.argtypes = [c.c_char_p, c.c_char_p, c.c_char_p, c.c_int]
    lib.ffs_open.restype = c.c_void_p
    lib.ffs_rate.argtypes = [c.c_void_p]
    lib.ffs_rate.restype = c.c_int
    lib.ffs_channels.argtypes = [c.c_void_p]
    lib.ffs_channels.restype = c.c_int
    lib.ffs_bit_depth.argtypes = [c.c_void_p]
    lib.ffs_bit_depth.restype = c.c_int
    lib.ffs_codec_name.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    lib.ffs_codec_name.restype = c.c_int
    lib.ffs_bit_rate.argtypes = [c.c_void_p]
    lib.ffs_bit_rate.restype = c.c_longlong
    lib.ffs_duration_frames.argtypes = [c.c_void_p]
    lib.ffs_duration_frames.restype = c.c_longlong
    lib.ffs_read.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_long]
    lib.ffs_read.restype = c.c_long
    lib.ffs_close.argtypes = [c.c_void_p]
    lib.ffs_probe.argtypes = [c.c_char_p, c.c_char_p, c.c_int, c.c_char_p,
                              c.c_int]
    lib.ffs_probe.restype = c.c_int
    lib.ffs_payload_stats.argtypes = [c.c_char_p,
                                      c.POINTER(c.c_longlong),
                                      c.POINTER(c.c_longlong),
                                      c.POINTER(c.c_int), c.c_char_p,
                                      c.c_int]
    lib.ffs_payload_stats.restype = c.c_int
    lib.ffs_encode.argtypes = [c.c_char_p, c.c_char_p, c.c_char_p, c.c_int,
                               c.c_int, c.c_longlong,
                               c.POINTER(c.c_float), c.c_longlong,
                               c.c_char_p, c.c_int]
    lib.ffs_encode.restype = c.c_int
    lib.ffs_encoder_rate.argtypes = [c.c_char_p, c.c_int]
    lib.ffs_encoder_rate.restype = c.c_int
    lib.ffs_have_encoder.argtypes = [c.c_char_p]
    lib.ffs_have_encoder.restype = c.c_int
    lib.ffs_stream_counts.argtypes = [c.c_char_p, c.POINTER(c.c_int),
                                      c.POINTER(c.c_int), c.c_char_p,
                                      c.c_int]
    lib.ffs_stream_counts.restype = c.c_int
    lib.ffr_remux_audio.argtypes = [c.c_char_p, c.c_char_p, c.c_char_p,
                                    c.c_char_p, c.c_int]
    lib.ffr_remux_audio.restype = c.c_int
    lib.ffv_make_test_video.argtypes = [c.c_char_p, c.c_double, c.c_int,
                                        c.c_int, c.c_double, c.c_char_p,
                                        c.c_int]
    lib.ffv_make_test_video.restype = c.c_int
    lib.ffh_open.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_longlong,
                             c.c_longlong, c.c_longlong, c.c_double,
                             c.c_char_p, c.c_char_p, c.c_int]
    lib.ffh_open.restype = c.c_void_p
    lib.ffh_write.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_long]
    lib.ffh_write.restype = c.c_long
    lib.ffh_close.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    lib.ffh_close.restype = c.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def have_encoder(codec: str) -> bool:
    lib = get_lib()
    return bool(lib and lib.ffs_have_encoder(codec.encode()))


def encoder_rate(codec: str, want: int) -> int:
    """Sample rate the codec will actually use (opus forces 48000)."""
    lib = get_lib()
    if lib is None:
        raise StreamError("native codec shim not built")
    r = lib.ffs_encoder_rate(codec.encode(), want)
    if r < 0:
        raise StreamError("encoder %s not available" % codec)
    return r


def probe(filename: str) -> Dict[str, str]:
    """Best-audio-stream parameters as a key->value dict."""
    lib = get_lib()
    if lib is None:
        raise StreamError("native codec shim not built")
    out = ctypes.create_string_buffer(4096)
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.ffs_probe(filename.encode(), out, len(out), err, _ERRLEN)
    if rc < 0:
        raise StreamError("probe %s: %s"
                          % (filename, err.value.decode(errors="replace")))
    params: Dict[str, str] = {}
    for line in out.value.decode().splitlines():
        if "=" in line:
            k, v = line.split("=", 1)
            params[k] = v
    return params


def payload_stats(filename: str):
    """(compressed_bytes, samples, rate) of the audio stream — without
    decoding; accepts single files or m3u8 playlists (hls demuxer)."""
    lib = get_lib()
    if lib is None:
        raise StreamError("native codec shim not built")
    nbytes = ctypes.c_longlong()
    samples = ctypes.c_longlong()
    rate = ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.ffs_payload_stats(filename.encode(), ctypes.byref(nbytes),
                               ctypes.byref(samples), ctypes.byref(rate),
                               err, _ERRLEN)
    if rc != 0:
        raise StreamError("payload stats %s: %s"
                          % (filename, err.value.decode(errors="replace")))
    return nbytes.value, samples.value, rate.value


def encode_file(filename: str, fmt: str, codec: str, samples: np.ndarray,
                n_channels: int, rate: int, bit_rate: int = 0):
    """Encode interleaved float32 PCM to a compressed file."""
    lib = get_lib()
    if lib is None:
        raise StreamError("native codec shim not built")
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    n_frames = samples.size // n_channels
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.ffs_encode(
        filename.encode(), fmt.encode(), codec.encode(), rate, n_channels,
        bit_rate, samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_frames, err, _ERRLEN)
    if rc != 0:
        raise StreamError("encode %s: %s"
                          % (filename, err.value.decode(errors="replace")))


def stream_counts(filename: str):
    """(n_audio, n_video) streams (attached pictures excluded)."""
    lib = get_lib()
    if lib is None:
        raise StreamError("native codec shim not built")
    na = ctypes.c_int()
    nv = ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.ffs_stream_counts(filename.encode(), ctypes.byref(na),
                             ctypes.byref(nv), err, _ERRLEN) != 0:
        raise StreamError("stream counts %s: %s"
                          % (filename, err.value.decode(errors="replace")))
    return na.value, nv.value


def remux_audio(in_path: str, audio_path: str, out_path: str):
    """Copy video/subtitle streams of in_path, replacing the audio with a
    fresh encode of audio_path at the original codec/bit rate (the
    reference videowmark's merge step)."""
    lib = get_lib()
    if lib is None:
        raise StreamError("native codec shim not built")
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.ffr_remux_audio(in_path.encode(), audio_path.encode(),
                           out_path.encode(), err, _ERRLEN) != 0:
        raise StreamError("remux %s: %s"
                          % (out_path, err.value.decode(errors="replace")))


def make_test_video(path: str, seconds: float, rate: int = 44100,
                    channels: int = 2, ts_offset: float = 0.0):
    """Synthetic mpeg4+aac clip (fixture for videowmark tests).

    ts_offset > 0 shifts every stream's timestamps (muxer output_ts_offset)
    — models TS captures whose streams start at nonzero dts."""
    lib = get_lib()
    if lib is None:
        raise StreamError("native codec shim not built")
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.ffv_make_test_video(path.encode(), seconds, rate, channels,
                               ts_offset, err, _ERRLEN) != 0:
        raise StreamError("test video %s: %s"
                          % (path, err.value.decode(errors="replace")))


def drain_stream(stream) -> np.ndarray:
    """Read an input stream to EOF; returns the interleaved samples."""
    chunks = []
    while True:
        block = stream.read_frames(65536)
        if block.size == 0:
            break
        chunks.append(block)
    return (np.concatenate(chunks) if chunks
            else np.zeros(0, np.float32))


def decode_file(filename: str, fmt: Optional[str] = None):
    """Decode a whole file; returns (samples, n_channels, rate)."""
    stream = FFInputStream(filename, fmt=fmt)
    try:
        return drain_stream(stream), stream.n_channels(), stream.sample_rate()
    finally:
        stream.close()


class FFInputStream(AudioInputStream):
    """Streaming decode via the native libav shim.

    Total frame count is unknown up front (compressed containers only carry
    estimates), like the reference's pipe inputs; bit depth reports the
    codec's raw sample size, or 24 for lossy codecs — matching libsndfile's
    vorbis behavior in the reference (src/sfinputstream.cc:137-144).
    """

    def __init__(self, filename: str, fmt: Optional[str] = None):
        lib = get_lib()
        if lib is None:
            raise StreamError(
                "audiowmark: cannot decode %s: native codec shim "
                "(native/libffshim.so) not built" % filename)
        err = ctypes.create_string_buffer(_ERRLEN)
        self._h = lib.ffs_open(filename.encode(),
                               fmt.encode() if fmt else None, err, _ERRLEN)
        if not self._h:
            raise StreamError("audiowmark: open %s: %s"
                              % (filename,
                                 err.value.decode(errors="replace")))
        self._lib = lib
        self._rate = lib.ffs_rate(self._h)
        self._channels = lib.ffs_channels(self._h)
        self._bit_depth = lib.ffs_bit_depth(self._h)
        name = ctypes.create_string_buffer(64)
        lib.ffs_codec_name(self._h, name, len(name))
        self.codec_name = name.value.decode()
        self.bit_rate = int(lib.ffs_bit_rate(self._h))

    def bit_depth(self) -> int:
        return self._bit_depth

    def sample_rate(self) -> int:
        return self._rate

    def n_channels(self) -> int:
        return self._channels

    def n_frames(self):
        return None

    def read_frames(self, count: int) -> np.ndarray:
        out = np.empty(count * self._channels, dtype=np.float32)
        got = self._lib.ffs_read(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            count)
        if got < 0:
            raise StreamError("audiowmark: decode error")
        return out[:got * self._channels]

    def close(self):
        if self._h:
            self._lib.ffs_close(self._h)
            self._h = None


def ff_detect(filename: str) -> bool:
    """True when the shim can open an audio stream in the file."""
    lib = get_lib()
    if lib is None or filename == "-":
        return False
    err = ctypes.create_string_buffer(_ERRLEN)
    h = lib.ffs_open(filename.encode(), None, err, _ERRLEN)
    if not h:
        return False
    lib.ffs_close(h)
    return True


class HLSSegmentWriter:
    """AAC -> MPEG-TS segment writer (reference: src/hlsoutputstream.cc).

    Encodes pushed float32 frames with the native AAC encoder, drops
    `cut_aac_frames` 1024-sample lead-in frames (plus the encoder's priming
    packets), keeps `keep_aac_frames`, and muxes to MPEG-TS with
    presentation timestamps starting at `pts_start` seconds.
    """

    def __init__(self, filename: str, rate: int, n_channels: int,
                 bit_rate: int, cut_aac_frames: int, keep_aac_frames: int,
                 pts_start: float, channel_layout: str = ""):
        lib = get_lib()
        if lib is None:
            raise StreamError("native codec shim not built")
        err = ctypes.create_string_buffer(_ERRLEN)
        self._h = lib.ffh_open(filename.encode(), rate, n_channels,
                               bit_rate, cut_aac_frames, keep_aac_frames,
                               pts_start, channel_layout.encode(),
                               err, _ERRLEN)
        if not self._h:
            raise StreamError("hls open %s: %s"
                              % (filename,
                                 err.value.decode(errors="replace")))
        self._lib = lib
        self._channels = n_channels

    def write(self, samples: np.ndarray):
        samples = np.ascontiguousarray(samples, dtype=np.float32)
        n = samples.size // self._channels
        got = self._lib.ffh_write(
            self._h, samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n)
        if got < 0:
            raise StreamError("hls encode error")

    def close(self):
        if self._h:
            err = ctypes.create_string_buffer(_ERRLEN)
            rc = self._lib.ffh_close(self._h, err, _ERRLEN)
            self._h = None
            if rc != 0:
                raise StreamError("hls close: %s"
                                  % err.value.decode(errors="replace"))

"""MP3 input via libmpg123 (ctypes) — the decoder library the reference
links (reference: src/mp3inputstream.cc).

* detect: decode 30 frames successfully through a feed handle
  (src/mp3inputstream.cc:208-275), with a cheap header-sync prefilter so
  non-MPEG files never spin up a decoder handle.
* open: force float32 output at all MPEG rates, `mpg123_scan` for the exact
  length, then zero-pad/truncate to the promised frame count on read
  (src/mp3inputstream.cc:67-151); bit_depth reported as 24.

If libmpg123 is absent the header sniff still recognizes MP3 files and a
clear StreamError explains the missing decoder.
"""

from __future__ import annotations

import struct

import numpy as np

from .streams import AudioInputStream, StreamError
from . import mpg123

_BITRATES_V1L3 = [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 0]
_RATES_V1 = [44100, 48000, 32000, 0]


def _parse_frame_header(b: bytes):
    """Return (frame_bytes, sample_rate, channels) or None for a bad header."""
    if len(b) < 4:
        return None
    h = struct.unpack(">I", b[:4])[0]
    if (h >> 21) & 0x7FF != 0x7FF:
        return None
    version = (h >> 19) & 3      # 3=MPEG1, 2=MPEG2, 0=MPEG2.5
    layer = (h >> 17) & 3        # 1=III, 2=II, 3=I
    if version == 1 or layer == 0:
        return None
    bitrate_idx = (h >> 12) & 0xF
    rate_idx = (h >> 10) & 3
    if bitrate_idx in (0, 15) or rate_idx == 3:
        return None
    padding = (h >> 9) & 1
    channels = 1 if ((h >> 6) & 3) == 3 else 2
    rate = _RATES_V1[rate_idx]
    if version == 2:
        rate //= 2
    elif version == 0:
        rate //= 4
    bitrate = _BITRATES_V1L3[bitrate_idx] * 1000
    if layer == 3:  # layer I
        frame = (12 * bitrate // rate + padding) * 4
    else:
        spf = 1152 if (layer == 1 and version == 3) else (576 if layer == 1 else 1152)
        frame = spf * bitrate // (8 * rate) + padding
    if frame <= 0:
        return None
    return frame, rate, channels


def _header_sniff(filename: str) -> bool:
    """Cheap consistent-frame-run check (no decoder handle)."""
    try:
        with open(filename, "rb") if filename != "-" else _no_stdin() as f:
            data = f.read(256 * 1024)
    except (OSError, TypeError):
        return False
    pos = 0
    # skip ID3v2 tag
    if data[:3] == b"ID3" and len(data) > 10:
        size = ((data[6] & 0x7F) << 21 | (data[7] & 0x7F) << 14 |
                (data[8] & 0x7F) << 7 | (data[9] & 0x7F))
        pos = 10 + size
    good = 0
    while pos + 4 <= len(data) and good < 30:
        info = _parse_frame_header(data[pos:pos + 4])
        if info is None:
            return False
        pos += info[0]
        good += 1
    return good >= 4


def mp3_detect(filename: str) -> bool:
    """True if the file decodes as MPEG audio: 30 frames through a feed
    handle like the reference (src/mp3inputstream.cc:208-275); falls back
    to the header sniff when libmpg123 is absent so the factory can still
    route to the clear missing-decoder error."""
    if not _header_sniff(filename):
        return False
    if not mpg123.available():
        return True
    try:
        dec = mpg123.Mpg123()
    except mpg123.Mpg123Error:
        return True
    try:
        dec.open_feed()
        reads = 0
        saw_format = False
        with open(filename, "rb") as f:
            while reads < 30:
                rc, data = dec.read(16384)
                if rc == mpg123.NEW_FORMAT:
                    saw_format = True
                    continue
                if rc == mpg123.DONE:
                    return True
                if rc == mpg123.NEED_MORE:
                    chunk = f.read(16384)
                    if not chunk:
                        # end of input without a decode error: the
                        # reference returns true on MPG123_DONE, so short
                        # valid files (< 30 reads) pass — but only once the
                        # decoder has locked a format (its mpg123_getformat
                        # gate, src/mp3inputstream.cc:252-266); a file the
                        # resync never locks onto must fall through to the
                        # next input probe
                        return saw_format or reads > 0
                    dec.feed(chunk)
                    continue
                if rc != mpg123.OK:
                    return False
                reads += 1
        return True
    except (OSError, mpg123.Mpg123Error):
        return False
    finally:
        dec.delete()


class _no_stdin:
    def __enter__(self):
        raise TypeError("mp3 detect does not support stdin")

    def __exit__(self, *a):
        return False


class MP3InputStream(AudioInputStream):
    """libmpg123 decode forced to float32, exact-length scan, zero-padding
    to the promised frame count (reference: src/mp3inputstream.cc)."""

    def __init__(self, filename: str):
        if not mpg123.available():
            raise StreamError(
                "input looks like an MP3 file, but no MP3 decoder is "
                "available (libmpg123 not found)")
        if filename == "-":
            raise StreamError("MP3 input from stdin is not supported")
        try:
            self._dec = mpg123.Mpg123()
            self._dec.open(filename)
            rate, channels, _enc = self._dec.getformat()
            n = self._dec.scan_length()
        except mpg123.Mpg123Error as e:
            raise StreamError(str(e))
        if n is None:
            raise StreamError("unable to determine MP3 length")
        self._sample_rate = int(rate)
        self._n_channels = int(channels)
        self._n_frames = int(n)
        self._frames_left = int(n)
        self._rest = b""

    def bit_depth(self) -> int:
        return 24  # mpg123 float decode is reported as 24 bit by the reference

    def sample_rate(self) -> int:
        return self._sample_rate

    def n_channels(self) -> int:
        return self._n_channels

    def n_frames(self):
        return self._n_frames

    def read_frames(self, count: int) -> np.ndarray:
        count = min(count, self._frames_left)
        if count <= 0:
            return np.zeros(0, dtype=np.float32)
        bpf = 4 * self._n_channels
        want = count * bpf
        chunks = [self._rest[:want]]
        got = len(chunks[0])
        self._rest = self._rest[want:]
        eof = False
        while got < want:
            rc, data = self._dec.read(max(want - got, 16384))
            if rc == mpg123.NEW_FORMAT:
                continue
            if data:
                take = min(len(data), want - got)
                chunks.append(data[:take])
                self._rest += data[take:]
                got += take
            if rc == mpg123.DONE:
                eof = True
                break
            if rc not in (mpg123.OK, mpg123.NEED_MORE):
                raise StreamError("MP3 decode error (%d)" % rc)
            if rc == mpg123.NEED_MORE and not data:
                eof = True
                break
        buf = b"".join(chunks)
        if eof and len(buf) < want:
            # zero-pad to the promised frame count
            # (reference: src/mp3inputstream.cc:145-151)
            buf += b"\x00" * (want - len(buf))
        n_whole = len(buf) // bpf
        self._frames_left -= n_whole
        return np.frombuffer(buf[: n_whole * bpf], dtype="<f4").astype(
            np.float32)

    def close(self):
        if self._dec is not None:
            self._dec.delete()
            self._dec = None

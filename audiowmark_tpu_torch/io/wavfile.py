"""WAV / RF64 container reader and writer (pure numpy, no libsndfile).

Reader: RIFF and RF64 (ds64 64-bit sizes), fmt chunks for PCM 8/16/24/32,
IEEE float 32/64 and WAVE_FORMAT_EXTENSIBLE; unknown chunks skipped.  Integer
PCM is normalized through a 32-bit container * 2^-31 exactly like the
reference's manual int API normalization (src/sfinputstream.cc:189-210).

Writer: WAV or RF64, PCM 16/24/32 or float 32/64.  Sample quantization is
trunc-clip(f * 2^31) to the 32-bit container, then the top bits — identical
to the reference's float_to_int_clip<32> + libsndfile int write path.

Both work on non-seekable streams: the reader parses sequentially; the writer
patches sizes on close when the target is seekable and otherwise needs the
frame count up front.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Optional

import numpy as np

from ..params import Encoding
from .converters import _NORM, float_clip, float_to_int_clip32

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE

_KSDATAFORMAT_PCM = bytes.fromhex("0100000000001000800000aa00389b71")
_KSDATAFORMAT_FLOAT = bytes.fromhex("0300000000001000800000aa00389b71")


class WavParseError(Exception):
    pass


@dataclass
class WavInfo:
    n_channels: int
    sample_rate: int
    bit_depth: int          # container bits (8/16/24/32/64)
    encoding: Encoding      # SIGNED (PCM>8), UNSIGNED (PCM8), FLOAT
    data_size: Optional[int]  # bytes; None = unknown (stream until EOF)
    n_frames: Optional[int]

    @property
    def bytes_per_frame(self) -> int:
        return self.n_channels * (self.bit_depth // 8)


def _read_exact(f: BinaryIO, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            raise WavParseError("unexpected end of file in WAV header")
        buf += chunk
    return buf


def parse_header(f: BinaryIO, ignore_data_size: bool = False) -> WavInfo:
    """Parse RIFF/RF64 chunks up to the start of the data chunk."""
    riff = _read_exact(f, 4)
    if riff not in (b"RIFF", b"RF64"):
        raise WavParseError("input file is not a supported audio file")
    _riff_size = struct.unpack("<I", _read_exact(f, 4))[0]
    wave = _read_exact(f, 4)
    if wave != b"WAVE":
        raise WavParseError("input file is not a valid wav file")

    ds64_data_size = None
    fmt = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            raise WavParseError("wav file has no data chunk")
        cid, csize = struct.unpack("<4sI", hdr)
        if cid == b"ds64":
            body = _read_exact(f, csize + (csize & 1))
            if csize < 16:
                raise WavParseError("bad ds64 chunk")
            _rsize, ds64_data_size = struct.unpack("<QQ", body[:16])
        elif cid == b"fmt ":
            body = _read_exact(f, csize + (csize & 1))
            if csize < 16:
                raise WavParseError("bad fmt chunk")
            (tag, channels, rate, _brate, _balign, bits) = struct.unpack(
                "<HHIIHH", body[:16])
            if tag == WAVE_FORMAT_EXTENSIBLE:
                if csize < 40:
                    raise WavParseError("bad extensible fmt chunk")
                guid = body[24:40]
                if guid == _KSDATAFORMAT_PCM:
                    tag = WAVE_FORMAT_PCM
                elif guid == _KSDATAFORMAT_FLOAT:
                    tag = WAVE_FORMAT_IEEE_FLOAT
                else:
                    raise WavParseError("unsupported extensible wav subformat")
            fmt = (tag, channels, rate, bits)
        elif cid == b"data":
            if fmt is None:
                raise WavParseError("wav file has data before fmt chunk")
            tag, channels, rate, bits = fmt
            if tag == WAVE_FORMAT_PCM:
                if bits not in (8, 16, 24, 32):
                    raise WavParseError("unsupported PCM bit depth %d" % bits)
                enc = Encoding.UNSIGNED if bits == 8 else Encoding.SIGNED
            elif tag == WAVE_FORMAT_IEEE_FLOAT:
                if bits not in (32, 64):
                    raise WavParseError("unsupported float bit depth %d" % bits)
                enc = Encoding.FLOAT
            else:
                raise WavParseError("unsupported wav format tag 0x%04x" % tag)
            data_size: Optional[int] = csize
            if csize == 0xFFFFFFFF and ds64_data_size is not None:
                data_size = ds64_data_size
            if ignore_data_size or csize == 0xFFFFFFFF and ds64_data_size is None:
                data_size = None
            if channels < 1 or rate < 1:
                raise WavParseError("invalid wav fmt chunk "
                                    "(%d channels, rate %d)" % (channels, rate))
            bpf = channels * (bits // 8)
            n_frames = None if data_size is None else data_size // bpf
            return WavInfo(channels, rate, bits, enc, data_size, n_frames)
        else:
            # skip unknown chunk (word aligned)
            skip = csize + (csize & 1)
            while skip > 0:
                chunk = f.read(min(skip, 1 << 20))
                if not chunk:
                    raise WavParseError("unexpected end of file in WAV chunks")
                skip -= len(chunk)


def decode_samples(data: bytes, info: WavInfo) -> np.ndarray:
    """Raw data bytes -> interleaved float32 samples."""
    bits, enc = info.bit_depth, info.encoding
    width = bits // 8
    n = len(data) // width
    data = data[: n * width]
    if enc == Encoding.FLOAT:
        dt = "<f4" if bits == 32 else "<f8"
        return np.frombuffer(data, dtype=dt).astype(np.float32)
    if bits == 16:
        s = np.frombuffer(data, dtype="<i2").astype(np.int32) << 16
    elif bits == 32:
        s = np.frombuffer(data, dtype="<i4")
    elif bits == 24:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(n, 3)
        u = (raw[:, 0].astype(np.uint32) << 8 |
             raw[:, 1].astype(np.uint32) << 16 |
             raw[:, 2].astype(np.uint32) << 24)
        s = u.view(np.int32)
    else:  # 8-bit unsigned
        u = np.frombuffer(data, dtype=np.uint8).astype(np.uint32) << 24
        u ^= np.uint32(0x80000000)
        s = u.view(np.int32)
    return s.astype(np.float32) * _NORM


def encode_samples(samples: np.ndarray, bit_depth: int,
                   encoding: Encoding) -> bytes:
    """Interleaved float32 samples -> raw data bytes."""
    if encoding == Encoding.FLOAT:
        f = float_clip(samples)
        return f.astype("<f4" if bit_depth == 32 else "<f8").tobytes()
    s = float_to_int_clip32(samples)
    u = s.view(np.uint32)
    if bit_depth == 16:
        return (s >> 16).astype("<i2").tobytes()
    if bit_depth == 32:
        return s.astype("<i4").tobytes()
    if bit_depth == 24:
        out = np.empty((u.size, 3), dtype=np.uint8)
        out[:, 0] = (u >> 8) & 0xFF
        out[:, 1] = (u >> 16) & 0xFF
        out[:, 2] = (u >> 24) & 0xFF
        return out.tobytes()
    raise ValueError("unsupported output bit depth %d" % bit_depth)


def build_header(n_channels: int, sample_rate: int, bit_depth: int,
                 encoding: Encoding, data_size: int, rf64: bool) -> bytes:
    """Build a complete WAV/RF64 header up to the start of sample data."""
    tag = WAVE_FORMAT_IEEE_FLOAT if encoding == Encoding.FLOAT else WAVE_FORMAT_PCM
    bpf = n_channels * bit_depth // 8
    fmt_body = struct.pack("<HHIIHH", tag, n_channels, sample_rate,
                           sample_rate * bpf, bpf, bit_depth)
    chunks = b""
    if rf64:
        n_frames = data_size // bpf if bpf else 0
        ds64 = struct.pack("<QQQI", 0, data_size, n_frames, 0)
        chunks += struct.pack("<4sI", b"ds64", len(ds64)) + ds64
    chunks += struct.pack("<4sI", b"fmt ", len(fmt_body)) + fmt_body
    if tag == WAVE_FORMAT_IEEE_FLOAT:
        chunks += struct.pack("<4sII", b"fact", 4,
                              (data_size // bpf) & 0xFFFFFFFF if bpf else 0)
    data_hdr = struct.pack(
        "<4sI", b"data", 0xFFFFFFFF if rf64 else data_size & 0xFFFFFFFF)
    # odd-sized data chunks get a pad byte (written by the caller on close),
    # which counts toward the RIFF chunk size
    riff_size = 4 + len(chunks) + len(data_hdr) + data_size + (data_size & 1)
    if rf64:
        hdr = struct.pack("<4sI4s", b"RF64", 0xFFFFFFFF, b"WAVE")
        # patch riff size into ds64
        chunks = bytearray(chunks)
        struct.pack_into("<Q", chunks, 8, riff_size)
        chunks = bytes(chunks)
    else:
        hdr = struct.pack("<4sI4s", b"RIFF", riff_size & 0xFFFFFFFF, b"WAVE")
    return hdr + chunks + data_hdr


class WavFileWriter:
    """Streamed WAV/RF64 writer; patches sizes on close for seekable files."""

    def __init__(self, f: BinaryIO, n_channels: int, sample_rate: int,
                 bit_depth: int, encoding: Encoding, rf64: bool = False,
                 expected_frames: Optional[int] = None):
        if bit_depth < 16:
            bit_depth, encoding = 16, Encoding.SIGNED
        self.f = f
        self.n_channels = n_channels
        self.sample_rate = sample_rate
        self.bit_depth = bit_depth
        self.encoding = encoding
        self.rf64 = rf64
        self.data_bytes = 0
        self._bpf = n_channels * bit_depth // 8
        expected_size = (expected_frames or 0) * self._bpf
        self._header = build_header(n_channels, sample_rate, bit_depth,
                                    encoding, expected_size, rf64)
        f.write(self._header)

    def write_frames(self, samples: np.ndarray):
        samples = np.asarray(samples)
        if (samples.dtype == np.int16 and self.bit_depth == 16
                and self.encoding == Encoding.SIGNED):
            # pre-quantized device output: bytes go straight through (the
            # f32 round trip + trunc-clip re-quantization reproduces these
            # exact values, so skipping it is bit-identical and saves ~6
            # full-array passes on multi-minute files)
            data = samples.astype("<i2", copy=False).tobytes()
        else:
            data = encode_samples(samples.astype(np.float32, copy=False),
                                  self.bit_depth, self.encoding)
        self.f.write(data)
        self.data_bytes += len(data)

    def close(self):
        if self.data_bytes & 1:
            self.f.write(b"\x00")
        if self.f.seekable():
            hdr = build_header(self.n_channels, self.sample_rate,
                               self.bit_depth, self.encoding,
                               self.data_bytes, self.rf64)
            self.f.seek(0)
            self.f.write(hdr)
            self.f.seek(0, 2)
        self.f.flush()

"""Audio input/output streams + factories.

Mirrors the reference's polymorphic stream layer (src/audiostream.{hh,cc}):

* input AUTO: WAV/RF64 parser (with MP3 detect fallback — gated, see
  mp3.py), RAW: headerless PCM, WAV_PIPE: streaming WAV parser ignoring
  bogus pipe length headers.
* output: RAW, stdout-WAV (non-seekable; 0xFFFFFFFF sizes in wav-pipe
  mode), or WAV/RF64 files.

All streams speak interleaved float32 frames.
"""

from __future__ import annotations

import struct
import sys
from typing import BinaryIO, Optional

import numpy as np

from ..params import Encoding, Format, Params, RawFormat
from ..utils.log import warning
from .converters import RawConverter
from . import wavfile
from .wavfile import WavInfo, WavParseError

N_FRAMES_UNKNOWN = None


class StreamError(Exception):
    """I/O error in an audio stream (the reference's Error value type)."""


class AudioInputStream:
    def bit_depth(self) -> int:
        raise NotImplementedError

    def sample_rate(self) -> int:
        raise NotImplementedError

    def n_channels(self) -> int:
        raise NotImplementedError

    def n_frames(self) -> Optional[int]:
        raise NotImplementedError

    def encoding(self) -> Encoding:
        return Encoding.SIGNED

    def read_frames(self, count: int) -> np.ndarray:
        """Read up to `count` frames; shorter result only at EOF."""
        raise NotImplementedError

    def close(self):
        pass


class AudioOutputStream:
    def sample_rate(self) -> int:
        raise NotImplementedError

    def n_channels(self) -> int:
        raise NotImplementedError

    def write_frames(self, samples: np.ndarray):
        raise NotImplementedError

    def close(self):
        pass


# ---- WAV file input ---------------------------------------------------------

class WavInputStream(AudioInputStream):
    """WAV/RF64 input from a file or stdin (the reference's SFInputStream)."""

    def __init__(self, filename: str, ignore_data_size: bool = False):
        self._own_file = filename != "-"
        self.f: BinaryIO = (open(filename, "rb") if self._own_file
                            else sys.stdin.buffer)
        try:
            self.info: WavInfo = wavfile.parse_header(
                self.f, ignore_data_size=ignore_data_size)
        except WavParseError:
            if self._own_file:
                self.f.close()
            raise
        self._remaining = self.info.data_size
        self._is_stdin = not self._own_file

    def bit_depth(self) -> int:
        return self.info.bit_depth

    def sample_rate(self) -> int:
        return self.info.sample_rate

    def n_channels(self) -> int:
        return self.info.n_channels

    def n_frames(self):
        return self.info.n_frames

    def encoding(self) -> Encoding:
        return (Encoding.FLOAT if self.info.encoding == Encoding.FLOAT
                else Encoding.SIGNED)

    def read_frames(self, count: int) -> np.ndarray:
        bpf = self.info.bytes_per_frame
        want = count * bpf
        if self._remaining is not None:
            want = min(want, self._remaining)
        data = b""
        while len(data) < want:
            chunk = self.f.read(want - len(data))
            if not chunk:
                break
            data += chunk
        if self._remaining is not None:
            self._remaining -= len(data)
        n_whole = len(data) // bpf * bpf
        return wavfile.decode_samples(data[:n_whole], self.info)

    def close(self):
        if self._own_file:
            self.f.close()
        elif self._is_stdin:
            # drain remaining stdin to avoid SIGPIPE upstream
            # (reference: src/sfinputstream.cc:226-239)
            while self.f.read(1 << 16):
                pass


class WavPipeInputStream(WavInputStream):
    """Streaming WAV for pipes with bogus length headers: reads the data
    chunk until real EOF, ignoring the declared size
    (reference: src/wavpipeinputstream.cc:70-235)."""

    def __init__(self, filename: str):
        super().__init__(filename, ignore_data_size=True)


# ---- WAV file output --------------------------------------------------------

class WavOutputStream(AudioOutputStream):
    def __init__(self, filename: str, n_channels: int, sample_rate: int,
                 bit_depth: int, encoding: Encoding, rf64: bool,
                 expected_frames: Optional[int]):
        self._own_file = filename != "-"
        f = open(filename, "wb") if self._own_file else sys.stdout.buffer
        self.writer = wavfile.WavFileWriter(
            f, n_channels, sample_rate, bit_depth, encoding, rf64,
            expected_frames)

    def sample_rate(self) -> int:
        return self.writer.sample_rate

    def n_channels(self) -> int:
        return self.writer.n_channels

    def bit_depth(self) -> int:
        return self.writer.bit_depth

    def write_frames(self, samples: np.ndarray):
        self.writer.write_frames(samples)

    def close(self):
        self.writer.close()
        if self._own_file:
            self.writer.f.close()


class StdoutWavOutputStream(AudioOutputStream):
    """WAV to stdout without seeking (reference: src/stdoutwavoutputstream.cc):
    plain fmt-16 header; sizes are real (length known) or 0xFFFFFFFF in
    wav-pipe mode; odd data size padded with one zero byte on close."""

    def __init__(self, n_channels: int, sample_rate: int, bit_depth: int,
                 encoding: Encoding, n_frames: Optional[int], wav_pipe: bool):
        if encoding == Encoding.FLOAT:
            if bit_depth not in (32, 64):
                raise StreamError("unsupported floating point bit depth %d" % bit_depth)
        elif bit_depth not in (16, 24, 32):
            raise StreamError("unsupported bit depth %d" % bit_depth)
        if n_frames is None and not wav_pipe:
            raise StreamError("unable to write wav format to standard out "
                              "without input length information")
        self._n_channels = n_channels
        self._sample_rate = sample_rate
        self._bit_depth = bit_depth
        self._encoding = encoding
        self.f = sys.stdout.buffer

        data_size = (n_frames or 0) * n_channels * ((bit_depth + 7) // 8)
        self._close_padding = data_size & 1
        aligned = data_size + self._close_padding
        hdr = bytearray()
        hdr += b"RIFF"
        hdr += struct.pack("<I", 0xFFFFFFFF if wav_pipe else (36 + aligned))
        hdr += b"WAVE"
        hdr += b"fmt " + struct.pack(
            "<IHHIIHH", 16, 3 if encoding == Encoding.FLOAT else 1,
            n_channels, sample_rate,
            sample_rate * n_channels * bit_depth // 8,
            n_channels * bit_depth // 8, bit_depth)
        hdr += b"data" + struct.pack(
            "<I", 0xFFFFFFFF if wav_pipe else data_size & 0xFFFFFFFF)
        self.f.write(bytes(hdr))

    def sample_rate(self) -> int:
        return self._sample_rate

    def n_channels(self) -> int:
        return self._n_channels

    def bit_depth(self) -> int:
        return self._bit_depth

    def write_frames(self, samples: np.ndarray):
        self.f.write(wavfile.encode_samples(
            np.asarray(samples, dtype=np.float32),
            self._bit_depth, self._encoding))

    def close(self):
        for _ in range(self._close_padding):
            self.f.write(b"\x00")
        self.f.flush()


# ---- raw streams ------------------------------------------------------------

class RawInputStream(AudioInputStream):
    def __init__(self, filename: str, fmt: RawFormat):
        if fmt.sample_rate() == 0:
            raise StreamError("raw input sample rate is missing")
        self.fmt = fmt
        self.conv = RawConverter(fmt)
        self._own_file = filename != "-"
        self.f = open(filename, "rb") if self._own_file else sys.stdin.buffer

    def bit_depth(self) -> int:
        return self.fmt.bit_depth()

    def sample_rate(self) -> int:
        return self.fmt.sample_rate()

    def n_channels(self) -> int:
        return self.fmt.n_channels()

    def n_frames(self):
        return N_FRAMES_UNKNOWN

    def encoding(self) -> Encoding:
        return self.fmt.encoding()

    def read_frames(self, count: int) -> np.ndarray:
        bpf = self.fmt.n_channels() * self.fmt.bit_depth() // 8
        want = count * bpf
        data = b""
        while len(data) < want:
            chunk = self.f.read(want - len(data))
            if not chunk:
                break
            data += chunk
        n_whole = len(data) // bpf * bpf
        return self.conv.from_raw(data[:n_whole])

    def close(self):
        if self._own_file:
            self.f.close()


class RawOutputStream(AudioOutputStream):
    def __init__(self, filename: str, fmt: RawFormat):
        if fmt.sample_rate() == 0:
            raise StreamError("raw output sample rate is missing")
        self.fmt = fmt
        self.conv = RawConverter(fmt)
        self._own_file = filename != "-"
        self.f = open(filename, "wb") if self._own_file else sys.stdout.buffer

    def sample_rate(self) -> int:
        return self.fmt.sample_rate()

    def n_channels(self) -> int:
        return self.fmt.n_channels()

    def bit_depth(self) -> int:
        return self.fmt.bit_depth()

    def write_frames(self, samples: np.ndarray):
        self.f.write(self.conv.to_raw(np.asarray(samples, dtype=np.float32)))

    def close(self):
        self.f.flush()
        if self._own_file:
            self.f.close()


# ---- factories --------------------------------------------------------------

def create_input_stream(filename: str) -> AudioInputStream:
    """Input factory (reference: src/audiostream.cc:34-79)."""
    if Params.input_format == Format.AUTO:
        try:
            return WavInputStream(filename)
        except WavParseError as e:
            from .flac import flac_detect, FlacInputStream
            if filename != "-" and flac_detect(filename):
                return FlacInputStream(filename)
            from .vorbis import ogg_detect, OggVorbisInputStream
            if filename != "-" and ogg_detect(filename):
                return OggVorbisInputStream(filename)
            from .mp3 import mp3_detect, MP3InputStream
            if mp3_detect(filename):
                return MP3InputStream(filename)
            # fallback: native libav shim decodes the remaining formats the
            # reference reads via libsndfile — Opus, ALAC, AAC/M4A, MPEG-TS
            # (reference: src/sfinputstream.cc:75-149)
            from .ffshim import ff_detect, FFInputStream
            if ff_detect(filename):
                return FFInputStream(filename)
            raise StreamError(str(e))
    elif Params.input_format == Format.RAW:
        return RawInputStream(filename, Params.raw_input_format)
    elif Params.input_format == Format.WAV_PIPE:
        return WavPipeInputStream(filename)
    raise StreamError("selected format is not supported as input format")


def create_output_stream(filename: str, n_channels: int, sample_rate: int,
                         bit_depth: int, encoding: Encoding,
                         n_frames: Optional[int]) -> AudioOutputStream:
    """Output factory (reference: src/audiostream.cc:82-121)."""
    if Params.output_format == Format.RAW:
        return RawOutputStream(filename, Params.raw_output_format)
    if filename == "-":
        wav_pipe = Params.output_format == Format.WAV_PIPE
        return StdoutWavOutputStream(n_channels, sample_rate, bit_depth,
                                     encoding, n_frames, wav_pipe)
    rf64 = Params.output_format == Format.RF64
    return WavOutputStream(filename, n_channels, sample_rate, bit_depth,
                           encoding, rf64, n_frames)

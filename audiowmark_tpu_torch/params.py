"""Global watermarking parameters.

Mirrors the semantics of the reference `Params` singleton
(reference: src/wmcommon.hh:33-89, src/wmcommon.cc:27-58): a set of constants
defining the watermark geometry plus mutable knobs set by the CLI.

The mutable knobs live as class attributes on `Params` so library code and the
CLI share one source of truth, like the reference's static members.  Code that
needs a hashable/static snapshot for jit caching should use
`Params.snapshot()`.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class Format(Enum):
    AUTO = 1
    RAW = 2
    RF64 = 3
    WAV_PIPE = 4


class Encoding(Enum):
    SIGNED = 1
    UNSIGNED = 2
    FLOAT = 3


class RawFormat:
    """Raw stream format (reference: src/rawinputstream.hh:28-56).

    Defaults: 2 channels, 16 bit, little endian, signed; sample rate is
    mandatory (no default).
    """

    class Endian(Enum):
        LITTLE = 1
        BIG = 2

    def __init__(self):
        self._n_channels = 2
        self._bit_depth = 16
        self._sample_rate = 0
        self._endian = RawFormat.Endian.LITTLE
        self._encoding = Encoding.SIGNED

    def n_channels(self):
        return self._n_channels

    def bit_depth(self):
        return self._bit_depth

    def sample_rate(self):
        return self._sample_rate

    def endian(self):
        return self._endian

    def encoding(self):
        return self._encoding

    def set_channels(self, c):
        self._n_channels = c

    def set_bit_depth(self, b):
        self._bit_depth = b

    def set_sample_rate(self, r):
        self._sample_rate = r

    def set_endian(self, e):
        self._endian = e

    def set_encoding(self, e):
        self._encoding = e


class Params:
    # ---- immutable geometry (compile-time constants) ----
    frame_size = 1024
    bands_per_frame = 30
    max_band = 100
    min_band = 20

    sync_bits = 6
    sync_frames_per_bit = 85
    sync_search_step = 256
    sync_search_fine = 8

    frames_pad_start = 250
    mark_sample_rate = 44100

    limiter_block_size_ms = 1000
    limiter_ceiling = 0.99

    # ---- mutable knobs (CLI) ----
    frames_per_bit = 2
    water_delta = 0.01
    mix = True
    hard = False
    snr = False
    strict = False
    detect_speed = False
    detect_speed_patient = False
    try_speed = -1.0
    test_speed = -1.0
    sync_threshold2 = 0.35
    get_n_best = 8
    payload_size = 128
    payload_short = False
    test_cut = 0
    test_no_sync = False
    test_no_limiter = False
    test_truncate = 0
    expect_matches = -1
    get_chunk_size = 30.0
    json_output = ""
    input_label = ""
    output_label = ""
    hls_bit_rate = 0

    input_format = Format.AUTO
    output_format = Format.AUTO
    raw_input_format = RawFormat()
    raw_output_format = RawFormat()

    @classmethod
    def reset(cls):
        """Restore all mutable knobs to their defaults (used by tests/CLI)."""
        cls.frames_per_bit = 2
        cls.water_delta = 0.01
        cls.mix = True
        cls.hard = False
        cls.snr = False
        cls.strict = False
        cls.detect_speed = False
        cls.detect_speed_patient = False
        cls.try_speed = -1.0
        cls.test_speed = -1.0
        cls.sync_threshold2 = 0.35
        cls.get_n_best = 8
        cls.payload_size = 128
        cls.payload_short = False
        cls.sync_frames_per_bit = 85
        cls.test_cut = 0
        cls.test_no_sync = False
        cls.test_no_limiter = False
        cls.test_truncate = 0
        cls.expect_matches = -1
        cls.get_chunk_size = 30.0
        cls.json_output = ""
        cls.input_label = ""
        cls.output_label = ""
        cls.hls_bit_rate = 0
        cls.input_format = Format.AUTO
        cls.output_format = Format.AUTO
        cls.raw_input_format = RawFormat()
        cls.raw_output_format = RawFormat()

    @classmethod
    def snapshot(cls) -> "ParamsSnapshot":
        return ParamsSnapshot(
            frames_per_bit=cls.frames_per_bit,
            water_delta=cls.water_delta,
            mix=cls.mix,
            payload_size=cls.payload_size,
            payload_short=cls.payload_short,
            sync_threshold2=cls.sync_threshold2,
            get_n_best=cls.get_n_best,
        )


@dataclass(frozen=True)
class ParamsSnapshot:
    """Hashable snapshot of the jit-relevant knobs, usable as a cache key."""

    frames_per_bit: int
    water_delta: float
    mix: bool
    payload_size: int
    payload_short: bool
    sync_threshold2: float
    get_n_best: int

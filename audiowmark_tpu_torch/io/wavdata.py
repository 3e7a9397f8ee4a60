"""In-memory audio container (reference: src/wavdata.{hh,cc})."""

from __future__ import annotations

import numpy as np

from ..params import Encoding
from .streams import create_input_stream, create_output_stream


class WavData:
    """Interleaved float32 samples + rate/channels/bit_depth."""

    def __init__(self, samples=None, n_channels: int = 0,
                 sample_rate: int = 0, bit_depth: int = 0):
        self._samples = (np.zeros(0, dtype=np.float32) if samples is None
                         else np.asarray(samples, dtype=np.float32))
        self._n_channels = n_channels
        self._sample_rate = sample_rate
        self._bit_depth = bit_depth

    @classmethod
    def load(cls, filename: str) -> "WavData":
        in_stream = create_input_stream(filename)
        try:
            return cls.load_stream(in_stream)
        finally:
            in_stream.close()

    @classmethod
    def load_stream(cls, in_stream) -> "WavData":
        chunks = []
        while True:
            buf = in_stream.read_frames(16384)
            if buf.size == 0:
                break
            chunks.append(buf)
        samples = (np.concatenate(chunks) if chunks
                   else np.zeros(0, dtype=np.float32))
        return cls(samples, in_stream.n_channels(), in_stream.sample_rate(),
                   in_stream.bit_depth())

    def save(self, filename: str):
        encoding = Encoding.SIGNED
        bit_depth = self._bit_depth
        if bit_depth < 16:
            bit_depth = 16
        out = create_output_stream(filename, self._n_channels,
                                   self._sample_rate, bit_depth, encoding,
                                   self.n_frames)
        out.write_frames(self._samples)
        out.close()

    @property
    def sample_rate(self) -> int:
        return self._sample_rate

    @property
    def bit_depth(self) -> int:
        return self._bit_depth

    @property
    def n_channels(self) -> int:
        return self._n_channels

    @property
    def n_values(self) -> int:
        return int(self._samples.size)

    @property
    def n_frames(self) -> int:
        return int(self._samples.size) // self._n_channels if self._n_channels else 0

    @property
    def samples(self) -> np.ndarray:
        return self._samples

    def set_samples(self, samples: np.ndarray):
        self._samples = np.asarray(samples, dtype=np.float32)

    def with_samples(self, samples: np.ndarray) -> "WavData":
        return WavData(samples, self._n_channels, self._sample_rate,
                       self._bit_depth)

    def frames_2d(self) -> np.ndarray:
        """Samples as (n_frames, n_channels) view."""
        return self._samples.reshape(-1, self._n_channels)

"""Chunked loading of arbitrarily long inputs, resampled to 44.1 kHz.

Port of audiowmark_tpu/models/chunkloader.py (reference:
src/wavchunkloader.cc): default 30-minute chunks with ~134 s overlap (2 AB
blocks x 1.3 speed factor) so every block decoder result appears in exactly
one chunk's report; keeps the time offset and the total length without
knowing the input length up front.  Input at another rate goes through
ops/resample.StreamingResampler on the device, in writes of
_RESAMPLE_BLOCK frames (output frame j depends only on the input and j,
not on how the input was split into writes).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from audiowmark_tpu.io.streams import StreamError, create_input_stream
from audiowmark_tpu.io.wavdata import WavData
from audiowmark_tpu.params import Params

from ..device import DeviceLike, resolve
from ..ops.resample import StreamingResampler
from ..tables import frames_per_block

# frames per read of a 44.1 kHz input, as the reference reads
_READ_BLOCK = 4096
# 44.1 kHz frames per resampler write: large, because each write costs a
# few device launches per filter tap
_RESAMPLE_BLOCK = 1 << 18


class WavChunkLoader:
    def __init__(self, filename: str, device: DeviceLike = None):
        self.filename = filename
        self.device = resolve(device)
        self.state = "NEW"
        self.in_stream = None
        self.resampler: Optional[StreamingResampler] = None
        self.resampler_in_eof = False
        self.wav = WavData(np.zeros(0, np.float32), 0,
                           Params.mark_sample_rate, 0)
        self.max_size = 0
        self.n_overlap_samples = 0
        self.time_offset_val = 0.0
        self.n_total_samples = 0

    def _open(self):
        self.in_stream = create_input_stream(self.filename)
        self.state = "OPEN"
        self.wav = WavData(np.zeros(0, np.float32),
                           self.in_stream.n_channels(),
                           Params.mark_sample_rate,
                           self.in_stream.bit_depth())
        if self.in_stream.sample_rate() != Params.mark_sample_rate:
            self.resampler = StreamingResampler(
                self.in_stream.n_channels(), self.in_stream.sample_rate(),
                Params.mark_sample_rate, self.device)
        self.max_size = int(round(Params.get_chunk_size * 60
                                  * Params.mark_sample_rate)) \
            * self.wav.n_channels
        overlap_blocks = 2
        speed_factor = 1.3
        block_seconds = frames_per_block() * Params.frame_size \
            / float(Params.mark_sample_rate)
        self.n_overlap_samples = int(round(
            overlap_blocks * block_seconds * speed_factor
            * Params.mark_sample_rate)) * self.wav.n_channels

    def close(self):
        if self.in_stream is not None:
            self.in_stream.close()
            self.in_stream = None

    def load_next_chunk(self):
        assert self.state != "ERROR"
        if self.state == "LAST_CHUNK":
            self.state = "DONE"
            return
        if self.state == "NEW":
            self._open()

        samples = self.wav.samples
        if samples.size:
            keep = self.n_overlap_samples
            assert samples.size >= keep
            self.time_offset_val += ((samples.size - keep)
                                     // self.wav.n_channels) \
                / float(Params.mark_sample_rate)
            samples = samples[samples.size - keep:]

        samples, eof = self._refill(samples)
        self.wav.set_samples(samples)

        if eof:
            self.state = "LAST_CHUNK" if samples.size else "DONE"

        if Params.test_truncate:
            want = Params.mark_sample_rate * self.wav.n_channels \
                * Params.test_truncate
            if want > self.max_size:
                raise StreamError("test truncate must be less than chunk size")
            if want < samples.size:
                self.wav.set_samples(samples[:want])
            self.state = "LAST_CHUNK" if self.wav.samples.size else "DONE"

    def _refill(self, samples: np.ndarray):
        """Fill the chunk up to max_size; returns (samples, eof)."""
        block = _RESAMPLE_BLOCK
        chunks = [samples]
        total = samples.size
        nch = self.wav.n_channels
        while total < self.max_size:
            if self.resampler is not None:
                if (self.resampler.can_read_frames() < block
                        and not self.resampler_in_eof):
                    want = int(block * self.in_stream.sample_rate()
                               / Params.mark_sample_rate)
                    buf = self.in_stream.read_frames(want)
                    self.resampler.write_frames(buf)
                    if buf.size == 0:
                        self.resampler.write_trailing_frames()
                        self.resampler_in_eof = True
                n = min(self.resampler.can_read_frames(),
                        (self.max_size - total) // nch)
                buf = self.resampler.read_frames(n).cpu().numpy()
            else:
                n = min(_READ_BLOCK, (self.max_size - total) // nch)
                buf = self.in_stream.read_frames(n)
            if buf.size == 0:
                return np.concatenate(chunks), True
            chunks.append(buf)
            total += buf.size
            self.n_total_samples += buf.size
        return np.concatenate(chunks), False

    def done(self) -> bool:
        return self.state == "DONE"

    def wav_data(self) -> WavData:
        return self.wav

    def time_offset(self) -> float:
        return self.time_offset_val

    def length(self) -> float:
        return self.n_total_samples / float(Params.mark_sample_rate
                                            * self.wav.n_channels)

"""Deterministic test inputs, without jax.

`gen_noise` is a copy of audiowmark_tpu/cli.py's test_gen_noise (the CLI's
`test-gen-noise`): stereo noise in [-1, 1) from the key's AES-CTR keystream
on the data_up_down stream, written as a wav file.  The same key, length and
rate give the same bytes from either package.

`long_noise` is seeded uniform stereo noise for long fixtures, where the
AES-CTR keystream in numpy would take minutes.

`raw_format` and `write_wav` make the inputs of the stream cases: a raw
PCM format by name, and a WAV file in any sample format.

`acs_check_metrics` gives branch metrics that hold the Viterbi trellis's
hard cases, for checking kernel K1 against its plain version, and
`acs_equal` is that check.

`limiter_signal` is seeded noise whose level changes by the limiter's
block, and `limiters_apart` holds the streaming limiter on the device to
the numpy one on it.  `MemoryInput` and `MemoryWav` are in-memory streams
for the streaming add, and `TileRecorder` with `host_finish` is the plain
form of its finish: what the add computed on the device for each tile,
mixed, limited and encoded on the host as the add did before it finished
tiles on the device.  `add_and_host_finish` runs both on one input.
"""

from __future__ import annotations

import io
import math
from typing import Optional

import numpy as np
import torch

from .crypto import aes
from .crypto.keys import Key
from .crypto.prng import Random, Stream
from .io import wavfile
from .io.converters import RawConverter
from .io.streams import AudioInputStream, AudioOutputStream
from .io.wavdata import WavData
from .params import Encoding, Params, RawFormat

from .codec.convcode import (ConvBlockType, _state_output_table,
                             batch_branch_metrics, conv_encode)
from .models.decoder import normalize_soft_bits
from .ops.viterbi import ORDER, STATE_COUNT


def raw_format(encoding: str, bits: int, endian: str = "little",
               rate: int = 44100) -> RawFormat:
    """The stereo RawFormat of `encoding` ("signed", "unsigned" or
    "float"), `bits` and `endian` ("little" or "big")."""
    fmt = RawFormat()
    fmt.set_encoding({"signed": Encoding.SIGNED, "unsigned":
                      Encoding.UNSIGNED, "float": Encoding.FLOAT}[encoding])
    fmt.set_bit_depth(bits)
    fmt.set_endian(RawFormat.Endian.BIG if endian == "big"
                   else RawFormat.Endian.LITTLE)
    fmt.set_sample_rate(rate)
    return fmt


def write_wav(path: str, samples: np.ndarray, bits: int,
              encoding: Encoding, rate: int = 44100) -> None:
    """Stereo `samples` as a WAV file of `bits` and `encoding`, 8-bit
    unsigned included (io/wavfile.py's writer writes 16 bits and up)."""
    with open(path, "wb") as f:
        if bits == 8:
            data = RawConverter(raw_format("unsigned", 8)).to_raw(samples)
            f.write(wavfile.build_header(2, rate, 8, Encoding.UNSIGNED,
                                         len(data), False) + data)
            return
        w = wavfile.WavFileWriter(f, 2, rate, bits, encoding)
        w.write_frames(samples)
        w.close()


def acs_check_metrics(seed: int, batch: int, steps: int,
                      device) -> torch.Tensor:
    """(batch, steps, STATE_COUNT) f32 branch metrics on `device`, made
    from a numpy seed: one row of a clean codeword per block type (integer
    metrics, so many paths tie exactly), one all-NaN row (what
    normalize_soft_bits gives for silence), and uniform-random rows for the
    rest.  Where steps <= ORDER (no codeword fits) or batch < 4, every row
    is uniform-random."""
    rng = np.random.RandomState(seed)
    if steps <= ORDER or batch < 4:
        return torch.from_numpy(rng.rand(batch, steps, STATE_COUNT)
                                .astype(np.float32)).to(device)
    rows = []
    for bt in ConvBlockType:
        coded = conv_encode(bt, rng.randint(0, 2, steps - ORDER)) \
            .astype(np.float32)
        table = torch.from_numpy(_state_output_table(bt))
        rows.append(batch_branch_metrics(torch.from_numpy(coded[None]),
                                         table)[0])
    n_coded = steps * _state_output_table(ConvBlockType.a).shape[1]
    nan_row = normalize_soft_bits(np.zeros(n_coded, np.float32))
    rows.append(batch_branch_metrics(
        torch.from_numpy(nan_row[None]),
        torch.from_numpy(_state_output_table(ConvBlockType.a)))[0])
    rand = rng.rand(batch - len(rows), steps, STATE_COUNT).astype(np.float32)
    bm = torch.cat([torch.stack(rows), torch.from_numpy(rand)])
    return bm.contiguous().to(device)


def acs_equal(got, want) -> bool:
    """Two (decisions, metrics, bits) of the trellis are equal bit for bit,
    NaN metrics equal to NaN."""
    return (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            and torch.equal(torch.isnan(got[1]), torch.isnan(want[1]))
            and torch.equal(torch.nan_to_num(got[1]),
                            torch.nan_to_num(want[1])))


def gen_noise(key: Key, out_file: str, seconds: float, rate: int,
              bits: int = 16):
    channels = 2
    n = int(rate * seconds) * channels
    rk = aes.expand_key(key.aes_key())
    rng = Random(key, 0, Stream.data_up_down)
    u = aes.ctr_keystream_u64(rk, rng._iv, 0, -(-n // 2))[:n]
    d = u.astype(np.float64) / np.float64(2.0 ** 64)
    noise = (d * 2 - 1).astype(np.float32)
    WavData(noise, channels, rate, bits).save(out_file)


def long_noise(seed: int, out_file: str, seconds: float, rate: int,
               channels: int = 2):
    """16-bit noise of `channels` channels, uniform in [-1, 1), from
    np.random.default_rng(seed), written as a wav file."""
    n = int(rate * seconds) * channels
    rng = np.random.default_rng(seed)
    noise = rng.random(n, dtype=np.float32) * np.float32(2) - np.float32(1)
    WavData(noise, channels, rate, 16).save(out_file)


def limiter_signal(seed: int, seconds: float, rate: int, n_channels: int,
                   peak: float) -> np.ndarray:
    """Interleaved float32 noise whose level changes every second (the
    limiter's block) by up to 30 %, so block maxima rise and fall; its
    largest magnitude is `peak`."""
    rng = np.random.RandomState(seed)
    n = int(seconds * rate)
    level = np.repeat(0.7 + 0.3 * rng.rand(math.ceil(seconds)), rate)[:n]
    x = (rng.rand(n, n_channels) * 2 - 1) * level[:, None]
    return (x * (peak / np.abs(x).max())).astype(np.float32).reshape(-1)


def limiters_apart(rate: int, n_channels: int, peak: float, lead: int,
                   device) -> tuple:
    """ops/limiter.DeviceStreamingLimiter on `device` against the numpy
    StreamingLimiter on 12.3 s of limiter_signal: after a skip of `lead`
    zero frames, a first piece of several blocks (the first call that
    emits blocks rounds some ramps in float64), 12 uneven pieces, then
    flush.  (samples out of each, samples whose bits differ, frames
    skipped by each)."""
    from .ops.limiter import DeviceStreamingLimiter, StreamingLimiter
    x = limiter_signal(7, 12.3, rate, n_channels, peak)
    rng = np.random.RandomState(3)
    cuts = np.sort(rng.choice(np.arange(6 * rate, x.size // n_channels),
                              12, replace=False)) * n_channels
    host = StreamingLimiter(n_channels, rate)
    card = DeviceStreamingLimiter(n_channels, rate, device=device)
    skipped = (host.skip(lead), card.skip(lead))
    a = np.concatenate([host.process(p) for p in np.split(x, cuts)]
                       + [host.flush()])
    b = torch.cat([card.process(torch.from_numpy(p).to(card.buffer.device))
                   for p in np.split(x, cuts)] + [card.flush()])
    b = b.cpu().numpy()
    apart = int(np.count_nonzero(a.view(np.int32) != b.view(np.int32))) \
        if a.shape == b.shape else -1
    return (a.size, b.size), apart, skipped


class MemoryInput(AudioInputStream):
    """Interleaved float32 samples as an input stream; `known=False`
    hides their length, as a pipe's is."""

    def __init__(self, samples: np.ndarray, n_channels: int,
                 sample_rate: int, known: bool = True):
        self.samples = samples
        self._n_channels = n_channels
        self._sample_rate = sample_rate
        self._known = known
        self.pos = 0

    def sample_rate(self) -> int:
        return self._sample_rate

    def n_channels(self) -> int:
        return self._n_channels

    def n_frames(self) -> Optional[int]:
        return self.samples.size // self._n_channels if self._known else None

    def read_frames(self, count: int) -> np.ndarray:
        out = self.samples[self.pos:self.pos + count * self._n_channels]
        self.pos += out.size
        return out


class MemoryWav(AudioOutputStream):
    """A WAV output stream into `buf` through io/wavfile.WavFileWriter;
    `dtypes` holds the dtype of every array written."""

    def __init__(self, n_channels: int, sample_rate: int, bit_depth: int,
                 encoding: Encoding, n_frames: Optional[int] = None):
        self.buf = io.BytesIO()
        self.dtypes = []
        self.writer = wavfile.WavFileWriter(self.buf, n_channels,
                                            sample_rate, bit_depth, encoding,
                                            False, n_frames)

    def sample_rate(self) -> int:
        return self.writer.sample_rate

    def n_channels(self) -> int:
        return self.writer.n_channels

    def write_frames(self, samples: np.ndarray):
        self.dtypes.append(np.asarray(samples).dtype)
        self.writer.write_frames(samples)

    def close(self):
        self.writer.close()


def _host(x) -> np.ndarray:
    return np.array(torch.as_tensor(x).cpu().numpy(), dtype=np.float32)


class TileRecorder:
    """What the streaming add (models/embedder.add_stream_watermark) reads
    and computes on `in_stream`: the frames each read returned, what
    StreamingEmbedder.skip returned, and each StreamingEmbedder.run's
    samples and delta, as host copies.  Inside `with` it wraps the class's
    run and skip."""

    def __init__(self, in_stream: AudioInputStream):
        self.reads, self.skips, self.runs = [], [], []
        read, C = in_stream.read_frames, in_stream.n_channels()

        def recorded(count):
            out = read(count)
            self.reads.append(out.size // C)
            return out

        in_stream.read_frames = recorded

    def __enter__(self):
        from .models.embedder import StreamingEmbedder
        self._saved = run, skip = StreamingEmbedder.run, StreamingEmbedder.skip

        def recorded_run(emb, samples):
            delta = run(emb, samples)
            self.runs.append((_host(samples), _host(delta)))
            return delta

        def recorded_skip(emb, zero_frames):
            out = skip(emb, zero_frames)
            self.skips.append(out)
            return out

        StreamingEmbedder.run = recorded_run
        StreamingEmbedder.skip = recorded_skip
        return self

    def __exit__(self, *exc):
        from .models.embedder import StreamingEmbedder
        StreamingEmbedder.run, StreamingEmbedder.skip = self._saved
        return False


def host_finish(rec: TileRecorder, out_stream: AudioOutputStream,
                n_channels: int, sample_rate: int,
                zero_frames: int = 0) -> Optional[float]:
    """The recorded add's tiles finished on the host into `out_stream` and
    closed: the mix in numpy, ops/limiter.StreamingLimiter, and float32 to
    the writer, with the add's cuts to the input's length and of the zero
    lead-in.  Returns the SNR in dB that `Params.snr` prints, else None."""
    from .ops.frames import FRAME
    from .ops.limiter import StreamingLimiter
    C = n_channels
    limiter = StreamingLimiter(C, sample_rate, Params.limiter_block_size_ms,
                               Params.limiter_ceiling)
    orig_fifo = np.zeros(0, dtype=np.float32)
    total_in = total_out = 0
    zero_in = zero_out = zero_frames
    if zero_in >= FRAME:
        skip_frames = zero_in - zero_in % FRAME
        total_in += skip_frames
        out = rec.skips[0]
        orig_fifo = np.zeros((skip_frames - out) * C, dtype=np.float32)
        out = limiter.skip(out)
        zero_out -= out
        total_out += out
        zero_in -= skip_frames
    delta_power = signal_power = 0.0
    for k, (samples, delta) in enumerate(rec.runs):
        total_in += rec.reads[k] + (zero_in if k == 0 else 0)
        orig_fifo = np.concatenate([orig_fifo, samples])
        n = delta.size
        orig, orig_fifo = orig_fifo[:n], orig_fifo[n:]
        delta_power += float(np.sum(np.square(delta.astype(np.float64))))
        signal_power += float(np.sum(np.square(orig.astype(np.float64))))
        mixed = delta + orig
        if not Params.test_no_limiter:
            mixed = limiter.process(mixed)
        mixed = mixed[:(total_in - total_out) * C]
        cut = min(mixed.size // C, zero_out)
        mixed = mixed[cut * C:]
        total_out += cut
        zero_out -= cut
        out_stream.write_frames(mixed)
        total_out += mixed.size // C
    out_stream.close()
    return (10 * np.log10(signal_power / delta_power) if Params.snr
            else None)


def add_and_host_finish(samples: np.ndarray, n_channels: int,
                        sample_rate: int, make_output, known: bool = True,
                        zero_frames: int = 0, device=None) -> dict:
    """The streaming add of `samples` (MemoryInput) on `device` into
    `make_output("device")`, with the tracer on, and host_finish of its
    tiles into `make_output("host")`: both streams (closed), the tiles
    recorded, the SNR host_finish computed, what the add printed, the
    tracer's counters and its count of `add.write` spans."""
    import contextlib
    from .models.embedder import add_stream_watermark
    from .utils import prof
    src = MemoryInput(samples, n_channels, sample_rate, known)
    dev_out, err = make_output("device"), io.StringIO()
    was = prof.enabled
    prof.reset()
    prof.enabled = True
    try:
        with TileRecorder(src) as rec, contextlib.redirect_stderr(err):
            rc = add_stream_watermark(Key(), src, dev_out, "f0" * 16,
                                      zero_frames, device=device)
    finally:
        prof.enabled = was
    host = make_output("host")
    snr = host_finish(rec, host, n_channels, sample_rate, zero_frames) \
        if rc == 0 else None
    return dict(rc=rc, device=dev_out, host=host, tiles=len(rec.runs),
                snr=snr, info=err.getvalue(), counters=dict(prof.counters),
                writes=prof.counts["add.write"])

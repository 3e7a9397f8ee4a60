"""Watermark embedder: the whole-file add and the streaming tile add.

Port of audiowmark_tpu/models/embedder.py (reference: src/wmadd.cc): the
A/B frame-mod layout starting 250 frames into a partial B block, the
reference's Data Blocks count, and the informational output.

* Whole-file path: ONE device pass of ops/frames.add_file_core over a
  44.1 kHz file of known length up to _FAST_PATH_MAX_FRAMES frames (f32
  in; int16 out for a 16-bit writer).
* Streaming path, for everything else (another sample rate, a pipe or
  unknown length, longer files, --snr, a zero lead-in): each tile is
  uploaded once and finished on the device: ops/frames.embed_delta_frames
  with the overlap-add carry, the resampler pair of ops/resample.py around
  it for other rates, the mix with the tile's samples kept on the device,
  ops/limiter.DeviceStreamingLimiter and, for a 16-bit signed PCM writer,
  its trunc-clip (ops/frames.quantize_i16): one read-back per tile, int16
  where the writer takes it as it is, float32 for every other output.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..crypto.keys import Key
from ..io.streams import (AudioInputStream, AudioOutputStream, StreamError,
                          create_input_stream, create_output_stream)
from ..params import Encoding, Format, Params, RawFormat
from ..utils.hexbits import bit_vec_to_str
from ..utils.log import error, info, warning

from ..device import DeviceLike, resolve
from ..ops.frames import FRAME, add_file_core, embed_delta_frames, \
    quantize_i16
from ..ops.limiter import DeviceStreamingLimiter
from ..ops.resample import StreamingResampler, _filter_params
from ..tables import get_key_tables, tables_to_device
from ..utils import prof
from .common import build_ab_frame_mods, parse_payload

# frames per streaming tile: input of unknown length ramps up from 16 to
# 512 (a small first tile gives a low time to first byte, like the
# reference's 1-frame pipeline); a known length starts at 4096
_TILE_FRAMES_UNKNOWN = 512
_TILE_FRAMES_KNOWN = 4096
# the whole-file pass holds every frame's spectrum on the device at once;
# longer files take the streaming path
_FAST_PATH_MAX_FRAMES = 32768          # ~12.7 min at 44.1 kHz


class StreamingEmbedder:
    """Generates the watermark delta signal for an input stream, tile by
    tile (the reference's WatermarkGen + WatermarkSynth + WatermarkResampler
    in one stateful pipeline).  The frame mods, the overlap-add carry and
    the resampler state live on `device`."""

    def __init__(self, key: Key, n_channels: int, input_rate: int,
                 bitvec: np.ndarray, device: DeviceLike = None):
        self.device = resolve(device)
        self.n_channels = n_channels
        tables = get_key_tables(key)
        self.tables = tables
        self.frames_per_block = tables.frames_per_block
        self.mods_ab = torch.from_numpy(build_ab_frame_mods(
            tables, bitvec)).to(self.device)               # (2*fpb, N_BINS)
        # start with a partial B-block as padding (src/wmadd.cc:293-296)
        self.frame_number = 2 * self.frames_per_block - Params.frames_pad_start
        self.m_data_blocks = 0
        self.water_delta = Params.water_delta
        # generator-frame budget for data-block counting, set at EOF from
        # the reference-loop simulation (_ref_generator_frame_cap): the
        # batched tile drain feeds zero pads past where the reference's
        # one-frame loop stops, and boundaries there must not count.  None:
        # unlimited (before EOF, or with a zero lead-in)
        self.count_cap: Optional[int] = None
        self._fed = 0

        self.prev1 = None
        self.prev2 = None
        self.first_frame = True
        self._in_remainder = torch.zeros(0, dtype=torch.float32,
                                         device=self.device)

        self.need_resampler = input_rate != Params.mark_sample_rate
        if self.need_resampler:
            self.in_resampler = StreamingResampler(
                n_channels, input_rate, Params.mark_sample_rate, self.device)
            self.out_resampler = StreamingResampler(
                n_channels, Params.mark_sample_rate, input_rate, self.device)

    def _gen_frames(self, samples44: torch.Tensor) -> torch.Tensor:
        """Watermark-rate samples (whole frames, interleaved, on the
        device) -> delta samples on the device."""
        n_frames = samples44.shape[0] // (FRAME * self.n_channels)
        assert n_frames * FRAME * self.n_channels == samples44.shape[0]
        if n_frames == 0:
            return samples44.new_zeros(0)
        frames = samples44.reshape(n_frames, FRAME, self.n_channels) \
            .transpose(1, 2)
        out, self.prev1, self.prev2 = embed_delta_frames(
            frames, self.frame_mods(n_frames), self.water_delta, self.prev1,
            self.prev2, self.device)
        t = np.arange(n_frames)
        hit = (self.frame_number + t + 1) % self.frames_per_block == 0
        if self.count_cap is not None:
            hit &= (self._fed + t) < self.count_cap
        self.m_data_blocks += int(np.sum(hit))
        self._fed += n_frames
        self.frame_number += n_frames
        out = out.transpose(1, 2).reshape(-1)
        if self.first_frame:
            self.first_frame = False
            out = out[FRAME * self.n_channels:]  # one-frame synth latency
        return out

    def frame_mods(self, n_frames: int) -> torch.Tensor:
        """(n_frames, N_BINS) int8 mods of the next frames, on the device."""
        phases = (self.frame_number + torch.arange(
            n_frames, device=self.device)) % (2 * self.frames_per_block)
        return self.mods_ab[phases]

    def run(self, samples) -> torch.Tensor:
        """Feed input-rate samples (interleaved, a tensor on the device or a
        host array); returns the delta samples available so far (input
        rate, on the device)."""
        if not self.need_resampler:
            x = torch.as_tensor(samples, dtype=torch.float32,
                                device=self.device)
            if self._in_remainder.shape[0]:
                x = torch.cat([self._in_remainder, x])
            vpf = FRAME * self.n_channels
            n_whole = x.shape[0] // vpf * vpf
            self._in_remainder = x[n_whole:]
            with prof.phase("add.embed"):
                return self._gen_frames(x[:n_whole])

        with prof.phase("add.resample"):
            self.in_resampler.write_frames(samples)
        vpf_frames = self.in_resampler.can_read_frames() // FRAME * FRAME
        if vpf_frames:
            with prof.phase("add.resample"):
                x = self.in_resampler.read_frames(vpf_frames)
            with prof.phase("add.embed"):
                wm = self._gen_frames(x)
            with prof.phase("add.resample"):
                self.out_resampler.write_frames(wm)
        to_read = self.out_resampler.can_read_frames()
        with prof.phase("add.resample"):
            return self.out_resampler.read_frames(to_read)

    def skip(self, zero_frames: int) -> int:
        """Skip a whole-frame zero lead-in, keeping the PRNG frame phase
        (reference: src/wmadd.cc:251-263,318-325,408-425)."""
        assert zero_frames % FRAME == 0
        if not self.need_resampler:
            self.frame_number += zero_frames // FRAME
            if self.first_frame and zero_frames > 0:
                self.first_frame = False
                return zero_frames - FRAME
            return zero_frames
        out = self.in_resampler.skip(zero_frames)
        assert out % FRAME == 0
        self.frame_number += out // FRAME
        if self.first_frame and out > 0:
            self.first_frame = False
            out -= FRAME
        return self.out_resampler.skip(out)

    def data_blocks(self) -> int:
        return max(self.m_data_blocks - 1, 0)


def _ref_gen_frame_count(n_in_frames: int, no_limiter: bool,
                         block_size: int) -> int:
    """Frames the reference feeds WatermarkGen before its write loop breaks
    (src/wmadd.cc:520-588: 1024-frame reads, zero-pad until output catches
    up through the 1-frame synth latency and the limiter's 1-block hold).
    Data-block counting stops exactly here."""
    total_in = 0
    total_out = 0
    k = 0
    while True:
        got = min(FRAME, n_in_frames - total_in)
        total_in += got
        if got < FRAME and total_in == total_out:
            break
        k += 1
        synth_frames = max(k - 1, 0)
        if no_limiter:
            emitted = synth_frames * FRAME
        else:
            blocks = (synth_frames * FRAME) // block_size
            emitted = max(blocks - 1, 0) * block_size
        total_out = min(emitted, total_in)
    return k


def _ref_generator_frame_cap(n_in_frames: int, in_rate: int,
                             no_limiter: bool, block_size: int) -> int:
    """Generator (44.1 kHz) frames the reference's add loop feeds before
    it breaks, for ANY input rate: simulates the 1024-frame read loop
    (src/wmadd.cc:520-588) through the resampler pair's exact integer
    emission law (ops/resample.StreamingResampler._produce), the 1-frame
    synth latency and the limiter's 1-block hold."""
    mark = Params.mark_sample_rate
    if in_rate == mark:
        return _ref_gen_frame_count(n_in_frames, no_limiter, block_size)
    _, _, half_in, _ = _filter_params(mark / in_rate)
    _, _, half_out, _ = _filter_params(in_rate / mark)

    def res_out(in_total: int, half_taps: int, out_rate: int,
                in_r: int) -> int:
        avail = (in_total - half_taps) * out_rate
        return (avail - 1) // in_r + 1 if avail > 0 else 0

    total_in = 0
    total_out = 0
    it = 0
    gen = 0
    limit = n_in_frames // FRAME + 4096          # safety bound
    while it < limit:
        got = min(FRAME, n_in_frames - total_in)
        total_in += got
        if got < FRAME and total_in == total_out:
            break
        it += 1
        out44 = res_out(it * FRAME, half_in, mark, in_rate)
        gen = (out44 // FRAME) * FRAME           # whole generator frames
        synth = max(gen - FRAME, 0)              # one-frame synth latency
        back = res_out(synth, half_out, in_rate, mark)
        if no_limiter:
            emitted = back
        else:
            emitted = max(back // block_size - 1, 0) * block_size
        total_out = min(emitted, total_in)
    return gen // FRAME


def _writes_int16(out_stream: AudioOutputStream) -> bool:
    """Whether `out_stream` writes 16-bit signed PCM through a WAV writer,
    which takes int16 samples as they are (io/wavfile.WavFileWriter)."""
    writer = getattr(out_stream, "writer", None)
    return bool(writer is not None and writer.bit_depth == 16
                and writer.encoding == Encoding.SIGNED)


def _add_file_fast(embedder: StreamingEmbedder, in_stream: AudioInputStream,
                   out_stream: AudioOutputStream, n_channels: int) -> int:
    """Whole-file add in one device pass; returns the frames written."""
    from ..io.ffshim import drain_stream

    device = embedder.device
    with prof.phase("add.read"):
        samples = drain_stream(in_stream)
    n_frames_in = samples.size // n_channels
    n_out = n_frames_in * n_channels

    G = max(-(-n_frames_in // FRAME), 1)
    x = np.zeros(G * FRAME * n_channels, dtype=np.float32)
    x[:samples.size] = samples

    out_i16 = _writes_int16(out_stream)

    block_size = Params.mark_sample_rate \
        * int(Params.limiter_block_size_ms) // 1000

    dev = tables_to_device(embedder.tables, device)
    with prof.phase("add.upload"):
        x_dev = torch.from_numpy(x).to(device)
    with prof.phase("add.core"):
        out = add_file_core(
            x_dev, embedder.frame_mods(G), embedder.water_delta,
            dev["analysis_window"], dev["synthesis_window"], n_channels,
            n_out, bool(Params.test_no_limiter), out_i16, block_size,
            Params.limiter_ceiling)
    # out_i16: the device already applied the writer's trunc-clip, and the
    # int16 buffer goes to the writer as it is
    with prof.phase("add.readback"):
        out_np = out.cpu().numpy()

    # reference data-block count: boundaries within the frames the 1-frame
    # reference loop would feed, NOT within the padded pass
    k_total = _ref_gen_frame_count(n_frames_in, bool(Params.test_no_limiter),
                                   block_size)
    t = np.arange(k_total)
    embedder.m_data_blocks += int(np.sum(
        (embedder.frame_number + t + 1) % embedder.frames_per_block == 0))
    embedder.frame_number += G

    with prof.phase("add.write"):
        out_stream.write_frames(out_np)
    return n_frames_in


def _info_format(label: str, fmt: RawFormat):
    enc = {Encoding.SIGNED: "signed", Encoding.UNSIGNED: "unsigned",
           Encoding.FLOAT: "float"}[fmt.encoding()]
    endian = "little" if fmt.endian() == RawFormat.Endian.LITTLE else "big"
    info("%-13s %d Hz, %d Channels, %d Bit (%s %s-endian)\n"
         % (label + ":", fmt.sample_rate(), fmt.n_channels(),
            fmt.bit_depth(), enc, endian))


def _check_frame_count(in_stream: AudioInputStream, total_output_frames: int,
                       zero_frames: int) -> int:
    """0, or 1 after the --strict error for a stream that ended early."""
    if in_stream.n_frames() is None:
        return 0
    expect_frames = in_stream.n_frames() + zero_frames
    if total_output_frames != expect_frames:
        msg = ("unexpected EOF; input frames (%d) != output frames (%d)"
               % (expect_frames, total_output_frames))
        if Params.strict:
            error("audiowmark: error: %s\n" % msg)
            return 1
        warning("audiowmark: warning: %s\n" % msg)
    return 0


def add_stream_watermark(key: Key, in_stream: AudioInputStream,
                         out_stream: AudioOutputStream, bits: str,
                         zero_frames: int = 0,
                         device: DeviceLike = None) -> int:
    """Mark `in_stream` into `out_stream`; `zero_frames` of silence are
    taken to precede the input (an HLS segment's position in its stream)
    and are not written."""
    dev = resolve(device)
    bitvec = parse_payload(bits)
    if bitvec is None:
        return 1

    if in_stream.sample_rate() != out_stream.sample_rate():
        error("audiowmark: input sample rate (%d) and output sample rate "
              "(%d) don't match\n"
              % (in_stream.sample_rate(), out_stream.sample_rate()))
        return 1
    if in_stream.n_channels() != out_stream.n_channels():
        error("audiowmark: input channels (%d) and output channels (%d) "
              "don't match\n"
              % (in_stream.n_channels(), out_stream.n_channels()))
        return 1

    info("Message:      %s\n" % bit_vec_to_str(bitvec))
    info("Strength:     %.6g\n\n" % (Params.water_delta * 1000))
    if in_stream.n_frames() is None:
        info("Time:         unknown\n")
    else:
        secs = in_stream.n_frames() // in_stream.sample_rate()
        info("Time:         %d:%02d\n" % (secs // 60, secs % 60))
    info("Sample Rate:  %d\n" % in_stream.sample_rate())
    info("Channels:     %d\n" % in_stream.n_channels())

    n_channels = in_stream.n_channels()
    with prof.phase("add.setup"):
        embedder = StreamingEmbedder(key, n_channels, in_stream.sample_rate(),
                                     bitvec, dev)
        limiter = DeviceStreamingLimiter(n_channels, in_stream.sample_rate(),
                                         Params.limiter_block_size_ms,
                                         Params.limiter_ceiling, dev)

    snr_delta_power = 0.0
    snr_signal_power = 0.0

    # the input samples not yet mixed, on the device
    orig_fifo = torch.zeros(0, dtype=torch.float32, device=dev)
    total_input_frames = 0
    total_output_frames = 0
    zero_frames_in = zero_frames
    zero_frames_out = zero_frames

    if zero_frames_in >= FRAME:
        skip_frames = zero_frames_in - zero_frames_in % FRAME
        total_input_frames += skip_frames
        out = embedder.skip(skip_frames)
        orig_fifo = orig_fifo.new_zeros((skip_frames - out) * n_channels)
        out = limiter.skip(out)
        assert out < zero_frames_out
        zero_frames_out -= out
        total_output_frames += out
        zero_frames_in -= skip_frames

    # whole-file path: one device pass (embed + mix + limiter + quantize)
    if (zero_frames == 0 and in_stream.n_frames() is not None
            and in_stream.sample_rate() == Params.mark_sample_rate
            and not Params.snr
            and in_stream.n_frames() <= _FAST_PATH_MAX_FRAMES * FRAME):
        total_output_frames = _add_file_fast(embedder, in_stream, out_stream,
                                             n_channels)
        info("Data Blocks:  %d\n" % embedder.data_blocks())
        if _check_frame_count(in_stream, total_output_frames, 0):
            return 1
        out_stream.close()
        return 0

    out_i16 = _writes_int16(out_stream)
    if in_stream.n_frames() is None:
        tile_frames, max_tile_frames = 16, _TILE_FRAMES_UNKNOWN
    else:
        tile_frames = max_tile_frames = _TILE_FRAMES_KNOWN
    eof = False
    while True:
        tile = tile_frames * FRAME
        tile_frames = min(tile_frames * 2, max_tile_frames)
        lead_frames, zero_frames_in = zero_frames_in, 0
        with prof.phase("add.read"):
            samples = in_stream.read_frames(tile - lead_frames)
        got_frames = lead_frames + samples.size // n_channels
        total_input_frames += got_frames

        pad_frames = 0
        if got_frames < tile:
            eof = True
            if total_input_frames == total_output_frames:
                break
            # batched drain: zero-pad to the tile so the synth and limiter
            # tails flush in a couple of tiles (the pads give exactly zero
            # delta, and the output is cut to the input length); the
            # data-block count is bounded by the reference-loop simulation
            # (src/wmadd.cc:520-546 feeds pads one frame at a time only
            # until the output catches up)
            if embedder.count_cap is None and zero_frames == 0:
                embedder.count_cap = _ref_generator_frame_cap(
                    total_input_frames, in_stream.sample_rate(),
                    bool(Params.test_no_limiter),
                    in_stream.sample_rate()
                    * int(Params.limiter_block_size_ms) // 1000)
            pad_frames = tile - got_frames

        with prof.phase("add.upload"):
            x = torch.from_numpy(np.asarray(samples, np.float32)).to(dev)
        if lead_frames or pad_frames:
            x = torch.cat([x.new_zeros(lead_frames * n_channels), x,
                           x.new_zeros(pad_frames * n_channels)])
        orig_fifo = torch.cat([orig_fifo, x])
        delta = embedder.run(x)
        n = delta.shape[0]
        orig_samples, orig_fifo = orig_fifo[:n], orig_fifo[n:]

        if Params.snr:
            snr_delta_power += float(np.sum(np.square(
                delta.cpu().numpy().astype(np.float64))))
            snr_signal_power += float(np.sum(np.square(
                orig_samples.cpu().numpy().astype(np.float64))))

        mixed = delta + orig_samples
        if not Params.test_no_limiter:
            with prof.phase("add.limiter"):
                mixed = limiter.process(mixed)

        max_write = total_input_frames - total_output_frames
        mixed = mixed[: max_write * n_channels]

        cut_frames = min(mixed.shape[0] // n_channels, zero_frames_out)
        if cut_frames > 0:
            mixed = mixed[cut_frames * n_channels:]
            total_output_frames += cut_frames
            zero_frames_out -= cut_frames

        # one read-back a tile: int16 for a writer that takes it as it is
        with prof.phase("add.readback"):
            if out_i16:
                out = quantize_i16(mixed).cpu().numpy()
                prof.count("add.finish_i16")
            else:
                out = mixed.cpu().numpy()
                prof.count("add.finish_f32")
        with prof.phase("add.write"):
            out_stream.write_frames(out)
        total_output_frames += out.size // n_channels
        if eof and total_input_frames == total_output_frames:
            break

    if Params.snr:
        info("SNR:          %f dB\n"
             % (10 * np.log10(snr_signal_power / snr_delta_power)))
    info("Data Blocks:  %d\n" % embedder.data_blocks())
    if _check_frame_count(in_stream, total_output_frames, zero_frames):
        return 1
    out_stream.close()
    return 0


def add_watermark(key: Key, infile: str, outfile: str, bits: str,
                  device: DeviceLike = None) -> int:
    """`audiowmark add`: mark `infile` with the hex message `bits` into
    `outfile`, on `device` (default: the CUDA card)."""
    dev = resolve(device)
    try:
        in_stream = create_input_stream(infile)
    except (StreamError, OSError) as e:
        error("audiowmark: error opening %s: %s\n" % (infile, e))
        return 1

    try:
        out_bit_depth = in_stream.bit_depth()
        out_encoding = in_stream.encoding()
        if out_bit_depth < 16:
            out_bit_depth = 16
            out_encoding = Encoding.SIGNED
        try:
            out_stream = create_output_stream(
                outfile, in_stream.n_channels(), in_stream.sample_rate(),
                out_bit_depth, out_encoding, in_stream.n_frames())
        except (StreamError, OSError) as e:
            error("audiowmark: error writing to %s: %s\n" % (outfile, e))
            return 1

        info("Input:        %s\n" % (Params.input_label or infile))
        if Params.input_format == Format.RAW:
            _info_format("Raw Input", Params.raw_input_format)
        info("Output:       %s\n" % (Params.output_label or outfile))
        if Params.output_format == Format.RAW:
            _info_format("Raw Output", Params.raw_output_format)
        return add_stream_watermark(key, in_stream, out_stream, bits,
                                    device=dev)
    finally:
        in_stream.close()

"""Watermark embedder: the whole-file add path.

Port of audiowmark_tpu/models/embedder.py's main path (reference:
src/wmadd.cc): the A/B frame-mod layout starting 250 frames into a
partial B block, ONE device pass of ops/frames.add_file_core over the
whole file (f32 in; int16 out for a 16-bit writer), the
reference's Data Blocks count, and the informational output.

What the port does not do yet raises NotImplementedError naming its
ROADMAP item: input that is not 44.1 kHz, and the streaming tile path
(unknown length, more than _FAST_PATH_MAX_FRAMES frames, --snr; the zero
lead-in of HLS segments has no entry point in the port).
"""

from __future__ import annotations

import numpy as np
import torch

from audiowmark_tpu.crypto.keys import Key
from audiowmark_tpu.io.streams import (AudioInputStream, AudioOutputStream,
                                       StreamError, create_input_stream,
                                       create_output_stream)
from audiowmark_tpu.params import Encoding, Format, Params, RawFormat
from audiowmark_tpu.utils.hexbits import bit_vec_to_str
from audiowmark_tpu.utils.log import error, info, warning

from ..device import DeviceLike, resolve
from ..ops.frames import FRAME, add_file_core
from ..tables import get_key_tables, tables_to_device
from .common import build_ab_frame_mods, parse_payload

# the whole-file pass holds every frame's spectrum on the device at once;
# longer files take the streaming tile path of the JAX package (not ported)
_FAST_PATH_MAX_FRAMES = 32768          # ~12.7 min at 44.1 kHz


class StreamingEmbedder:
    """Per-stream embedding state: the A/B frame mods and the frame phase
    (the reference's WatermarkGen set-up)."""

    def __init__(self, key: Key, bitvec: np.ndarray):
        tables = get_key_tables(key)
        self.tables = tables
        self.frames_per_block = tables.frames_per_block
        self.mods_ab = build_ab_frame_mods(tables, bitvec)   # (2*fpb, N_BINS)
        # start with a partial B-block as padding (src/wmadd.cc:293-296)
        self.frame_number = 2 * self.frames_per_block - Params.frames_pad_start
        self.m_data_blocks = 0
        self.water_delta = Params.water_delta

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


def _add_file_fast(embedder: StreamingEmbedder, in_stream: AudioInputStream,
                   out_stream: AudioOutputStream, n_channels: int,
                   device: torch.device) -> int:
    """Whole-file add in one device pass; returns the frames written."""
    from audiowmark_tpu.io.ffshim import drain_stream

    samples = drain_stream(in_stream)
    n_frames_in = samples.size // n_channels
    n_out = n_frames_in * n_channels

    G = max(-(-n_frames_in // FRAME), 1)
    x = np.zeros(G * FRAME * n_channels, dtype=np.float32)
    x[:samples.size] = samples

    writer = getattr(out_stream, "writer", None)
    out_i16 = bool(writer is not None and writer.bit_depth == 16
                   and writer.encoding == Encoding.SIGNED)

    phases = (embedder.frame_number + np.arange(G)) \
        % (2 * embedder.frames_per_block)
    mods = embedder.mods_ab[phases]
    block_size = Params.mark_sample_rate \
        * int(Params.limiter_block_size_ms) // 1000

    dev = tables_to_device(embedder.tables, device)
    out = add_file_core(
        torch.from_numpy(x).to(device), torch.from_numpy(mods).to(device),
        embedder.water_delta, dev["analysis_window"],
        dev["synthesis_window"], n_channels, n_out,
        bool(Params.test_no_limiter), out_i16, block_size,
        Params.limiter_ceiling)
    # out_i16: the device already applied the writer's trunc-clip, and the
    # int16 buffer goes to the writer as it is
    out_np = out.cpu().numpy()

    # reference data-block count: boundaries within the frames the 1-frame
    # reference loop would feed, NOT within the padded pass
    k_total = _ref_gen_frame_count(n_frames_in, bool(Params.test_no_limiter),
                                   block_size)
    t = np.arange(k_total)
    embedder.m_data_blocks += int(np.sum(
        (embedder.frame_number + t + 1) % embedder.frames_per_block == 0))
    embedder.frame_number += G

    out_stream.write_frames(out_np)
    return n_frames_in


def _info_format(label: str, fmt: RawFormat):
    enc = {Encoding.SIGNED: "signed", Encoding.UNSIGNED: "unsigned",
           Encoding.FLOAT: "float"}[fmt.encoding()]
    endian = "little" if fmt.endian() == RawFormat.Endian.LITTLE else "big"
    info("%-13s %d Hz, %d Channels, %d Bit (%s %s-endian)\n"
         % (label + ":", fmt.sample_rate(), fmt.n_channels(),
            fmt.bit_depth(), enc, endian))


def _check_supported(in_stream: AudioInputStream):
    """Raise for the inputs whose add path is not ported yet."""
    if in_stream.sample_rate() != Params.mark_sample_rate:
        raise NotImplementedError(
            "audiowmark_tpu_torch: input at %d Hz needs the resampler, which "
            "is not ported yet (ROADMAP Queue 1: resampling)"
            % in_stream.sample_rate())
    n_frames = in_stream.n_frames()
    if (n_frames is None or Params.snr
            or n_frames > _FAST_PATH_MAX_FRAMES * FRAME):
        raise NotImplementedError(
            "audiowmark_tpu_torch: this add needs the streaming tile path "
            "(pipe or unknown length, more than %d frames, or --snr), which "
            "is not ported yet (ROADMAP Queue 1: streaming add)"
            % (_FAST_PATH_MAX_FRAMES * FRAME))


def add_stream_watermark(key: Key, in_stream: AudioInputStream,
                         out_stream: AudioOutputStream, bits: str,
                         device: DeviceLike = None) -> int:
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
    _check_supported(in_stream)

    info("Message:      %s\n" % bit_vec_to_str(bitvec))
    info("Strength:     %.6g\n\n" % (Params.water_delta * 1000))
    secs = in_stream.n_frames() // in_stream.sample_rate()
    info("Time:         %d:%02d\n" % (secs // 60, secs % 60))
    info("Sample Rate:  %d\n" % in_stream.sample_rate())
    info("Channels:     %d\n" % in_stream.n_channels())

    embedder = StreamingEmbedder(key, bitvec)
    total_output_frames = _add_file_fast(embedder, in_stream, out_stream,
                                         in_stream.n_channels(), dev)
    info("Data Blocks:  %d\n" % embedder.data_blocks())
    expect_frames = in_stream.n_frames()
    if total_output_frames != expect_frames:
        msg = ("unexpected EOF; input frames (%d) != output frames (%d)"
               % (expect_frames, total_output_frames))
        if Params.strict:
            error("audiowmark: error: %s\n" % msg)
            return 1
        warning("audiowmark: warning: %s\n" % msg)
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
        return add_stream_watermark(key, in_stream, out_stream, bits, dev)
    finally:
        in_stream.close()

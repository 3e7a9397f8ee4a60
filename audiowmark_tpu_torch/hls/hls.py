"""HLS segment watermarking: hls-prepare / hls-add.

Port of audiowmark_tpu/hls/hls.py on the port's io/ffshim.py, io/flac.py,
streams and models/embedder.add_stream_watermark (the streaming add on the
device).  Reference behavior (src/hls.cc): `hls-prepare` validates AAC segments with
ffprobe, decodes each to count samples (1024-aligned), stores the master
audio cut to segment+-3s context as FLAC plus a vars blob inside the output
.ts via the TS piggyback writer; `hls-add` extracts the context, watermarks
it with `zero_frames = start_pos - prev_size` so the PRNG frame phase matches
the full-stream timeline, AAC-encodes, drops `prev_ctx/1024` lead-in AAC
frames and keeps `size/1024` frames, muxing back to MPEG-TS at the original
presentation timestamp.

The FLAC piggyback payload uses the native codec (io/flac.py); AAC encode/
decode, stream probing and the MPEG-TS mux run against the FFmpeg libraries
through the native shim (native/ffshim.cc via io/ffshim.py) — exactly the
libraries the reference's HLSOutputStream links (src/hlsoutputstream.cc).
Without the shim built, HLS commands report an actionable error (the
reference similarly stubs out HLS when built without ffmpeg,
src/hls.cc:41-55).
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np

from ..crypto.keys import Key
from ..device import DeviceLike
from ..io import ffshim
from ..io.streams import AudioInputStream, AudioOutputStream
from ..io.wavdata import WavData
from ..params import Params
from ..utils.log import error, info
from .mpegts import TSReader, TSWriter


def _have_codec_shim() -> bool:
    return ffshim.available()


def _no_ffmpeg_error() -> int:
    error("audiowmark: hls support needs the native codec shim "
          "(build with: make -C native)\n")
    return 1


def ff_decode_to_wavdata(filename: str, fmt: Optional[str] = None) -> WavData:
    """Decode any libav-supported input to WavData (native shim)."""
    stream = ffshim.FFInputStream(filename, fmt=fmt)
    try:
        return WavData(ffshim.drain_stream(stream), stream.n_channels(),
                       stream.sample_rate(), stream.bit_depth())
    finally:
        stream.close()


def _flac_encode(samples: np.ndarray, n_channels: int, rate: int) -> bytes:
    """Encode float samples to FLAC bytes (16-bit) with the native codec
    (reference uses libsndfile virtual-IO FLAC, src/hls.cc:563-580)."""
    from ..io.flac import encode_flac
    return encode_flac(samples, n_channels, rate, bit_depth=16)


def _flac_decode(data: bytes) -> WavData:
    from ..io.flac import decode_flac
    samples, nch, rate, bps = decode_flac(data)
    return WavData(samples, nch, rate, bps)


class MemoryInputStream(AudioInputStream):
    """Stream over an in-memory WavData (SFInputStream virtual-IO analog)."""

    def __init__(self, wav: WavData):
        self.wav = wav
        self.pos = 0

    def bit_depth(self):
        return self.wav.bit_depth

    def sample_rate(self):
        return self.wav.sample_rate

    def n_channels(self):
        return self.wav.n_channels

    def n_frames(self):
        return self.wav.n_frames

    def read_frames(self, count: int) -> np.ndarray:
        n = count * self.wav.n_channels
        out = self.wav.samples[self.pos:self.pos + n]
        self.pos += out.size
        return out


class HLSOutputStream(AudioOutputStream):
    """AAC->MPEG-TS output: encodes watermarked samples with the native AAC
    encoder as they stream in, drops/keeps the configured AAC frame window
    (the shim also skips the encoder's priming packets) and muxes to mpegts
    at the original PTS (reference: src/hlsoutputstream.cc)."""

    def __init__(self, n_channels: int, sample_rate: int, bit_depth: int):
        self._n_channels = n_channels
        self._sample_rate = sample_rate
        self._bit_depth = bit_depth
        self.bit_rate = 0
        self.channel_layout = ""
        self._writer: Optional[ffshim.HLSSegmentWriter] = None
        self._delete_input_start = 0

    def set_bit_rate(self, r: int):
        self.bit_rate = r

    def set_channel_layout(self, layout: str):
        self.channel_layout = layout

    def open(self, filename: str, cut_aac_frames: int, keep_aac_frames: int,
             pts_start: float, delete_input_start: int):
        self._delete_input_start = delete_input_start
        self._writer = ffshim.HLSSegmentWriter(
            filename, self._sample_rate, self._n_channels, self.bit_rate,
            cut_aac_frames, keep_aac_frames, pts_start,
            self.channel_layout)

    def sample_rate(self):
        return self._sample_rate

    def n_channels(self):
        return self._n_channels

    def write_frames(self, samples: np.ndarray):
        if self._delete_input_start > 0:
            n = min(self._delete_input_start * self._n_channels, samples.size)
            samples = samples[n:]
            self._delete_input_start -= n // self._n_channels
        if samples.size:
            self._writer.write(np.asarray(samples, dtype=np.float32))

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def hls_add(key: Key, infile: str, outfile: str, bits: str,
            device: DeviceLike = None) -> int:
    """Watermark one prepared segment on `device` (default: the CUDA
    card)."""
    if not _have_codec_shim():
        return _no_ffmpeg_error()
    from ..models.embedder import add_stream_watermark

    reader = TSReader()
    try:
        reader.load(infile)
    except Exception as e:
        error("hls: %s\n" % e)
        return 1

    full_flac = reader.find("full.flac")
    if not full_flac:
        error("hls: no embedded context found in %s\n" % infile)
        return 1

    wav = _flac_decode(full_flac.data)
    in_stream = MemoryInputStream(wav)

    vars_map = reader.parse_vars("vars")
    required = ["start_pos", "prev_size", "size", "pts_start", "bit_rate",
                "channel_layout"]
    missing = [v for v in required if v not in vars_map]
    if missing:
        for v in missing:
            error("audiowmark: hls segment is missing value for required "
                  "variable '%s'\n" % v)
        return 1

    start_pos = int(vars_map["start_pos"])
    prev_size = int(vars_map["prev_size"])
    size = int(vars_map["size"])
    pts_start = float(vars_map["pts_start"])
    bit_rate = int(vars_map["bit_rate"])
    prev_ctx = min(1024 * 3, prev_size)

    if Params.hls_bit_rate:
        bit_rate = Params.hls_bit_rate

    out_stream = HLSOutputStream(wav.n_channels, wav.sample_rate,
                                 wav.bit_depth)
    out_stream.set_bit_rate(bit_rate)
    out_stream.set_channel_layout(vars_map["channel_layout"])

    cut_aac_frames = prev_ctx // 1024
    delete_input_start = prev_size - prev_ctx
    keep_aac_frames = size // 1024
    out_stream.open(outfile, cut_aac_frames, keep_aac_frames, pts_start,
                    delete_input_start)

    rc = add_stream_watermark(key, in_stream, out_stream, bits,
                              start_pos - prev_size, device)
    if rc != 0:
        return rc
    info("AAC Bitrate:  %d\n" % bit_rate)
    return 0


def _probe_input_segment(filename: str) -> Dict[str, str]:
    reader = TSReader()
    reader.load(filename)
    if reader.entries():
        raise RuntimeError("input for hls-prepare must not contain context")
    return ffshim.probe(filename)


def hls_prepare(in_dir: str, out_dir: str, filename: str,
                audio_master: str) -> int:
    if not _have_codec_shim():
        return _no_ffmpeg_error()

    in_name = os.path.join(in_dir, filename)
    try:
        in_lines = open(in_name).read().splitlines()
    except OSError:
        error("audiowmark: error opening input playlist %s\n" % in_name)
        return 1

    os.makedirs(out_dir, exist_ok=True)
    out_name = os.path.join(out_dir, filename)
    if os.path.exists(out_name):
        error("audiowmark: output file already exists: %s\n" % out_name)
        return 1

    try:
        audio_master_data = ff_decode_to_wavdata(audio_master)
    except Exception:
        error("audiowmark: failed to load audio master: %s\n" % audio_master)
        return 1

    segments = []
    with open(out_name, "w") as out_file:
        for line in in_lines:
            out_file.write(line + "\n")
            if not re.fullmatch(r"\s*(#.*)?", line):
                segments.append({"name": line, "vars": {}})

    for segment in segments:
        segname = os.path.join(in_dir, segment["name"])
        try:
            params = _probe_input_segment(segname)
        except Exception as e:
            error("audiowmark: hls: %s\n" % e)
            return 1
        if int(params.get("nb_streams", "0")) != 1:
            error("audiowmark: hls segment '%s' contains more than one "
                  "stream\n" % segname)
            return 1
        if params.get("codec_name") != "aac":
            error("audiowmark: hls segment '%s' is not encoded using AAC\n"
                  % segname)
            return 1
        if int(params.get("channels", "0")) != audio_master_data.n_channels:
            error("audiowmark: number of channels mismatch\n")
            return 1
        if not params.get("channel_layout"):
            error("audiowmark: hls segment '%s' has no channel_layout "
                  "entry\n" % segname)
            return 1
        segment["vars"]["channel_layout"] = params["channel_layout"]
        if not params.get("start_time"):
            error("audiowmark: hls segment '%s' has no start_time entry\n"
                  % segname)
            return 1
        segment["vars"]["pts_start"] = params["start_time"]

    if not Params.hls_bit_rate:
        # sum the AAC payload over the playlist and divide by the master
        # duration (the reference remuxes to ADTS and sizes the file,
        # src/hls.cc:306-318)
        payload_bytes = 0
        for segment in segments:
            nbytes, _, _ = ffshim.payload_stats(
                os.path.join(in_dir, segment["name"]))
            payload_bytes += nbytes
        seconds = audio_master_data.n_frames / audio_master_data.sample_rate
        bit_rate = int(payload_bytes / seconds * 8)
        info("AAC Bitrate:  %d (detected)\n" % bit_rate)
    else:
        bit_rate = Params.hls_bit_rate
        info("AAC Bitrate:  %d\n" % bit_rate)

    info("Segments:     %d\n" % len(segments))
    start_pos = 0
    for segment in segments:
        out = ff_decode_to_wavdata(os.path.join(in_dir, segment["name"]),
                                   fmt="mpegts")
        seg_size = out.n_frames
        if seg_size % 1024 != 0:
            error("audiowmark: hls input segments need 1024-sample "
                  "alignment (due to AAC)\n")
            return 1

        ctx_3sec = 3 * out.sample_rate
        prev_size = min(start_pos, ctx_3sec)
        seg_with_ctx = prev_size + seg_size + ctx_3sec

        segment["vars"]["start_pos"] = str(start_pos)
        segment["vars"]["size"] = str(seg_size)
        segment["vars"]["prev_size"] = str(prev_size)
        segment["vars"]["bit_rate"] = str(bit_rate)

        nch = audio_master_data.n_channels
        start_point = min(start_pos - prev_size, audio_master_data.n_frames)
        end_point = min(start_point + seg_with_ctx,
                        audio_master_data.n_frames)
        out_signal = np.zeros(seg_with_ctx * nch, dtype=np.float32)
        src = audio_master_data.samples[start_point * nch:end_point * nch]
        out_signal[:src.size] = src

        full_flac = _flac_encode(out_signal, nch,
                                 audio_master_data.sample_rate)

        writer = TSWriter()
        writer.append_data("full.flac", full_flac)
        writer.append_vars("vars", segment["vars"])

        out_segment = os.path.join(out_dir, segment["name"])
        if os.path.exists(out_segment):
            error("audiowmark: output file already exists: %s\n"
                  % out_segment)
            return 1
        writer.process(os.path.join(in_dir, segment["name"]), out_segment)
        start_pos += seg_size

    orig_seconds = start_pos // audio_master_data.sample_rate
    info("Time:         %d:%02d\n" % (orig_seconds // 60, orig_seconds % 60))
    return 0

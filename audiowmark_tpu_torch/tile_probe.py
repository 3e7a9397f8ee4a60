"""How the add's output depends on how its input is tiled, on one device.

    python3 -m audiowmark_tpu_torch.tile_probe stages | adds | first-write

stages: the first 4096 frames of the 200 s fixture (test-gen-noise, 16-bit
stereo, 44.1 kHz) with the add's frame mods (default key, MSG), laid out as
the add lays them out, through each stage of the delta (ops/frames.py:
`_spectrum`, the window and the rfft; `_delta_spectrum`, the
mag^(-wd*sign) - 1 factor; `_synthesis`, the irfft * FRAME) and through the
whole `_delta_iffts`, on consecutive slices of T = 1, 2, 4, ... 4096
frames.  Each line: T and, per stage, the rows (frame, channel) whose
output differs in any bit from the same rows of the one 4096-frame call.
Each stage is fed the full call's input of that stage, so it is tested
alone.

adds: int16 samples apart, with the limiter and without it, between
  * the whole-file add and the streaming add (`--snr` sends it there) of
    the 200, 60 and 30 s fixtures at 44.1 kHz;
  * the unknown-length add of raw PCM (`--input-format raw`, its tiles
    ramp 16 -> 512 frames) and the known-length add of the same audio as
    WAV (`--snr` at 44.1 kHz), 60 s at 44.1 and at 32 kHz.

first-write: seconds from the call of `add_stream_watermark` to its first
write of samples, and of the whole add, for the unknown-length add of the
60 s fixture as raw PCM, with the limiter and without it: the first add of
the process and the median of the next three.

Every add goes through the port's command line (cli.main) in this process.
Prints one JSON object per line.  Runs on the CUDA card
(AUDIOWMARK_TORCH_DEVICE=cpu: on the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

from .cli import _device, main as cli_main
from .crypto.keys import Key
from .fixtures import gen_noise, raw_format
from .io.converters import RawConverter
from .io.wavdata import WavData
from .params import Params
from .utils import log

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSG = "0123456789abcdef0011223344556677"
SIZES = tuple(2 ** i for i in range(13))          # 1 ... 4096 frames


def fixture(d: str, seconds: int, rate: int) -> str:
    """The test-gen-noise WAV of `seconds` at `rate` in d (made once) and
    its raw copy, 16-bit signed little-endian; returns the WAV's path."""
    wav = os.path.join(d, "n%d_%d.wav" % (seconds, rate))
    if not os.path.exists(wav):
        gen_noise(Key(), wav, seconds, rate)
        with open(wav[:-4] + ".raw", "wb") as f:
            f.write(RawConverter(raw_format("signed", 16)).to_raw(
                WavData.load(wav).samples))
    return wav


def run_add(argv) -> tuple:
    """`add <argv>` through the port's command line in this process:
    (its informational output, wall s).  Raises unless it exits 0."""
    Params.reset()
    err = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli_main(["--strict", "add"] + list(argv))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        Params.reset()
        log.set_log_level(log.Log.INFO)
    if rc != 0:
        raise RuntimeError("add %s: exit %d:\n%s"
                           % (" ".join(argv), rc, err.getvalue()))
    return err.getvalue(), time.perf_counter() - t0


def samples_apart(a: str, b: str) -> dict:
    """The int16 samples of two WAV files: how many differ, the largest
    difference in LSBs, and how many there are."""
    x, y = WavData.load(a).samples, WavData.load(b).samples
    if x.shape != y.shape or not np.isfinite(x).all():
        raise RuntimeError("%s and %s differ in length or are not finite"
                           % (a, b))
    lsb = np.abs(np.round((x.astype(np.float64) - y) * 32768))
    return dict(lsb_apart=int(np.count_nonzero(lsb)),
                largest_lsb=float(lsb.max()), samples=int(x.size))


# ---------------------------------------------------------------- stages

def probe_input(wav: str, n_frames: int, device) -> tuple:
    """The first n_frames frames of `wav` as the add lays them out, (T, C,
    FRAME) f32 (a transposed view), the add's (T, N_BINS) int8 mods of its
    first frames, and the analysis window, on `device`."""
    from .models.common import parse_payload
    from .models.embedder import StreamingEmbedder
    from .ops.frames import FRAME, window_tensors
    w = WavData.load(wav)
    x = torch.from_numpy(w.samples[:n_frames * FRAME * w.n_channels]) \
        .to(device)
    frames = x.reshape(n_frames, FRAME, w.n_channels).transpose(1, 2)
    emb = StreamingEmbedder(Key(), w.n_channels, w.sample_rate,
                            parse_payload(MSG), device)
    awin = window_tensors(torch.device(device))[0]
    return frames, emb.frame_mods(n_frames), awin


def _rows_apart(got: torch.Tensor, want: torch.Tensor) -> int:
    """(frame, channel) rows of two (T, C, n) tensors that differ in any
    element's bits (complex: either part)."""
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
        got, want = got.flatten(-2), want.flatten(-2)
    return int((got != want).any(dim=-1).sum())


def stage_rows_apart(frames: torch.Tensor, mods: torch.Tensor,
                     water_delta: float, awin: torch.Tensor,
                     sizes=SIZES) -> list:
    """Per T in `sizes` (each dividing the frame count): rows of each
    stage's output on consecutive T-frame slices that differ from the same
    rows of one call on all frames."""
    from .ops.frames import (_delta_iffts, _delta_spectrum, _spectrum,
                             _synthesis)
    n = frames.shape[0]
    spec = _spectrum(frames, awin)
    dspec = _delta_spectrum(spec, mods, water_delta)
    full = {"rfft": spec, "factor": dspec, "irfft": _synthesis(dspec),
            "delta_iffts": _delta_iffts(frames, mods, water_delta, awin)}
    stages = {
        "rfft": lambda s, e: _spectrum(frames[s:e], awin),
        "factor": lambda s, e: _delta_spectrum(spec[s:e], mods[s:e],
                                               water_delta),
        "irfft": lambda s, e: _synthesis(dspec[s:e]),
        "delta_iffts": lambda s, e: _delta_iffts(frames[s:e], mods[s:e],
                                                 water_delta, awin)}
    table = []
    for t in sizes:
        row = {"frames": t}
        for name, fn in stages.items():
            got = torch.cat([fn(s, s + t) for s in range(0, n, t)])
            row[name] = _rows_apart(got, full[name])
        table.append(row)
    return table


# ---------------------------------------------------------------- adds

def whole_vs_stream(wav: str, limiter: bool) -> dict:
    """The whole-file add of the 44.1 kHz `wav` against the streaming add
    (`--snr`): samples apart, both walls, both informational outputs and
    both outputs' paths (beside `wav`)."""
    opt = [] if limiter else ["--test-no-limiter"]
    whole, stream = ("%s_%s_%d.wav" % (wav[:-4], name, limiter)
                     for name in ("whole", "stream"))
    info_whole, whole_s = run_add(opt + [wav, whole, MSG])
    info_stream, stream_s = run_add(["--snr"] + opt + [wav, stream, MSG])
    return dict(samples_apart(whole, stream), whole_s=whole_s,
                stream_s=stream_s, info_whole=info_whole,
                info_stream=info_stream, whole=whole, stream=stream)


def unknown_vs_known(wav: str, rate: int, limiter: bool) -> dict:
    """The unknown-length add of the raw copy of `wav` (16-bit signed,
    beside it as .raw) against the known-length add of `wav` (streaming:
    `--snr` at 44.1 kHz): samples apart, both walls, the unknown add's
    tiles (frames per StreamingEmbedder.run) and its output's path."""
    from .models import embedder
    opt = [] if limiter else ["--test-no-limiter"]
    unknown, known = ("%s_%s_%d.wav" % (wav[:-4], name, limiter)
                      for name in ("unknown", "known"))
    tiles, run = [], embedder.StreamingEmbedder.run

    def recording(self, samples):
        tiles.append(len(samples) // self.n_channels // Params.frame_size)
        return run(self, samples)

    embedder.StreamingEmbedder.run = recording
    try:
        _, unknown_s = run_add(["--input-format", "raw", "--raw-rate",
                                str(rate)] + opt
                               + [wav[:-4] + ".raw", unknown, MSG])
    finally:
        embedder.StreamingEmbedder.run = run
    snr = ["--snr"] if rate == Params.mark_sample_rate else []
    _, known_s = run_add(snr + opt + [wav, known, MSG])
    return dict(samples_apart(unknown, known), unknown_s=unknown_s,
                known_s=known_s, tiles=tiles, unknown=unknown)


# ---------------------------------------------------------------- first write

def first_write(argv) -> tuple:
    """(s from the call of add_stream_watermark to its first write of
    samples, wall s of the whole add) of `add <argv>`."""
    from .models import embedder
    inner, times = embedder.add_stream_watermark, {}

    def timed(key, in_stream, out_stream, *args, **kwargs):
        times["call"] = time.perf_counter()
        write = out_stream.write_frames

        def first(samples):
            if "first" not in times and len(samples):
                times["first"] = time.perf_counter()
            return write(samples)

        out_stream.write_frames = first
        return inner(key, in_stream, out_stream, *args, **kwargs)

    embedder.add_stream_watermark = timed
    try:
        _, wall = run_add(argv)
    finally:
        embedder.add_stream_watermark = inner
    return times["first"] - times["call"], wall


def first_writes(raw: str, repeats: int = 3) -> dict:
    """first_write of the unknown-length add of `raw` (16-bit signed
    stereo at 44.1 kHz), with the limiter and without it: the first add
    and the median of `repeats` more."""
    out = {}
    for limiter in (True, False):
        opt = [] if limiter else ["--test-no-limiter"]
        argv = ["--input-format", "raw", "--raw-rate", "44100"] + opt + [
            raw, raw[:-4] + "_first_write.wav", MSG]
        runs = [first_write(argv) for _ in range(repeats + 1)]
        tag = "limiter" if limiter else "no_limiter"
        out[tag] = dict(
            first_s=runs[0][0], first_add_s=runs[0][1],
            warm_s=statistics.median(r[0] for r in runs[1:]),
            warm_add_s=statistics.median(r[1] for r in runs[1:]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("stages", "adds", "first-write"))
    args = ap.parse_args(argv)
    device = torch.device(_device() or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("tile_probe: no CUDA device", file=sys.stderr)
        return 1

    def emit(**fields):
        print(json.dumps(dict(fields, device=str(device)), sort_keys=True),
              flush=True)

    with tempfile.TemporaryDirectory(dir=REPO, prefix=".tile_probe_") as d:
        if args.what == "stages":
            frames, mods, awin = probe_input(fixture(d, 200, 44100),
                                             SIZES[-1], device)
            for row in stage_rows_apart(frames, mods, Params.water_delta,
                                        awin):
                emit(**row)
        elif args.what == "adds":
            for seconds in (200, 60, 30):
                for limiter in (True, False):
                    r = whole_vs_stream(fixture(d, seconds, 44100), limiter)
                    emit(pair="whole_vs_stream", seconds=seconds,
                         limiter=limiter, **{
                             k: r[k] for k in ("lsb_apart", "largest_lsb",
                                               "samples", "whole_s",
                                               "stream_s")})
            for rate in (44100, 32000):
                for limiter in (True, False):
                    r = unknown_vs_known(fixture(d, 60, rate), rate, limiter)
                    emit(pair="unknown_vs_known", seconds=60, rate=rate,
                         limiter=limiter, tile_frames=sorted(set(r["tiles"])),
                         **{k: r[k] for k in ("lsb_apart", "largest_lsb",
                                              "samples", "unknown_s",
                                              "known_s")})
        else:
            emit(**first_writes(fixture(d, 60, 44100)[:-4] + ".raw"))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The robustness matrix of docs/BER.md on the port: rows of carrier x
transform, each with its BER and FER.

    python3 -m audiowmark_tpu_torch.ber_row [--carrier music]
        [--transform speed-mp3:0.9764:128] [--seconds 60] [--seeds 2]
    python3 -m audiowmark_tpu_torch.ber_row --all [--out docs/BER_torch.md]

The recipe of tools/ber_report.py and tools/ber_test.py with the port's
command line.  Carriers: `noise` (test-gen-noise) and the port's copies of
the deterministic generators of tools/ber_report.py (`music`, `speech`,
`chords`, `piano`, `chirp`), sample for sample.  Per row the messages come
from RandomState(42): per seed a random 128-bit message, `-q add --strength
S`, the transform (ROWS below, tools/ber_report.py's), `get` (with
--detect-speed after a speed change), the bit errors of the best pattern (a
file without patterns counts 128 and a frame error).

One row of ROWS, named by its carrier (`noise@200s` for a row at 200 s)
and transform and run at its strength (default: the tonal carrier through
speed-mp3:0.9764:128, which the JAX package fails with BER 0.425781 and
FER 1.0), prints the matrix's `ber` and `fer` lines.  `--all` runs every
row and prints the table in docs/BER.md's format beside docs/BER.md's
numbers (`--out`: also writes it); it exits 1 when a FLOOR row has a frame
error or no CONTROL row has a bit error.

Runs on the CUDA card (AUDIOWMARK_TORCH_DEVICE=cpu: on the CPU).  A row
whose codec library does not load here exits 2 with the library's name.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import io
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np

from .cli import main as cli_main
from .crypto.keys import Key
from .fixtures import gen_noise
from .io import ffshim, lame, vorbis
from .io.wavdata import WavData
from .params import Params
from .utils import log
from .utils.hexbits import bit_str_to_vec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "docs", "BER.md")
SECONDS = 60
DEFAULT_ROW = ("music", "speed-mp3:0.9764:128")

# tools/ber_report.py's ROWS: (carrier, seconds (0: --seconds), transform,
# strength, kind, description)
ROWS = [
    ("noise", 0, "none", "10", "floor", "lossless round trip"),
    ("noise", 0, "mp3:128", "10", "floor",
     "libmp3lame 128 kbit/s (README floor)"),
    ("noise", 0, "mp3:64", "10", "info",
     "libmp3lame 64 kbit/s (below floor)"),
    ("noise", 0, "ogg:128", "10", "floor",
     "libvorbisenc 128 kbit/s managed (README floor)"),
    ("noise", 0, "opus:128", "10", "floor",
     "libopus 128 kbit/s (48 kHz internal)"),
    ("noise", 0, "aac:128", "10", "floor", "native aac 128 kbit/s"),
    ("noise", 0, "resample:48000", "10", "floor",
     "48 kHz resample round trip"),
    ("noise", 0, "double-mp3:64:64", "10", "info",
     "double mp3 transcode 64->64 (ber-double-mp3.sh)"),
    ("noise", 0, "speed-mp3:0.9764:128", "10", "info",
     "speed 0.9764 then mp3 128, decoded --detect-speed (gen-speed-mk.sh)"),
    ("noise", 0, "trunc:15", "10", "info",
     "truncated to 15 s (gen-trunc-mk.sh)"),
    ("noise", 0, "clip:10", "10", "info",
     "random 10 s clip (gen-short-clip-mk.sh)"),
    ("music", 0, "none", "10", "floor", "tonal carrier, lossless round trip"),
    ("music", 0, "mp3:128", "10", "floor", "tonal carrier, mp3 128 (floor)"),
    ("music", 0, "ogg:128", "10", "floor", "tonal carrier, ogg 128 (floor)"),
    ("music", 0, "double-mp3:64:64", "10", "info",
     "tonal carrier, double mp3 transcode 64->64"),
    ("music", 0, "speed-mp3:0.9764:128", "10", "info",
     "tonal carrier, speed 0.9764 then mp3 128, --detect-speed"),
    ("music", 0, "mp3:32", "10", "control",
     "tonal carrier, mp3 32 kbit/s — far below floor control"),
    ("music", 0, "mp3:64", "2", "control",
     "tonal carrier, strength 2 + mp3 64 — weak-mark control"),
    ("speech", 0, "none", "10", "floor", "speech-like AM, lossless"),
    ("speech", 0, "mp3:128", "10", "floor",
     "speech-like AM, mp3 128 (floor)"),
    ("speech", 0, "ogg:128", "10", "floor", "speech-like AM, ogg 128 (floor)"),
    ("speech", 0, "double-mp3:64:64", "10", "info",
     "speech-like AM, double mp3 transcode 64->64"),
    ("chords", 0, "none", "10", "floor", "sustained polyphony, lossless"),
    ("chords", 0, "mp3:128", "10", "floor",
     "sustained polyphony, mp3 128 (floor)"),
    ("piano", 0, "none", "10", "floor",
     "sparse piano w/ silence gaps, lossless"),
    ("piano", 0, "mp3:128", "10", "floor",
     "sparse piano w/ silence gaps, mp3 128 (floor)"),
    ("piano", 0, "ogg:128", "10", "floor",
     "sparse piano w/ silence gaps, ogg 128 (floor)"),
    ("piano", 0, "mp3:32", "10", "control",
     "sparse piano, mp3 32 kbit/s — below-floor control"),
    ("chirp", 0, "none", "10", "floor", "repeating log sweep, lossless"),
    ("chirp", 0, "mp3:128", "10", "floor",
     "repeating log sweep, mp3 128 (floor)"),
    ("noise", 200, "none", "10", "floor",
     "3-block carrier, lossless round trip"),
    ("noise", 200, "mp3:128", "10", "floor",
     "3-block carrier, mp3 128 (floor)"),
    ("noise", 200, "ogg:128", "10", "floor",
     "3-block carrier, ogg 128 (floor)"),
    ("music", 200, "mp3:128", "10", "floor",
     "3-block tonal carrier, mp3 128 (floor)"),
    ("speech", 200, "mp3:128", "10", "floor",
     "3-block speech-like carrier, mp3 128 (floor)"),
    ("piano", 200, "mp3:128", "10", "floor",
     "3-block sparse-piano carrier, mp3 128 (floor)"),
    ("music", 200, "mp3:32", "10", "control",
     "3-block tonal carrier, mp3 32 — below-floor control"),
]

_CODEC = {"mp3": "libmp3lame", "double-mp3": "libmp3lame",
          "speed-mp3": "libmp3lame", "ogg": "libvorbisenc",
          "opus": "libopus (native/libffshim.so)",
          "aac": "aac (native/libffshim.so)"}
_LOADS = {"libmp3lame": lame.available, "libvorbisenc": vorbis.available,
          "libopus (native/libffshim.so)": ffshim.available,
          "aac (native/libffshim.so)": ffshim.available}
_EXT = {"mp3": ".mp3", "ogg": ".ogg", "opus": ".opus", "aac": ".aac",
        "double-mp3": ".mp3", "speed-mp3": ".mp3"}


def codec_of(kind: str):
    """The codec library the transform needs, or None."""
    return _CODEC.get(kind.split(":")[0])


def missing_codec(kind: str):
    """The codec library the transform needs where it does not load here,
    else None."""
    lib = codec_of(kind)
    return lib if lib and not _LOADS[lib]() else None


# ---- carriers: tools/ber_report.py's generators, sample for sample ----

def _save_stereo(path: str, left, right, rate: int, peak: float = 0.6):
    stereo = np.empty(2 * left.size, np.float64)
    stereo[0::2] = left
    stereo[1::2] = right
    m = np.max(np.abs(stereo))
    if m > 0:
        stereo *= peak / m
    WavData(stereo.astype(np.float32), 2, rate, 16).save(path)


def gen_tonal(path: str, seconds: int, rate: int = 44100) -> None:
    """The `music` carrier: pentatonic harmonic stacks with percussion
    ticks."""
    rng = np.random.RandomState(1234)
    t = np.arange(int(seconds * rate)) / rate
    scale = 220.0 * 2.0 ** (np.array([0, 2, 4, 7, 9, 12, 14, 16]) / 12.0)
    note_len = 0.5
    left = np.zeros(t.size, np.float64)
    right = np.zeros(t.size, np.float64)
    for k in range(int(np.ceil(seconds / note_len))):
        f0 = scale[rng.randint(0, scale.size)]
        i0 = int(k * note_len * rate)
        i1 = min(int((k + 1) * note_len * rate), t.size)
        seg = t[i0:i1] - t[i0]
        env = np.minimum(seg / 0.02, 1.0) * np.exp(-seg * 3.0)
        for out, detune in ((left, 1.0), (right, 1.003)):
            tone = np.zeros(seg.size, np.float64)
            for h in range(1, 7):
                tone += np.sin(2 * np.pi * f0 * detune * h * seg
                               + rng.uniform(0, 2 * np.pi)) / h
            out[i0:i1] += env * tone
    for k in range(int(seconds / 0.25)):        # percussion ticks
        i0 = int(k * 0.25 * rate)
        n = int(0.02 * rate)
        if i0 + n > t.size:
            break
        burst = rng.randn(n) * np.exp(-np.arange(n) / (0.004 * rate))
        left[i0:i0 + n] += 0.4 * burst
        right[i0:i0 + n] += 0.4 * burst
    stereo = np.empty(2 * t.size, np.float64)
    stereo[0::2] = left
    stereo[1::2] = right
    stereo *= 0.6 / np.max(np.abs(stereo))
    WavData(stereo.astype(np.float32), 2, rate, 16).save(path)


def gen_speech(path: str, seconds: int, rate: int = 44100) -> None:
    """A 120 Hz harmonic buzz through three formant resonances, syllabic
    3 Hz AM and phrase pauses."""
    rng = np.random.RandomState(77)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    buzz = np.zeros(n, np.float64)
    for h in range(1, 60):
        f = 120.0 * h
        if f > 6000:
            break
        buzz += np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)) / h
    spec = np.fft.rfft(buzz + 0.05 * rng.randn(n))
    freqs = np.fft.rfftfreq(n, 1.0 / rate)
    gain = np.zeros_like(freqs)
    for fc, bw, g in ((700, 130, 1.0), (1200, 180, 0.7), (2600, 300, 0.4)):
        gain += g / (1.0 + ((freqs - fc) / bw) ** 2)
    voiced = np.fft.irfft(spec * gain, n)
    env = 0.25 + 0.75 * np.sin(2 * np.pi * 3.0 * t) ** 2
    for k in range(int(seconds / 2.5)):
        p0 = int((k * 2.5 + 2.0 + rng.uniform(-0.2, 0.2)) * rate)
        env[p0: p0 + int(0.5 * rate)] *= 0.02
    voiced *= env
    _save_stereo(path, voiced, np.roll(voiced, 7), rate)


def gen_chords(path: str, seconds: int, rate: int = 44100) -> None:
    """Sustained polyphonic triads, one chord per 2 s bar, no
    transients."""
    rng = np.random.RandomState(4242)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    left = np.zeros(n, np.float64)
    right = np.zeros(n, np.float64)
    roots = 130.81 * 2.0 ** (np.array([0, 5, 7, 3, 8]) / 12.0)
    for k in range(int(np.ceil(seconds / 2.0))):
        i0 = int(k * 2.0 * rate)
        i1 = min(int((k + 1) * 2.0 * rate), n)
        seg = t[i0:i1] - t[i0]
        env = np.minimum(seg / 0.3, 1.0) * np.minimum(
            (2.0 - seg) / 0.3, 1.0).clip(0.0, 1.0)
        root = roots[k % roots.size]
        for iv in (1.0, 2 ** (4 / 12.0), 2 ** (7 / 12.0), 2.0):
            vib = 1.0 + 0.002 * np.sin(2 * np.pi * 5.0 * seg)
            for h in range(1, 6):
                ph = rng.uniform(0, 2 * np.pi)
                left[i0:i1] += env * np.sin(
                    2 * np.pi * root * iv * h * seg * vib + ph) / h
                right[i0:i1] += env * np.sin(
                    2 * np.pi * root * iv * 1.002 * h * seg * vib + ph) / h
    _save_stereo(path, left, right, rate)


def gen_piano(path: str, seconds: int, rate: int = 44100) -> None:
    """Sparse struck tones gated to exact zero, with 0.8-2 s of digital
    silence between them."""
    rng = np.random.RandomState(31415)
    n = int(seconds * rate)
    left = np.zeros(n, np.float64)
    right = np.zeros(n, np.float64)
    scale = 261.63 * 2.0 ** (np.array([0, 4, 7, 12, 16, 19, -12, -5]) / 12.0)
    pos = 0.0
    while pos < seconds - 1.0:
        f0 = scale[rng.randint(0, scale.size)]
        dur = 0.9
        i0 = int(pos * rate)
        i1 = min(int((pos + dur) * rate), n)
        seg = np.arange(i1 - i0) / rate
        env = np.minimum(seg / 0.005, 1.0) * np.exp(-seg * 6.0)
        gate = np.clip((dur - 0.05 - seg) / 0.05, 0.0, 1.0)
        tone = np.zeros(seg.size, np.float64)
        for h in range(1, 8):
            tone += np.sin(2 * np.pi * f0 * h * seg
                           + rng.uniform(0, 2 * np.pi)) / h ** 1.5
        left[i0:i1] += env * gate * tone
        right[i0:i1] += env * gate * np.roll(tone, 3)
        pos += dur + rng.uniform(0.8, 2.0)
    _save_stereo(path, left, right, rate)


def gen_chirp(path: str, seconds: int, rate: int = 44100) -> None:
    """A repeating 5 s logarithmic sweep 100 Hz -> 8 kHz over a -40 dB
    noise floor."""
    rng = np.random.RandomState(99)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    period = 5.0
    tau = t % period
    f0, f1 = 100.0, 8000.0
    k = np.log(f1 / f0) / period
    phase = 2 * np.pi * f0 * (np.exp(k * tau) - 1.0) / k
    sweep = np.sin(phase) * (0.5 + 0.5 * np.sin(2 * np.pi * tau / period
                                                - np.pi / 2) ** 2)
    noise = 0.01 * rng.randn(n)
    _save_stereo(path, sweep + noise, np.roll(sweep, 11) + noise, rate)


def gen_noise_carrier(path: str, seconds: int, rate: int = 44100) -> None:
    """The `noise` carrier: test-gen-noise with the default key."""
    gen_noise(Key(), path, seconds, rate)


GENERATORS = {"noise": gen_noise_carrier, "music": gen_tonal,
              "speech": gen_speech, "chords": gen_chords, "piano": gen_piano,
              "chirp": gen_chirp}


# ---- tools/ber_test.py's transforms and decode, on the port ----

def _cli(args) -> int:
    Params.reset()
    try:
        return cli_main(args)
    finally:
        Params.reset()
        log.set_log_level(log.Log.INFO)     # -q lowers it for good


def _mp3_roundtrip(w: WavData, bitrate: int) -> WavData:
    with tempfile.NamedTemporaryFile(suffix=".mp3", delete=False) as f:
        f.write(lame.encode_mp3(w.samples, w.n_channels, w.sample_rate,
                                bitrate))
        name = f.name
    try:
        return WavData.load(name)
    finally:
        os.remove(name)


def transform(kind: str, src: str, dst: str, rng) -> None:
    """tools/ber_test.py's transform `kind` of src into dst; `clip` draws
    its start from rng."""
    name, _, arg = kind.partition(":")
    if name == "none":
        shutil.copy(src, dst)
    elif name in ("trunc", "clip"):
        w = WavData.load(src)
        n = int(float(arg) * w.sample_rate) * w.n_channels
        start = 0
        if name == "clip":
            lo = max(w.samples.size - n, 0)
            start = (int(rng.randint(0, lo // w.n_channels + 1))
                     * w.n_channels if lo else 0)
        w.set_samples(w.samples[start:start + n])
        w.save(dst)
    elif name in ("resample", "speed"):
        cmd = "test-resample" if name == "resample" else "test-change-speed"
        if _cli([cmd, src, dst, arg]):
            raise RuntimeError("%s %s failed" % (cmd, arg))
    elif name in ("mp3", "double-mp3", "speed-mp3"):
        if name == "speed-mp3":
            factor, bitrate = arg.split(":")
            mid = dst + ".speed.wav"
            if _cli(["test-change-speed", src, mid, factor]):
                raise RuntimeError("test-change-speed %s failed" % factor)
            w = WavData.load(mid)
            os.remove(mid)
        elif name == "double-mp3":
            b1, bitrate = arg.split(":")
            w = _mp3_roundtrip(WavData.load(src), int(b1))
        else:
            w, bitrate = WavData.load(src), arg
        with open(dst, "wb") as f:
            f.write(lame.encode_mp3(w.samples, w.n_channels, w.sample_rate,
                                    int(bitrate)))
    elif name == "ogg":
        w = WavData.load(src)
        with open(dst, "wb") as f:
            f.write(vorbis.encode_vorbis(w.samples, w.n_channels,
                                         w.sample_rate,
                                         bitrate_kbps=int(arg)))
    elif name in ("opus", "aac"):
        w = WavData.load(src)
        fmt, codec = ("ogg", "libopus") if name == "opus" else ("adts", "aac")
        ffshim.encode_file(dst, fmt, codec, w.samples, w.n_channels,
                           w.sample_rate, int(arg) * 1000)
    else:
        raise ValueError("unknown transform %r" % kind)


def _patterns(path: str, extra):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _cli(["get", path] + extra)
    lines = out.getvalue().splitlines()
    return ([f[2] for f in (line.split() for line in lines)
             if f and f[0] == "pattern"],
            [line for line in lines if line.startswith("speed ")])


def run_row(carrier: str, kind: str, strength: str, seeds: int,
            verbose: bool = False):
    """tools/ber_test.py on one carrier file: (error bits, bits, frame
    errors, frames)."""
    missing = missing_codec(kind)
    if missing:
        raise RuntimeError("%s does not load here" % missing)
    rng = np.random.RandomState(42)
    error_bits = frame_errors = 0
    with tempfile.TemporaryDirectory() as d:
        wm = os.path.join(d, "wm.wav")
        attacked = os.path.join(d, "attacked"
                                + _EXT.get(kind.split(":")[0], ".wav"))
        extra = ["--detect-speed"] if kind.startswith("speed-mp3:") else []
        for seed in range(seeds):
            msg_bits = rng.randint(0, 2, 128)
            msg = "".join("%x" % int("".join(map(str, msg_bits[i:i + 4])), 2)
                          for i in range(0, 128, 4))
            if _cli(["-q", "add", "--strength", strength, carrier, wm, msg]):
                raise RuntimeError("add failed")
            transform(kind, wm, attacked, rng)
            patterns, speed = _patterns(attacked, extra)
            errs = min((int(np.sum(np.array(bit_str_to_vec(p)) != msg_bits))
                        for p in patterns), default=128)
            if verbose:
                print("seed %d: %d patterns, best %d bit errors%s"
                      % (seed, len(patterns), errs,
                         ", " + speed[0] if speed else ""), flush=True)
            error_bits += errs
            frame_errors += errs > 0
    return error_bits, 128 * seeds, frame_errors, seeds


def label(carrier: str, row_seconds: int, seconds: int = SECONDS) -> str:
    secs = row_seconds or seconds
    return carrier if secs == seconds else "%s@%ds" % (carrier, secs)


def carrier_file(carriers: dict, d: str, name: str, secs: int) -> str:
    """The carrier's file, made in d at its first use; carriers maps
    (name, seconds) to a file and may be given files made elsewhere."""
    if (name, secs) not in carriers:
        path = os.path.join(d, "%s_%d.wav" % (name, secs))
        GENERATORS[name](path, secs)
        carriers[(name, secs)] = path
    return carriers[(name, secs)]


def run_rows(rows, seconds: int = SECONDS, seeds: int = 2, carriers=None,
             on_row=None):
    """Each row of `rows` (ROWS' form) -> a dict with its label, transform,
    strength, kind, note, (error bits, bits, frame errors, frames) and wall
    seconds; on_row(result) is called after each."""
    carriers = {} if carriers is None else dict(carriers)
    out = []
    with tempfile.TemporaryDirectory() as d:
        for carrier, row_secs, kind, strength, kind_, note in rows:
            secs = row_secs or seconds
            path = carrier_file(carriers, d, carrier, secs)
            t0 = time.perf_counter()
            counts = run_row(path, kind, strength, seeds)
            out.append(dict(label=label(carrier, row_secs, seconds),
                            transform=kind, strength=strength, kind=kind_,
                            note=note, counts=counts,
                            seconds=time.perf_counter() - t0))
            if on_row:
                on_row(out[-1])
    return out


def _rate(err, total):
    return "%.6f (%d/%d)" % (err / max(total, 1), err, total)


def reference_rows(path: str = REFERENCE) -> dict:
    """docs/BER.md's table: {(label, transform, strength): (BER, FER)}."""
    if not os.path.exists(path):
        return {}
    rows = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"\| (\S+) \| `([^`]+)` \| (\S+) \| \S+ \| ([^|]+) "
                         r"\| ([^|]+) \|", line)
            if m:
                rows[m.group(1, 2, 3)] = (m.group(4).strip(),
                                          m.group(5).strip())
    return rows


def row_line(r) -> str:
    e, n, fe, fn = r["counts"]
    return ("%-11s %-22s s=%-3s %-7s ber=%s  fer=%s  %.1f s"
            % (r["label"], r["transform"], r["strength"], r["kind"],
               _rate(e, n), _rate(fe, fn), r["seconds"]))


def table(results, command: str, where: str) -> str:
    """The matrix in docs/BER.md's table format, docs/BER.md's numbers
    beside the port's."""
    ref = reference_rows()
    lines = [
        "# BER / FER robustness report — the PyTorch port",
        "",
        "The attack matrix of docs/BER.md (tools/ber_report.py's rows, "
        "carriers and transforms) run on `audiowmark_tpu_torch` %s, beside "
        "the JAX package's numbers from docs/BER.md.  %d s carriers unless "
        "tagged `@200s`, 44.1 kHz stereo, the same random 128-bit payloads "
        "per row (RandomState(42), as tools/ber_test.py draws them)."
        % (where, SECONDS),
        "",
        "| carrier | transform | strength | kind | BER | FER "
        "| docs/BER.md BER | docs/BER.md FER | note |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        e, n, fe, fn = r["counts"]
        jb, jf = ref.get((r["label"], r["transform"], r["strength"]),
                         ("not in docs/BER.md",) * 2)
        lines.append("| %s | `%s` | %s | %s | %s | %s | %s | %s | %s |"
                     % (r["label"], r["transform"], r["strength"],
                        r["kind"].upper(), _rate(e, n), _rate(fe, fn), jb, jf,
                        r["note"]))
    lines += ["", "Generated by `%s` on %s." % (
        command, datetime.date.today().isoformat())]
    return "\n".join(lines) + "\n"


def verdict(results):
    """(FLOOR rows with a frame error, whether a CONTROL row erred or none
    ran)."""
    bad = [(r["label"], r["transform"]) for r in results
           if r["kind"] == "floor" and r["counts"][2]]
    controls = [r["counts"][0] for r in results if r["kind"] == "control"]
    return bad, not controls or max(controls) > 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true",
                    help="every row of the matrix")
    ap.add_argument("--out", help="with --all: write the table here")
    ap.add_argument("--carrier", default=DEFAULT_ROW[0],
                    help="the row's carrier, e.g. music or noise@200s")
    ap.add_argument("--transform", default=DEFAULT_ROW[1])
    ap.add_argument("--seconds", type=int, default=SECONDS)
    ap.add_argument("--seeds", type=int, default=2)
    args = ap.parse_args(argv)

    rows = ROWS if args.all else [
        r for r in ROWS if label(r[0], r[1], args.seconds) == args.carrier
        and r[2] == args.transform]
    if not rows:
        print("ber_row: no row %s %s" % (args.carrier, args.transform),
              file=sys.stderr)
        return 2
    missing = sorted({missing_codec(r[2]) for r in rows} - {None})
    if missing:
        print("ber_row: %s not loading here" % ", ".join(missing),
              file=sys.stderr)
        return 2
    if not args.all:
        carrier, row_secs, kind, strength = rows[0][:4]
        secs = row_secs or args.seconds
        with tempfile.TemporaryDirectory() as d:
            e, n, fe, fn = run_row(carrier_file({}, d, carrier, secs), kind,
                                   strength, args.seeds, verbose=True)
        print("transform=%s strength=%s carrier=%s seconds=%d seeds=%d"
              % (kind, strength, carrier, secs, args.seeds))
        print("ber " + _rate(e, n))
        print("fer " + _rate(fe, fn))
        return 0

    results = run_rows(rows, args.seconds, args.seeds,
                       on_row=lambda r: print(row_line(r), flush=True))
    command = "python3 -m audiowmark_tpu_torch.ber_row " + " ".join(
        sys.argv[1:] if argv is None else argv)
    where = ("on the CPU" if os.environ.get("AUDIOWMARK_TORCH_DEVICE")
             == "cpu" else "on the CUDA card")
    text = table(results, command, where)
    print(text, end="")
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    bad, controls_err = verdict(results)
    if bad:
        print("FLOOR VIOLATION: %s" % bad, file=sys.stderr)
    if not controls_err:
        print("no CONTROL row produced a bit error", file=sys.stderr)
    return 1 if bad or not controls_err else 0


if __name__ == "__main__":
    sys.exit(main())

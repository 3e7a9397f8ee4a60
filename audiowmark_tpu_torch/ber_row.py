"""One row of the robustness matrix (docs/BER.md) on the port: the tonal
carrier through `speed-mp3:0.9764:128`, decoded with --detect-speed.

    python3 -m audiowmark_tpu_torch.ber_row [--seconds 60] [--seeds 2]

The recipe of tools/ber_report.py and tools/ber_test.py with the port's
command line: a deterministic tonal fixture (pentatonic harmonic stacks with
percussion ticks, the `music` carrier), and per seed a random 128-bit
message: add at strength 10, test-change-speed 0.9764, mp3 at 128 kbit/s
(libmp3lame), `get --detect-speed`, the bit errors of the best pattern
(a file without patterns counts 128).  Prints the matrix's `ber` and `fer`
lines.  The JAX package gives BER 0.425781 (109/256) and FER 1.0 (2/2) on
this row at 60 s and 2 seeds; the port is to reproduce that, not to repair
it.

Runs on the CUDA card (AUDIOWMARK_TORCH_DEVICE=cpu: on the CPU).  Where
libmp3lame does not load the script says so and exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import tempfile

import numpy as np

from .cli import main as cli_main
from .io import lame
from .io.wavdata import WavData
from .params import Params
from .utils.hexbits import bit_str_to_vec

TRANSFORM = ("0.9764", 128)


def gen_tonal(path: str, seconds: int, rate: int = 44100) -> None:
    """tools/ber_report.py's `music` carrier, sample for sample."""
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


def _cli(args) -> int:
    Params.reset()
    try:
        return cli_main(args)
    finally:
        Params.reset()


def _patterns(path: str):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _cli(["get", path, "--detect-speed"])
    lines = out.getvalue().splitlines()
    return ([f[2] for f in (line.split() for line in lines)
             if f and f[0] == "pattern"],
            [line for line in lines if line.startswith("speed ")])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=int, default=60)
    ap.add_argument("--seeds", type=int, default=2)
    args = ap.parse_args(argv)
    if not lame.available():
        print("ber_row: libmp3lame does not load here", file=sys.stderr)
        return 2

    rng = np.random.RandomState(42)
    factor, bitrate = TRANSFORM
    error_bits = frame_errors = 0
    with tempfile.TemporaryDirectory() as d:
        carrier, wm = os.path.join(d, "music.wav"), os.path.join(d, "wm.wav")
        fast, mp3 = os.path.join(d, "fast.wav"), os.path.join(d, "a.mp3")
        gen_tonal(carrier, args.seconds)
        for seed in range(args.seeds):
            msg_bits = rng.randint(0, 2, 128)
            msg = "".join("%x" % int("".join(map(str, msg_bits[i:i + 4])), 2)
                          for i in range(0, 128, 4))
            if _cli(["-q", "add", "--strength", "10", carrier, wm, msg]) \
                    or _cli(["test-change-speed", wm, fast, factor]):
                print("ber_row: add or test-change-speed failed",
                      file=sys.stderr)
                return 1
            w = WavData.load(fast)
            with open(mp3, "wb") as f:
                f.write(lame.encode_mp3(w.samples, w.n_channels,
                                        w.sample_rate, bitrate))
            patterns, speed = _patterns(mp3)
            errs = min((int(np.sum(np.array(bit_str_to_vec(p)) != msg_bits))
                        for p in patterns), default=128)
            print("seed %d: %d patterns, best %d bit errors, %s"
                  % (seed, len(patterns), errs, speed or "no speed line"))
            error_bits += errs
            frame_errors += errs > 0
    total = 128 * args.seeds
    print("transform=speed-mp3:%s:%d strength=10 carrier=music seconds=%d "
          "seeds=%d" % (factor, bitrate, args.seconds, args.seeds))
    print("ber %.6f (%d/%d)" % (error_bits / total, error_bits, total))
    print("fer %.6f (%d/%d)" % (frame_errors / args.seeds, frame_errors,
                                args.seeds))
    return 0


if __name__ == "__main__":
    sys.exit(main())

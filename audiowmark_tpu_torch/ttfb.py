"""Streaming time to first byte of the port's add (the port's copy of
tools/ttfb_test.py; reference: src/ttfb-test.py).

    python3 -m audiowmark_tpu_torch.ttfb [--input-format raw --raw-rate R]
        <input> [message_hex]

Feeds <input> on stdin to `python -m audiowmark_tpu_torch -q add
--output-format wav-pipe - - <msg>` through pipes and measures the wall
time until the first watermarked byte appears on its stdout, plus total
throughput.  A WAV input states its length; raw PCM (`--input-format raw`:
16-bit signed little-endian stereo at --raw-rate) does not, and the add
then reads tiles that ramp up from 16 frames.

The add runs where the port's command line runs: on the CUDA card, or on
the CPU with AUDIOWMARK_TORCH_DEVICE=cpu.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(infile: str, msg: str = "f0" * 16, add_options=(),
            sink=None) -> tuple:
    """(s to the first byte, s in all, bytes) of the port's add of
    `infile` fed on stdin; `sink`: a binary file that receives the bytes."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    start = time.monotonic()
    with open(infile, "rb") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "audiowmark_tpu_torch", "-q", "add",
             "--output-format", "wav-pipe"] + list(add_options)
            + ["-", "-", msg], stdin=f, stdout=subprocess.PIPE, env=env,
            cwd=REPO)
        chunk = proc.stdout.read(1)
        ttfb = time.monotonic() - start
        total = 0
        while chunk:
            total += len(chunk)
            if sink is not None:
                sink.write(chunk)
            chunk = proc.stdout.read(1 << 20)
        elapsed = time.monotonic() - start
        if proc.wait() != 0:
            raise RuntimeError("the add exited %d" % proc.returncode)
    return ttfb, elapsed, total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input-format")
    ap.add_argument("--raw-rate", type=int)
    ap.add_argument("input")
    ap.add_argument("message_hex", nargs="?", default="f0" * 16)
    args = ap.parse_args(argv)
    options = []
    if args.input_format:
        options += ["--input-format", args.input_format]
    if args.raw_rate:
        options += ["--raw-rate", str(args.raw_rate)]
    ttfb, elapsed, total = measure(args.input, args.message_hex, options)
    print("ttfb %.3f s" % ttfb)
    print("total %.3f s, %d bytes (%.1f MB/s)"
          % (elapsed, total, total / max(elapsed, 1e-9) / 1e6))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

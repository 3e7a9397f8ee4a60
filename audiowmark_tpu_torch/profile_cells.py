"""Where the time goes in the port's add and get, on one CUDA card.

    python3 -m audiowmark_tpu_torch.profile_cells [--out FILE]

Makes the fixtures of chip_smoke.py in a temporary directory (200 s of
the CLI's test-gen-noise at 44.1 and at 32 kHz, 32 min of seeded noise at
44.1 kHz) and drives six calls through the user's entry points: add, then
get as `cmp`, of each.  Every call runs four times:

  1. first: the first call of its kind in the process (cuFFT plans,
     allocator growth), wall seconds;
  2. warm: wall seconds, synchronised, no profiler;
  3. under torch.profiler (CPU and CUDA activities): the wall of that run,
     the device time as the union of the intervals of every kernel and
     copy on the card, the busy share (device time / that wall) and the
     device operations that took longest;
  4. under cProfile: the host functions with the most own time (cProfile
     slows Python code, so these shares are relative).

One line per call goes to standard output; the full report goes to FILE
(default: profile_cells.txt in the working directory).
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import io
import os
import pstats
import sys
import tempfile
import time
from collections import defaultdict

import torch

MSG = "0123456789abcdef0011223344556677"
LONG_SECONDS = 32 * 60


def _busy_intervals(events):
    """(union of the device intervals in ms, ms per device op name)."""
    spans, per_name = [], defaultdict(float)
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        per_name[ev.name] += (end - start) / 1e3
    spans.sort()
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3, per_name


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_call(name, fn, report):
    first_s = _timed(fn)
    warm_s = _timed(fn)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_s = _timed(fn)
    device_ms, per_name = _busy_intervals(prof.events())
    cp = cProfile.Profile()
    cp.enable()
    cprof_s = _timed(fn)
    cp.disable()

    line = ("=== %s first_s=%.4f warm_s=%.4f profiled_s=%.4f device_ms=%.2f "
            "busy=%.4f cprofile_s=%.4f" % (name, first_s, warm_s, prof_s,
                                           device_ms, device_ms / 1e3 / prof_s,
                                           cprof_s))
    print(line, flush=True)
    report.append(line)
    report.append("  device ops by total ms:")
    for op, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:10]:
        report.append("    %10.3f  %s" % (ms, op[:100]))
    report.append("  host functions by own time (cProfile):")
    out = io.StringIO()
    pstats.Stats(cp, stream=out).sort_stats("tottime").print_stats(12)
    report.extend("    " + ln for ln in out.getvalue().splitlines()
                  if ln.strip())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_cells.txt")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_cells: no CUDA device", file=sys.stderr)
        return 1

    from audiowmark_tpu.crypto.keys import Key

    from . import add_watermark, get_watermark
    from .fixtures import gen_noise, long_noise

    key = Key()
    report = ["card: %s" % torch.cuda.get_device_name(0)]

    def add(src, dst):
        info = io.StringIO()
        with contextlib.redirect_stderr(info):
            rc = add_watermark(key, src, dst, MSG)
        if rc != 0:
            raise SystemExit("profile_cells: add of %s failed:\n%s"
                             % (src, info.getvalue()))

    def cmp(path, expect):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = get_watermark([key], path, MSG)
        if rc != 0 or (expect is not None and ("\nmatch_count %d " % expect)
                       not in "\n" + out.getvalue()):
            raise SystemExit("profile_cells: cmp of %s: rc %d, expected "
                             "match_count %s:\n%s"
                             % (path, rc, expect, out.getvalue()))

    with tempfile.TemporaryDirectory(dir=".", prefix=".profile_cells_") as d:
        def path(name):
            return os.path.join(d, name)

        gen_noise(key, path("n44.wav"), 200, 44100)
        gen_noise(key, path("n32.wav"), 200, 32000)
        long_noise(1, path("nlong.wav"), LONG_SECONDS, 44100)
        calls = [
            ("add_44k_200s", lambda: add(path("n44.wav"), path("w44.wav"))),
            ("get_44k_200s", lambda: cmp(path("w44.wav"), 5)),
            ("add_32k_200s", lambda: add(path("n32.wav"), path("w32.wav"))),
            ("get_32k_200s", lambda: cmp(path("w32.wav"), 5)),
            ("add_44k_32min",
             lambda: add(path("nlong.wav"), path("wlong.wav"))),
            ("get_44k_32min", lambda: cmp(path("wlong.wav"), None)),
        ]
        for name, fn in calls:
            profile_call(name, fn, report)

    with open(args.out, "w") as f:
        f.write("\n".join(report) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The `get_speed` entry: one client scans WAV files whose replay speed may
have been changed, with get_watermark and --detect-speed.

Set-up first holds the configuration's `get` section to the port's named
speed constants (a program that lacks them, or differs, stops there).  It
then makes the traffic's pool under the run's TMPDIR as the `get` entry
does: files of fixed lengths cut from the seeded carriers, a share of them
excerpts of tracks that the plain reference marked (wmbench/reference/
mark.py), each track with its own message, each excerpt starting at a
seeded sample offset; each marked excerpt is then replayed at its slot's
speed, the traffic's `speeds` in slot order, by the reference's resample
at ratio 1 / speed with the rate kept (upstream's test-change-speed).
Every file is scanned once before the window.  A request is
`get_watermark([key], file, "")` with Params.detect_speed on, on the next
file of a seeded order; its answer is the ResultSet the program reports,
each pattern with its speed, and the speed detect_speed accepted.
Requests run on the cell's cards alone: with one card,
AUDIOWMARK_MULTICHIP=0 keeps the speed scan's centres (and a long file's
chunk groups) off the host's other cards.  After the window a seeded
sample of the answers, with the longest file's first, is held against the
reference (wmbench/reference/speed.py, judge_speed.py): the speed, the
patterns at speed 1, the program's input resampled at its speed (caught
where the getter makes it) against the reference's resample, and the
patterns the program decoded there against the reference's decode of the
same input.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import numpy as np
import torch

from wmbench.lib import carriers, pool, program, spec
from wmbench.lib.spans import program_spans
from wmbench.reference import judge_speed, mark
from wmbench.reference import speed as speed_ref
from wmbench.reference.keyed import Geom
from wmbench.reference.prec import Prec

MULTICHIP = "AUDIOWMARK_MULTICHIP"
# the `get` entry beside this one: its answers' form
_GET = spec.module("entries", "get", os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# the configuration's `get` keys and the names of models/speed.py's
# constants they must equal
_SPEED = {"n_best": "N_BEST", "clip_candidates": "CLIP_CANDIDATES",
          "smooth_distance": "SMOOTH_DISTANCE",
          "accept_quality": "ACCEPT_QUALITY", "accept_band": "ACCEPT_BAND"}
_SCANS = {"scan1": "SCAN1", "scan2": "SCAN2", "scan3": "SCAN3"}
_SCAN_KEYS = ("seconds", "step", "n_steps", "n_center_steps")


def check_speed(cfg: Dict) -> None:
    """Raise where the configuration's speed search is not the one the
    port runs (program.configure does the same for the geometry)."""
    from audiowmark_tpu_torch.models import speed

    get = cfg["get"]
    if get["detect_speed"] != "normal":
        raise ValueError("the entry runs --detect-speed, not %r"
                         % get["detect_speed"])
    want = {name: get[k] for k, name in _SPEED.items()}
    want.update({name: [get["scans"][k][p] for p in _SCAN_KEYS]
                 for k, name in _SCANS.items()})
    for name, value in want.items():
        if not hasattr(speed, name):
            raise ValueError("the program names no speed constant %s"
                             % name)
        have = getattr(speed, name)
        if (list(have) if isinstance(have, tuple) else have) != value:
            raise ValueError("the program's %s is %r, the configuration "
                             "states %r" % (name, have, value))


class Session:
    def __init__(self, ctx):
        from audiowmark_tpu_torch.params import Params

        check_speed(ctx.config)
        self.ctx = ctx
        mix = ctx.traffic["pool"]
        audio = ctx.config["audio"]
        rate, C = audio["sample_rate"], audio["channels"]
        self.rate = rate
        self.geom = Geom.from_config(ctx.config)
        self.sgeom = speed_ref.SpeedGeom.from_config(ctx.config)
        self.dev = ctx.devices[0]
        rng = np.random.default_rng(ctx.seed)
        N = mix["files"]
        secs = pool.lengths(*mix["seconds"], N)
        kinds = pool.by_slot(N, mix["carriers"])
        peaks = pool.by_slot(N, mix["peaks"])
        marked = pool.marks(N, mix["marked_share"])
        if len(mix["speeds"]) != sum(marked):
            raise ValueError("%d speeds for %d marked slots"
                             % (len(mix["speeds"]), sum(marked)))
        speeds = iter(mix["speeds"])
        self.speeds = [next(speeds) if m else 1.0 for m in marked]
        self.key_bytes = rng.bytes(16)
        cseeds = {c: int(rng.integers(2 ** 31)) for c in mix["carriers"]}
        lo, hi = mix["offset_seconds"]
        offs = [int(rng.integers(int(lo * rate), int(hi * rate))) if m else 0
                for m in marked]
        track = [int(s * rate) + o for s, o in zip(secs, offs)]
        lead = int(mix["carrier_lead_seconds"] * rate)
        starts = [int(rng.integers(lead)) for _ in range(N)]
        need = max(t + s for t, s in zip(track, starts))
        long = {c: carriers.GENERATORS[c](need / rate + 1, rate, cseeds[c],
                                          1.0, self.dev)
                for c in mix["carriers"]}

        f64 = Prec("f64")
        self.samples, self.truth, self.paths, self.seconds = [], [], [], []
        for i in range(N):
            seg = long[kinds[i]][starts[i]:starts[i] + track[i], :C]
            seg = seg * (peaks[i] / torch.max(torch.abs(seg)))
            pcm = carriers.to_int16(seg)
            truth = None
            if marked[i]:
                truth = rng.integers(0, 2, self.geom.payload_size)
                pcm = mark.mark(pcm, rate, self.key_bytes, truth, self.geom,
                                f64, self.dev)
            pcm = pcm[offs[i]:offs[i] + int(secs[i] * rate)]
            if self.speeds[i] != 1.0:
                pcm = speed_ref.change_speed(pcm, self.speeds[i], f64,
                                             self.dev)
            path = os.path.join(ctx.tmpdir, "speed%02d.wav" % i)
            pool.write_wav(path, pcm, rate)
            self.samples.append(pcm)
            self.truth.append(truth)
            self.paths.append(path)
            self.seconds.append(pcm.shape[0] / rate)
        del long

        program.configure(ctx.config)
        Params.detect_speed = True
        self.key = program.load_key(ctx.tmpdir, self.key_bytes)
        self._answer = None
        self._speeds = []
        self._resampled = None
        self._refs: Dict[int, speed_ref.Reference] = {}
        for i in range(N):                       # every shape, once
            self._scan(i)
        self.order = pool.cycle(rng, self.seconds)
        self.sample = pool.Sample(ctx.seed, ctx.traffic["check"]["sample"])
        self.longest = int(np.argmax(self.seconds))

    @contextlib.contextmanager
    def _call(self):
        """One get_watermark call: its ResultSet and detected speeds
        caught where the program makes them, on the cell's cards alone."""
        from audiowmark_tpu_torch.models import getter

        report0, detect0 = getter.report, getter.detect_speed
        resample0 = getter.resample_ratio
        env0 = os.environ.get(MULTICHIP)

        def report(result_set, time_length, orig_bits):
            self._answer = result_set
            return report0(result_set, time_length, orig_bits)

        def detect(*args, **kw):
            found = detect0(*args, **kw)
            self._speeds = [s for _, s in found]
            return found

        def resample(*args, **kw):
            out = resample0(*args, **kw)
            self._resampled = out.samples
            return out

        getter.report, getter.detect_speed = report, detect
        getter.resample_ratio = resample
        if len(self.ctx.devices) == 1:
            os.environ[MULTICHIP] = "0"
        try:
            yield
        finally:
            getter.report, getter.detect_speed = report0, detect0
            getter.resample_ratio = resample0
            if env0 is None:
                os.environ.pop(MULTICHIP, None)
            else:
                os.environ[MULTICHIP] = env0

    def _scan(self, f: int):
        from audiowmark_tpu_torch.models import getter

        self._answer, self._speeds, self._resampled = None, [], None
        with self._call():
            rc = getter.get_watermark([self.key], self.paths[f], "",
                                      device=self.dev)
        return rc == 0 and self._answer is not None

    def request(self, i: int):
        f = next(self.order)
        ok = self._scan(f)
        if ok:
            speed = self._speeds[0] if self._speeds else None
            ans = (f, [_pattern(p) for p in self._answer.patterns], speed,
                   self._resampled if speed is not None else None)
            if f == self.longest and not self.sample.always:
                self.sample.always.append(ans)
            else:
                self.sample.offer(ans)
        return self.seconds[f], ok

    def spans(self):
        return program_spans(self.ctx.counters)

    def release(self) -> None:
        self._answer = None
        program.release()

    def _reference(self, f: int) -> speed_ref.Reference:
        if f not in self._refs:
            self._refs[f] = speed_ref.reference(
                self.samples[f], self.key_bytes, self.geom, self.sgeom,
                Prec("f64"), self.dev)
        return self._refs[f]

    def _judge(self, f: int, patterns, speed, resampled, detail=None):
        """One answer against the float64 reference: its speed, its
        speed-1 patterns, and where it accepted a speed its resampled
        input ((n * C,) float32) and the patterns it decoded there."""
        ref = self._reference(f)
        at = None
        lsb = 0.0
        if speed is not None:
            y = resampled.reshape(-1, self.samples[f].shape[1]) \
                .astype(np.float64) * 32768.0
            lsb = judge_speed.resample_lsb(y, speed_ref.at_speed(
                self.samples[f], speed, Prec("f64"), self.dev))
            at = speed_ref.patterns(y, self.key_bytes, self.geom,
                                    Prec("f64"), self.dev)
        row = judge_speed.file_numbers(patterns, speed, ref, at,
                                       self.truth[f], self.geom,
                                       self.sgeom, detail)
        row["speed_resample_lsb"] = lsb
        return row

    def check(self, prec: Prec, detail=None) -> Dict[str, float]:
        """The sampled answers against the float64 reference (the harness
        passes f64)."""
        return judge_speed.worst([self._judge(*a, detail=detail)
                                  for a in self.sample.items()])

    def control(self, prec: Prec) -> Dict[str, float]:
        """The reference in `prec` put in the program's place: its speed,
        its resample at that speed and its own patterns at speed 1 and
        there (upstream's selections), judged as the program's are."""
        rows = []
        for f in sorted({a[0] for a in self.sample.items()}):
            ctl = speed_ref.reference(self.samples[f], self.key_bytes,
                                      self.geom, self.sgeom, prec,
                                      self.dev, extra=0, tie=0.0)
            sp = ctl.detected.speed
            answer = [_ref_answer(r, self.rate, 1.0) for r in ctl.patterns]
            resampled = None
            if sp is not None:
                y = speed_ref.at_speed(self.samples[f], sp, prec, self.dev)
                answer += [_ref_answer(r, int(self.rate * sp), sp) for r in
                           speed_ref.patterns(y, self.key_bytes, self.geom,
                                              prec, self.dev, extra=0)]
                resampled = (y / 32768.0).astype(np.float32).reshape(-1)
            rows.append(self._judge(f, answer, sp, resampled))
        return judge_speed.worst(rows)


def _ref_answer(r, rate: int, speed: float) -> dict:
    return dict(_GET._ref_answer(r, rate), speed=speed)


def _pattern(p) -> dict:
    return dict(_GET._pattern(p), speed=p.speed)

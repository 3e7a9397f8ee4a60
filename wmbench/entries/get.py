"""The `get` entry: one client scans WAV files with get_watermark.

Set-up makes the traffic's pool under the run's TMPDIR: files of fixed
lengths cut from the seeded carriers, a share of them excerpts of tracks
that the plain reference marked (wmbench/reference/mark.py), each track
with its own message, each excerpt starting at a seeded sample offset.
Every file is scanned once before the window (its shapes warm).  A request
is `get_watermark([key], file, "")` on the next file of a seeded order;
its answer is the ResultSet the program reports, taken at the program's
`report`.  After the window a seeded sample of the answers, with the
longest file's first, is held against the reference's patterns
(wmbench/reference/scan.py, judge.py).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from wmbench.lib import carriers, pool, program
from wmbench.lib.spans import program_spans
from wmbench.reference import judge, mark, scan
from wmbench.reference.keyed import Geom
from wmbench.reference.prec import Prec


class Session:
    def __init__(self, ctx):
        from audiowmark_tpu_torch.models import getter

        self.ctx = ctx
        mix = ctx.traffic["pool"]
        audio = ctx.config["audio"]
        rate, C = audio["sample_rate"], audio["channels"]
        self.rate = rate
        self.geom = Geom.from_config(ctx.config)
        self.dev = ctx.devices[0]
        rng = np.random.default_rng(ctx.seed)
        N = mix["files"]
        secs = pool.lengths(*mix["seconds"], N)
        kinds = pool.by_slot(N, mix["carriers"])
        peaks = pool.by_slot(N, mix["peaks"])
        marked = pool.marks(N, mix["marked_share"])
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

        self.samples, self.truth, self.paths, self.seconds = [], [], [], []
        for i in range(N):
            seg = long[kinds[i]][starts[i]:starts[i] + track[i], :C]
            seg = seg * (peaks[i] / torch.max(torch.abs(seg)))
            pcm = carriers.to_int16(seg)
            truth = None
            if marked[i]:
                truth = rng.integers(0, 2, self.geom.payload_size)
                pcm = mark.mark(pcm, rate, self.key_bytes, truth, self.geom,
                                Prec("f64"), self.dev)
            pcm = pcm[offs[i]:offs[i] + int(secs[i] * rate)]
            path = os.path.join(ctx.tmpdir, "scan%02d.wav" % i)
            pool.write_wav(path, pcm, rate)
            self.samples.append(pcm)
            self.truth.append(truth)
            self.paths.append(path)
            self.seconds.append(pcm.shape[0] / rate)
        del long

        program.configure(ctx.config)
        self.key = program.load_key(ctx.tmpdir, self.key_bytes)
        self._get = getter.get_watermark
        report0 = getter.report

        def report(result_set, time_length, orig_bits):
            self._answer = result_set
            return report0(result_set, time_length, orig_bits)

        getter.report = report
        self._answer = None
        for i in range(N):                       # every shape, once
            self._scan(i)
        self.order = pool.cycle(rng, self.seconds)
        self.sample = pool.Sample(ctx.seed, ctx.traffic["check"]["sample"])
        self.longest = int(np.argmax(self.seconds))

    def _scan(self, f: int):
        self._answer = None
        rc = self._get([self.key], self.paths[f], "", device=self.dev)
        return rc == 0 and self._answer is not None

    def request(self, i: int):
        f = next(self.order)
        ok = self._scan(f)
        if ok:
            ans = (f, [_pattern(p) for p in self._answer.patterns])
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

    def check(self, prec: Prec, detail=None) -> Dict[str, float]:
        rows, refs = [], {}
        for f, patterns in self.sample.items():
            if f not in refs:
                refs[f] = scan.reference_patterns(
                    self.samples[f], self.key_bytes, self.geom, prec,
                    self.dev)
            rows.append(judge.scan_numbers(patterns, refs[f], self.truth[f],
                                           self.rate, detail))
        return judge.worst(rows)

    def control(self, prec: Prec) -> Dict[str, float]:
        """The reference in `prec` put in the program's place: its own
        patterns of the sampled files (upstream's selection) judged as
        the program's are."""
        rows = []
        for f in sorted({f for f, _ in self.sample.items()}):
            ctl = scan.reference_patterns(self.samples[f], self.key_bytes,
                                          self.geom, prec, self.dev, extra=0)
            refs = scan.reference_patterns(self.samples[f], self.key_bytes,
                                           self.geom, Prec("f64"), self.dev)
            rows.append(judge.scan_numbers(
                [_ref_answer(r, self.rate) for r in ctl], refs,
                self.truth[f], self.rate))
        return judge.worst(rows)


def _ref_answer(r, rate: int) -> dict:
    return {"kind": r.kind, "block_type": r.block_type,
            "time": r.index / rate, "quality": r.quality, "error": r.error,
            "bits": list(r.bits)}


def _pattern(p) -> dict:
    return {"kind": p.type.name.lower(), "block_type": p.sync_block_type.name,
            "time": p.time, "quality": p.sync_quality,
            "error": p.decode_error, "bits": list(p.bit_vec)}

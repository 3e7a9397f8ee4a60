"""The `detect_batch` entry: one client scans batches of streams with the
fleet API, `parallel.detect_batch(key, audio, top_k)`, over every card of
the default mesh.

Set-up makes the traffic's pool of equal-length stereo streams on the
host (float32 at the 16-bit values, so that the reference reads the same
samples): a share cut from tracks that the plain reference marked, each
with a message of its own, at seeded offsets.  A request is one batch of
the pool's streams in a fresh seeded order; its answer is the arrays the
call returns.  After the window, a seeded sample of the streams of a
seeded sample of the answers, the same number from each card's share, is
held against the reference's block candidates
(wmbench/reference/scan.py, judge.py).
"""

from __future__ import annotations

import random
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
        from audiowmark_tpu_torch.parallel import detect_batch

        self.ctx = ctx
        mix = ctx.traffic["pool"]
        audio = ctx.config["audio"]
        rate, C = audio["sample_rate"], audio["channels"]
        self.rate = rate
        self.geom = Geom.from_config(ctx.config)
        self.dev = ctx.devices[0]
        rng = np.random.default_rng(ctx.seed)
        N = mix["streams"]
        n = int(mix["seconds"] * rate)
        kinds = pool.by_slot(N, mix["carriers"])
        peaks = pool.by_slot(N, mix["peaks"])
        marked = pool.marks(N, mix["marked_share"])
        self.key_bytes = rng.bytes(16)
        cseeds = {c: int(rng.integers(2 ** 31)) for c in mix["carriers"]}
        lo, hi = mix["offset_seconds"]
        offs = [int(rng.integers(int(lo * rate), int(hi * rate))) if m else 0
                for m in marked]
        lead = int(mix["carrier_lead_seconds"] * rate)
        starts = [int(rng.integers(lead)) for _ in range(N)]
        need = max(n + o + s for o, s in zip(offs, starts))
        long = {c: carriers.GENERATORS[c](need / rate + 1, rate, cseeds[c],
                                          1.0, self.dev)
                for c in mix["carriers"]}
        self.pcm = np.empty((N, n, C), np.int16)
        self.truth = []
        for i in range(N):
            seg = long[kinds[i]][starts[i]:starts[i] + n + offs[i], :C]
            pcm = carriers.to_int16(seg * (peaks[i]
                                           / torch.max(torch.abs(seg))))
            truth = None
            if marked[i]:
                truth = rng.integers(0, 2, self.geom.payload_size)
                pcm = mark.mark(pcm, rate, self.key_bytes, truth, self.geom,
                                Prec("f64"), self.dev)
            self.pcm[i] = pcm[offs[i]:offs[i] + n]
            self.truth.append(truth)
        del long
        self.audio = self.pcm.astype(np.float32) / np.float32(32768.0)
        self.batch = ctx.traffic["batch"]
        self.top_k = ctx.traffic["top_k"]
        self.stream_s = n / rate

        program.configure(ctx.config)
        self.key = program.load_key(ctx.tmpdir, self.key_bytes)
        self._detect = detect_batch
        self.rng = rng
        for _ in range(2):                    # the batch's one shape, warm
            self._call(np.arange(self.batch) % N)
        self.sample = pool.Sample(ctx.seed, ctx.traffic["check"]["sample"])

    def _call(self, idx):
        return self._detect(self.key, self.audio[idx], top_k=self.top_k,
                            device=self.dev)

    def request(self, i: int):
        idx = self.rng.permutation(len(self.truth))[:self.batch]
        out = self._call(idx)
        self.sample.offer((idx, out))
        return self.batch * self.stream_s, True

    def spans(self):
        return program_spans(self.ctx.counters)

    def release(self) -> None:
        program.release()

    def _streams(self):
        """(stream, answer row) pairs to judge: per sampled answer,
        `per_card` rows from each card's share of the batch."""
        per_card = self.ctx.traffic["check"]["streams_per_card"]
        cards = len(self.ctx.devices)
        rnd = random.Random(self.ctx.seed)
        for idx, out in self.sample.items():
            share = self.batch // cards
            for c in range(cards):
                for row in rnd.sample(range(c * share, (c + 1) * share),
                                      per_card):
                    yield int(idx[row]), out, row

    def check(self, prec: Prec, detail=None) -> Dict[str, float]:
        rows = []
        for s, out, row in self._streams():
            refs = scan.reference_patterns(self.pcm[s], self.key_bytes,
                                           self.geom, prec, self.dev,
                                           clip=False)
            rows.append(judge.fleet_numbers(out, row, refs, self.truth[s],
                                            self.rate, self.top_k, detail))
        return judge.worst(rows)

    def control(self, prec: Prec) -> Dict[str, float]:
        rows = []
        for s, _, _ in self._streams():
            args = (self.pcm[s], self.key_bytes, self.geom)
            ctl = [r for r in scan.reference_patterns(*args, prec, self.dev,
                                                      extra=0, clip=False)
                   if r.kind == "block" and r.block_type != "ab"]
            ctl = sorted(ctl, key=lambda r: -r.quality)[:self.top_k]
            out = {"positions": np.array([[r.index for r in ctl]]),
                   "qualities": np.array([[r.quality for r in ctl]]),
                   "block_is_a": np.array([[r.block_type == "a"
                                            for r in ctl]]),
                   "errors": np.array([[r.error for r in ctl]]),
                   "bits": np.array([[r.bits for r in ctl]]),
                   "eligible": np.ones((1, len(ctl)), bool)}
            refs = scan.reference_patterns(*args, Prec("f64"), self.dev,
                                           clip=False)
            rows.append(judge.fleet_numbers(out, 0, refs, self.truth[s],
                                            self.rate, len(ctl)))
        return judge.worst(rows)

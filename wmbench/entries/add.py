"""The `add` entry: one client marks WAV files with add_stream_watermark,
which is what `add_watermark` runs.

Set-up writes the traffic's pool of input files under the run's TMPDIR
(fixed lengths cut from the seeded carriers at the configuration's rate).
A request reads the next file of a seeded order with the program's WAV
reader and marks it with a message of its own; the program's own
`io.wavfile.WavFileWriter` encodes the output into memory, so the encode is
timed and nothing of size is written.  After the window a seeded sample of
the outputs, with the longest file's first, is held sample for sample
against the plain reference (wmbench/reference/mark.py).
"""

from __future__ import annotations

import io
import os
from typing import Dict

import numpy as np
import torch

from wmbench.lib import carriers, pool, program
from wmbench.lib.spans import program_spans
from wmbench.reference import judge, mark
from wmbench.reference.keyed import Geom
from wmbench.reference.prec import Prec


def _memory_output(C: int, rate: int):
    from audiowmark_tpu_torch.io import wavfile
    from audiowmark_tpu_torch.io.streams import AudioOutputStream
    from audiowmark_tpu_torch.params import Encoding

    class MemoryWav(AudioOutputStream):
        """A 16-bit WAV output stream into a BytesIO."""

        def __init__(self):
            self.buf = io.BytesIO()
            self.writer = wavfile.WavFileWriter(self.buf, C, rate, 16,
                                                Encoding.SIGNED)

        def sample_rate(self):
            return rate

        def n_channels(self):
            return C

        def bit_depth(self):
            return 16

        def write_frames(self, samples):
            self.writer.write_frames(samples)

        def close(self):
            self.writer.close()

    return MemoryWav()


class Session:
    def __init__(self, ctx):
        from audiowmark_tpu_torch.io.streams import WavInputStream
        from audiowmark_tpu_torch.models import add_stream_watermark

        self.ctx = ctx
        mix = ctx.traffic["pool"]
        audio = ctx.config["audio"]
        self.rate, self.C = audio["sample_rate"], audio["channels"]
        self.geom = Geom.from_config(ctx.config)
        self.dev = ctx.devices[0]
        rng = np.random.default_rng(ctx.seed)
        N = mix["files"]
        secs = pool.lengths(*mix["seconds"], N)
        kinds = pool.by_slot(N, mix["carriers"])
        peaks = pool.by_slot(N, mix["peaks"])
        self.key_bytes = rng.bytes(16)
        cseeds = {c: int(rng.integers(2 ** 31)) for c in mix["carriers"]}
        lead = int(mix["carrier_lead_seconds"] * self.rate)
        starts = [int(rng.integers(lead)) for _ in range(N)]
        n = [int(s * self.rate) for s in secs]
        need = max(a + b for a, b in zip(n, starts))
        long = {c: carriers.GENERATORS[c](need / self.rate + 1, self.rate,
                                          cseeds[c], 1.0, self.dev)
                for c in mix["carriers"]}
        self.samples, self.paths, self.seconds = [], [], []
        for i in range(N):
            seg = long[kinds[i]][starts[i]:starts[i] + n[i], :self.C]
            pcm = carriers.to_int16(seg * (peaks[i]
                                           / torch.max(torch.abs(seg))))
            path = os.path.join(ctx.tmpdir, "mark%02d.wav" % i)
            pool.write_wav(path, pcm, self.rate)
            self.samples.append(pcm)
            self.paths.append(path)
            self.seconds.append(n[i] / self.rate)
        del long

        program.configure(ctx.config)
        self.key = program.load_key(ctx.tmpdir, self.key_bytes)
        self._reader = WavInputStream
        self._add = add_stream_watermark
        order = getattr(pool, ctx.traffic.get("order", "cycle"))
        self.order = order(rng, self.seconds)
        warm = (range(N) if ctx.traffic.get("warmup") == "all" else
                (int(np.argmin(self.seconds)), int(np.argmax(self.seconds))))
        for f in warm:
            self._mark(f, pool.bits(ctx.seed, 1, f, self.geom.payload_size))
        self.sample = pool.Sample(ctx.seed, ctx.traffic["check"]["sample"])
        self.longest = int(np.argmax(self.seconds))

    def _mark(self, f: int, bits: np.ndarray):
        src = self._reader(self.paths[f])
        out = _memory_output(self.C, self.rate)
        try:
            rc = self._add(self.key, src, out, pool.hex_of(bits),
                           device=self.dev)
        finally:
            src.close()
        return rc == 0, out.buf

    def request(self, i: int):
        f = next(self.order)
        bits = pool.bits(self.ctx.seed, 0, i, self.geom.payload_size)
        ok, buf = self._mark(f, bits)
        if ok:
            ans = (f, bits, buf.getvalue())
            if f == self.longest and not self.sample.always:
                self.sample.always.append(ans)
            else:
                self.sample.offer(ans)
        return self.seconds[f], ok

    def spans(self):
        return program_spans(self.ctx.counters)

    def release(self) -> None:
        program.release()

    def check(self, prec: Prec) -> Dict[str, float]:
        rows = []
        for f, bits, data in self.sample.items():
            prog = pool.pcm_of_wav(data, self.C)
            ref = mark.mark(self.samples[f], self.rate, self.key_bytes, bits,
                            self.geom, prec, self.dev)
            rows.append(judge.mark_numbers(prog, ref))
        return judge.worst(rows)

    def control(self, prec: Prec) -> Dict[str, float]:
        """The reference in `prec` put in the program's place, on the
        sampled requests' inputs and messages."""
        rows = []
        for f, bits, _ in self.sample.items():
            args = (self.samples[f], self.rate, self.key_bytes, bits,
                    self.geom)
            rows.append(judge.mark_numbers(
                mark.mark(*args, prec, self.dev),
                mark.mark(*args, Prec("f64"), self.dev)))
        return judge.worst(rows)

"""The streaming add finishes each tile on the device (models/embedder.py:
the mix, ops/limiter.DeviceStreamingLimiter and, for a 16-bit signed PCM
writer, ops/frames.quantize_i16), here on the CPU device.

* DeviceStreamingLimiter equals the numpy StreamingLimiter bit for bit on
  seeded noise whose level changes by the block (peaks 0.6 and 1.2, so
  the ceiling engages at 1.2), in 13 uneven pieces, the first of several
  blocks, after a zero lead-in's skip and through flush, at 44.1 and
  48 kHz, 1 and 2 channels.
* The add's output equals, byte for byte, the host finish it replaced
  (fixtures.host_finish: numpy mix, StreamingLimiter, the writer's encode
  of float32) on the same tiles, for 16-bit, 24-bit, float and raw
  outputs, with and without the limiter, known and unknown length, a
  zero lead-in and --snr (its SNR line equal); the WAV writer gets int16
  for 16-bit output and float32 otherwise, and counter `add.finish_i16`
  counts every tile written where the writer takes int16, and
  `add.finish_f32` every tile otherwise.
"""

import re

import numpy as np
import pytest
import torch

from audiowmark_tpu_torch.fixtures import (MemoryWav, add_and_host_finish,
                                           limiter_signal, limiters_apart,
                                           raw_format)
from audiowmark_tpu_torch.io.streams import RawOutputStream
from audiowmark_tpu_torch.models import embedder
from audiowmark_tpu_torch.params import Encoding, Params
from audiowmark_tpu_torch.utils import prof

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _params():
    Params.reset()
    Params.sync_frames_per_bit = 30
    Params.frames_per_bit = 1
    prof.reset()
    yield
    prof.enabled = False
    prof.reset()
    Params.reset()


@pytest.mark.parametrize("peak", [0.6, 1.2])
@pytest.mark.parametrize("n_channels", [1, 2])
@pytest.mark.parametrize("rate", [44100, 48000])
def test_device_limiter_equals_numpy(rate, n_channels, peak):
    for lead in (0, 2 * rate + 777):
        sizes, apart, skipped = limiters_apart(rate, n_channels, peak, lead,
                                               "cpu")
        assert skipped[0] == skipped[1]
        assert sizes[0] == sizes[1] == int(12.3 * rate) * n_channels \
            + (lead - skipped[0]) * n_channels
        assert apart == 0


def _raw(path, rate):
    fmt = raw_format("signed", 16, rate=rate)
    fmt.set_channels(2)
    return RawOutputStream(path, fmt)


# (rate, known length, output, zero lead-in frames, limiter, --snr)
CASES = {
    "44k-16": (44100, True, "wav16", 0, True, False),
    "44k-24": (44100, True, "wav24", 0, True, False),
    "44k-float": (44100, True, "float", 0, True, False),
    "44k-16-no-limiter": (44100, True, "wav16", 0, False, False),
    "44k-16-lead-in": (44100, True, "wav16", 3 * 44100 + 700, True, False),
    "44k-16-snr": (44100, True, "wav16", 0, True, True),
    "44k-raw16-unknown": (44100, False, "raw16", 0, True, False),
    "48k-16-unknown": (48000, False, "wav16", 0, True, False),
    "48k-float-unknown": (48000, False, "float", 0, True, False),
    "48k-16-unknown-lead-in": (48000, False, "wav16", 2 * 48000 + 300,
                               True, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stream_add_equals_host_finish(tmp_path, monkeypatch, case):
    rate, known, output, lead, limiter, snr = CASES[case]
    Params.test_no_limiter = not limiter
    Params.snr = snr
    monkeypatch.setattr(embedder, "_FAST_PATH_MAX_FRAMES", 0)
    x = limiter_signal(11, 12.5 if known else 9.5, rate, 2, 1.2)

    def output_stream(name):
        if output == "raw16":
            return _raw(str(tmp_path / name), rate)
        bits, enc = {"wav16": (16, Encoding.SIGNED),
                     "wav24": (24, Encoding.SIGNED),
                     "float": (32, Encoding.FLOAT)}[output]
        return MemoryWav(2, rate, bits, enc, x.size // 2 if known else None)

    def data(name):
        return (r[name].buf.getvalue() if output != "raw16"
                else (tmp_path / name).read_bytes())

    r = add_and_host_finish(x, 2, rate, output_stream, known, lead, "cpu")
    assert r["rc"] == 0 and r["tiles"] > 0
    got, want = data("device"), data("host")
    assert len(got) == len(want) > 0
    assert got == want

    i16 = output == "wav16"
    if output != "raw16":
        assert set(r["device"].dtypes) == {np.dtype(np.int16 if i16
                                                    else np.float32)}
    assert r["counters"].get("add.finish_i16", 0) == (r["writes"] if i16
                                                      else 0)
    assert r["counters"].get("add.finish_f32", 0) == (0 if i16
                                                      else r["writes"])
    printed = re.findall(r"^SNR:\s+(.*) dB$", r["info"], re.M)
    assert printed == (["%f" % r["snr"]] if snr else [])

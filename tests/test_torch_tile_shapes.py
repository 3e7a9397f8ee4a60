"""One launch shape for the add's delta FFTs (ops/frames._delta_iffts), on
the CPU.

On the card, cuFFT's rows at a batch of up to 1024 rows differ in the last
bit from the same rows at 2048 rows and more, so an add whose tiles were
small (the unknown-length add's ramp of 16 -> 512 frames) gave other
samples than the whole-file add.  Every add path now runs its delta FFTs
in calls of exactly DELTA_FRAMES frames:

* the shapes that reach torch.fft.rfft and torch.fft.irfft during the
  whole-file add at two lengths, the known-length streaming add (--snr),
  the unknown-length add of raw PCM, a 32 kHz add of raw PCM (through the
  resampler pair) and batch_embed_sharded on a (2, 2) mesh are all
  (DELTA_FRAMES, C, FRAME) and (DELTA_FRAMES, C, N_BINS);
* _delta_iffts in those calls gives the same bits as one call of its three
  stages on all frames, at frame counts below, at and above DELTA_FRAMES,
  mono and stereo.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from audiowmark_tpu_torch import cli
from audiowmark_tpu_torch.fixtures import raw_format
from audiowmark_tpu_torch.io.converters import RawConverter
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.ops import frames
from audiowmark_tpu_torch.params import Params
from audiowmark_tpu_torch.parallel.mesh import batch_embed_sharded, make_mesh

torch.set_num_threads(2)
MSG = "0123456789abcdef0011223344556677"
K = frames.DELTA_FRAMES


@pytest.fixture
def fft_shapes(monkeypatch):
    """The (function, input shape) of every torch.fft.rfft / irfft call."""
    seen = []
    for name in ("rfft", "irfft"):
        fn = getattr(torch.fft, name)

        def recording(x, *args, _fn=fn, _name=name, **kwargs):
            seen.append((_name, tuple(x.shape)))
            return _fn(x, *args, **kwargs)

        monkeypatch.setattr(torch.fft, name, recording)
    monkeypatch.setenv("AUDIOWMARK_TORCH_DEVICE", "cpu")
    yield seen
    Params.reset()


def _noise(tmp_path, seconds, rate, raw=False):
    rng = np.random.RandomState(seconds + rate)
    samples = ((rng.rand(int(seconds * rate) * 2) * 2 - 1) * 0.5) \
        .astype(np.float32)
    wav = str(tmp_path / ("n%d_%d.wav" % (seconds, rate)))
    WavData(samples, 2, rate, 16).save(wav)
    if not raw:
        return wav
    path = wav[:-4] + ".raw"
    with open(path, "wb") as f:
        f.write(RawConverter(raw_format("signed", 16)).to_raw(
            WavData.load(wav).samples))
    return path


def _add(argv):
    Params.reset()
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["--strict", "add"] + argv) == 0
    Params.reset()


def _one_shape(seen, channels):
    assert {s for s in seen} == {
        ("rfft", (K, channels, frames.FRAME)),
        ("irfft", (K, channels, frames.N_BINS))}, sorted(set(seen))


@pytest.mark.parametrize("path", ["whole_4s", "whole_30s", "stream_known",
                                  "stream_unknown", "rate_32k_unknown"])
def test_every_add_path_launches_one_fft_shape(tmp_path, fft_shapes, path):
    out = str(tmp_path / "out.wav")
    if path.startswith("whole"):
        seconds = 4 if path == "whole_4s" else 30
        _add([_noise(tmp_path, seconds, 44100), out, MSG])
    elif path == "stream_known":
        _add(["--snr", _noise(tmp_path, 4, 44100), out, MSG])
    else:
        rate = 32000 if path == "rate_32k_unknown" else 44100
        _add(["--input-format", "raw", "--raw-rate", str(rate),
              _noise(tmp_path, 12, rate, raw=True), out, MSG])
    assert len(fft_shapes) >= 2
    _one_shape(fft_shapes, 2)


def test_sharded_embed_launches_one_fft_shape(fft_shapes):
    rng = np.random.RandomState(4)
    B, T, C = 2, 300, 2
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (B, T, C, frames.FRAME))
                         .astype(np.float32))
    mods = torch.from_numpy(rng.randint(-1, 2, (B, T, frames.N_BINS))
                            .astype(np.int8))
    batch_embed_sharded(make_mesh(4, dp=2, device="cpu"), x, mods, 0.01)
    assert len(fft_shapes) == 8          # 4 shards, rfft and irfft each
    _one_shape(fft_shapes, C)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("n_frames", [16, 700, K, 2 * K + 452])
def test_chunked_delta_equals_one_call(n_frames, channels):
    rng = np.random.RandomState(n_frames + channels)
    x = torch.from_numpy(rng.uniform(-0.9, 0.9, (n_frames, frames.FRAME,
                                                 channels))
                         .astype(np.float32)).transpose(1, 2)
    mods = torch.from_numpy(rng.randint(-1, 2, (n_frames, frames.N_BINS))
                            .astype(np.int8))
    awin = torch.from_numpy(frames.analysis_window())
    got = frames._delta_iffts(x, mods, 0.01, awin)
    want = frames._synthesis(frames._delta_spectrum(
        frames._spectrum(x, awin), mods, 0.01))
    assert got.shape == (n_frames, channels, frames.FRAME)
    assert torch.equal(got, want)

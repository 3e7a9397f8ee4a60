"""Port resampler (audiowmark_tpu_torch ops/resample.py) vs the JAX
package's ops/resample.py, and the resampled chunk loader.

* resample_buffer: coefficients in float32 on the device on both sides
  (sin/cos of other libraries, and another summation order), so outputs
  agree within atol 1e-6 (2.4e-7 seen on stereo noise at 0.9 full scale).
* StreamingResampler: float64 coefficients cast to float32 on both sides
  (numpy in the JAX package, torch on the port's device); outputs agree
  within atol 1e-6 (0.0 seen on the CPU); readable frame counts after
  every write are exact.
* The port's output does not depend on how the input is split into writes
  (bit for bit), which lets the chunk loader write 1<<18 frames at a time
  where the JAX package writes 4096.
* skip(), including the negative-consume case, and the reference-loop
  frame cap of the streaming add: counts exact.
"""

import numpy as np
import pytest
import torch

from audiowmark_tpu.models import chunkloader as jchunk
from audiowmark_tpu.models import embedder as jemb
from audiowmark_tpu.ops import resample as jres
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.models import chunkloader as tchunk
from audiowmark_tpu_torch.models import embedder as temb
from audiowmark_tpu_torch.ops import resample as tres
from audiowmark_tpu_torch.params import Params as TParams

torch.set_num_threads(2)
ATOL = 1e-6
RATES = [(48000, 44100), (44100, 48000), (32000, 44100), (44100, 32000)]


@pytest.fixture(autouse=True)
def _reset_params():
    JParams.reset()
    TParams.reset()
    yield
    JParams.reset()
    TParams.reset()


def _noise(seed, frames):
    rng = np.random.RandomState(seed)
    return ((rng.rand(frames * 2) * 2 - 1) * 0.9).astype(np.float32)


@pytest.mark.parametrize("old,new", RATES)
def test_resample_buffer_matches_jax(old, new):
    x = _noise(old, old // 2)                  # 0.5 s stereo
    want = jres.resample_buffer(x, 2, new / old)
    got = tres.resample_buffer(x, 2, new / old, device="cpu")
    assert got.shape == want.shape == (2 * int(round(old // 2 * new / old)),)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _stream(res, x, bounds, to_numpy):
    """Write x in the pieces bounds gives, read what is readable after each
    write, then the trailing frames; returns (output, counts)."""
    outs, counts = [], []
    for lo, hi in zip(bounds, bounds[1:]):
        res.write_frames(x[2 * lo:2 * hi])
        counts.append(res.can_read_frames())
        outs.append(to_numpy(res.read_frames(res.can_read_frames())))
    res.write_trailing_frames()
    counts.append(res.can_read_frames())
    outs.append(to_numpy(res.read_frames(res.can_read_frames())))
    return np.concatenate(outs), counts


@pytest.mark.parametrize("old,new", RATES)
def test_streaming_resampler_matches_jax(old, new):
    x = _noise(old + 1, old // 2)
    bounds = [0, 1000, 1001, 5000, 17000, old // 2]
    want, want_n = _stream(jres.StreamingResampler(2, old, new), x, bounds,
                           np.asarray)
    got, got_n = _stream(tres.StreamingResampler(2, old, new, "cpu"), x,
                         bounds, lambda t: t.numpy())
    assert got_n == want_n
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("old,new", [(48000, 44100), (32000, 44100)])
def test_streaming_resampler_write_size_independent(old, new):
    """4096-frame writes and one large write give the same output, bit for
    bit."""
    x = _noise(old + 2, old)                   # 1 s stereo
    small = [0] + list(range(4096, old, 4096)) + [old]
    a, _ = _stream(tres.StreamingResampler(2, old, new, "cpu"), x, small,
                   lambda t: t.numpy())
    b, _ = _stream(tres.StreamingResampler(2, old, new, "cpu"), x, [0, old],
                   lambda t: t.numpy())
    assert np.array_equal(a, b)


def test_chunk_loader_write_size_independent(tmp_path, monkeypatch):
    """The port's resampling chunk loader gives the same chunk with the JAX
    package's 4096-frame writes and with its own large ones, and that
    chunk agrees with the JAX loader's."""
    path = str(tmp_path / "n48.wav")
    WavData(_noise(3, 3 * 48000), 2, 48000, 16).save(path)

    def load(module, **kw):
        loader = module.WavChunkLoader(path, **kw)
        loader.load_next_chunk()
        samples = loader.wav_data().samples.copy()
        loader.load_next_chunk()
        assert loader.done()
        return samples, loader.length()

    big, big_len = load(tchunk, device="cpu")
    monkeypatch.setattr(tchunk, "_RESAMPLE_BLOCK", 4096)
    small, small_len = load(tchunk, device="cpu")
    want, want_len = load(jchunk)
    assert np.array_equal(big, small) and big_len == small_len == want_len
    assert big.shape == want.shape == (2 * 3 * 44100,)
    np.testing.assert_allclose(big, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("old,new,zeros", [
    (32000, 44100, 32000 * 3 + 2048),
    (44100, 32000, 44100 * 2 + 5000),
    (48000, 44100, 49024),       # frame rounding dips below the seconds
])
def test_skip_matches_jax(old, new, zeros):
    j = jres.StreamingResampler(2, old, new)
    t = tres.StreamingResampler(2, old, new, "cpu")
    assert t.skip(zeros) == j.skip(zeros)
    assert t.out_buffer.shape[0] == j.out_buffer.size
    assert t.can_read_frames() == j.can_read_frames()
    x = _noise(zeros, old // 4)
    j.write_frames(x)
    t.write_frames(x)
    assert t.can_read_frames() == j.can_read_frames()
    n = j.can_read_frames()
    np.testing.assert_allclose(t.read_frames(n).numpy(), j.read_frames(n),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("rate", [44100, 48000, 32000, 22050, 96000])
@pytest.mark.parametrize("no_limiter", [True, False])
def test_generator_frame_cap_matches_jax(rate, no_limiter):
    block = rate * int(TParams.limiter_block_size_ms) // 1000
    assert TParams.limiter_block_size_ms == JParams.limiter_block_size_ms
    for seconds in (0.0, 0.5, 7.3, 61.0):
        n = int(rate * seconds)
        assert temb._ref_generator_frame_cap(n, rate, no_limiter, block) \
            == jemb._ref_generator_frame_cap(n, rate, no_limiter, block)

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
* The host's bookkeeping of a write (rows, padding) from its first and last
  rows equals the min and max over every row's tap index; output rows
  computed in pieces equal those of one call, across the plain version's
  64 K-row tiles; for a CUDA tensor the resampler launches kernel K2 or
  raises (here: no nvcc), and counts each write by its route.
"""

import numpy as np
import pytest
import torch

from audiowmark_tpu.models import chunkloader as jchunk
from audiowmark_tpu.models import embedder as jemb
from audiowmark_tpu.ops import resample as jres
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch import cuda_build
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.models import chunkloader as tchunk
from audiowmark_tpu_torch.models import embedder as temb
from audiowmark_tpu_torch.ops import resample as tres
from audiowmark_tpu_torch.params import Params as TParams
from audiowmark_tpu_torch.utils import prof

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


class _PlanProbe(tres.StreamingResampler):
    """Checks each write's plan from the row ends against every row's tap
    index as the resampler computed them before K2 (numpy arrays of all
    output rows)."""

    plans = 0

    def _produce(self):
        n_new, pad_lo, pad_hi = self._plan()
        avail = (self.in_total - self.half_taps) * self.new_rate
        max_out = (avail - 1) // self.old_rate + 1 if avail > 0 else 0
        assert n_new == max(0, max_out - self.next_out)
        if n_new > 0:
            j = self.next_out + np.arange(n_new, dtype=np.float64)
            base = np.floor(j / self.ratio).astype(np.int64) \
                - (self.half_taps - 1) - self.hist_start
            assert pad_lo == max(0, -int(base.min()))
            assert pad_hi == max(0, int(base.max()) + self.n_taps
                                 - self.hist.shape[0])
            type(self).plans += 1
        super()._produce()


@pytest.mark.parametrize("skip", [0, 48000 * 2 + 3000])
@pytest.mark.parametrize("old,new", [(48000, 44100), (44100, 48000),
                                     (32000, 44100)])
def test_write_plan_from_row_ends_matches_every_row(old, new, skip):
    """n_new, pad_lo and pad_hi from the first and last row equal those of
    the whole base array, over seeded write sizes from 1 frame to more
    than one 64 K-row tile, from the stream's start and after skip."""
    rng = np.random.RandomState(old + new + skip)
    sizes = [1, 2, 3, 700, tres._TILE + 1234, 1, 5000]
    sizes += list(rng.randint(1, 90000, 6)) + list(rng.randint(1, 40, 6))
    _PlanProbe.plans = 0
    res = _PlanProbe(2, old, new, "cpu")
    if skip:
        res.skip(skip)
    for n in sizes:
        res.write_frames(np.zeros(2 * n, dtype=np.float32))
        res.read_frames(res.can_read_frames())
    res.write_trailing_frames()
    # every write but a few of 1-40 frames produces rows
    assert _PlanProbe.plans > len(sizes) // 2


@pytest.mark.parametrize("old,new", [(48000, 44100), (44100, 48000)])
def test_streaming_write_longer_than_a_tile_is_write_size_independent(
        old, new):
    """One write of 3 s (more than 2 x 64 K output rows) and seeded small
    writes give the same output, bit for bit."""
    n = 3 * old
    x = _noise(old + 7, n)
    cuts = np.sort(np.random.RandomState(5).choice(np.arange(1, n), 40,
                                                   replace=False))
    pieces = [0] + list(cuts) + [n]
    a, _ = _stream(tres.StreamingResampler(2, old, new, "cpu"), x, pieces,
                   lambda t: t.numpy())
    b, _ = _stream(tres.StreamingResampler(2, old, new, "cpu"), x, [0, n],
                   lambda t: t.numpy())
    assert a.shape[0] > 2 * 2 * tres._TILE
    assert np.array_equal(a, b)


@pytest.mark.parametrize("coeff_dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ratio", [44100 / 48000, 48000 / 44100,
                                   0.98 / 2])          # a speed scan's centre
def test_rows_in_pieces_equal_one_call(ratio, coeff_dtype):
    """Row j of _resample_rows depends on j alone: rows computed in pieces
    that cross the plain version's tiles equal one call's rows."""
    rng = np.random.RandomState(11)
    _, _, half_taps, n_taps = tres._filter_params(ratio)
    in_frames = 150000
    xpad = torch.from_numpy(rng.randn(in_frames + n_taps, 2)
                            .astype(np.float32))
    n_rows = int(in_frames * ratio) - 1
    whole = tres._resample_rows(xpad, 0, n_rows, ratio, 0, coeff_dtype)
    cuts = [0, 1, 17, tres._TILE - 3, tres._TILE + 5, n_rows]
    parts = torch.cat([tres._resample_rows(xpad, a, b - a, ratio, 0,
                                           coeff_dtype)
                       for a, b in zip(cuts, cuts[1:])])
    assert whole.shape == (n_rows, 2) and torch.equal(parts, whole)


def test_writes_count_by_route():
    """Each write that produces rows counts once as resample.plain on the
    CPU; the kernel's count stays as it was."""
    prof.reset()
    prof.enabled = True
    launches = tres.LAUNCHES
    try:
        res = tres.StreamingResampler(2, 48000, 44100, "cpu")
        res.write_frames(np.zeros(2 * 10, dtype=np.float32))    # no rows
        for n in (3000, 70000, 5):
            res.write_frames(np.zeros(2 * n, dtype=np.float32))
        x = torch.zeros((1000, 2))
        tres.resample_frames(x, 0.5)
        counters = dict(prof.counters)
    finally:
        prof.enabled = False
        prof.reset()
    assert counters == {"resample.plain": 4}
    assert tres.LAUNCHES == launches


class _CudaTensor:
    """What the resampler reads of a CUDA tensor before it launches, on a
    machine without a card."""

    device = torch.device("cuda", 0)
    dtype = torch.float32
    shape = (4096, 2)

    def dim(self):
        return 2

    def is_contiguous(self):
        return True


def test_cuda_tensor_without_the_library_raises(monkeypatch, tmp_path):
    """With no built library and no nvcc, a CUDA tensor's rows raise and
    nothing falls back to the plain version; the failed build counts as
    build.k2, K1's counter untouched."""
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    prof.reset()
    prof.enabled = True
    launches = tres.LAUNCHES
    try:
        for dtype in (torch.float64, torch.float32):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                tres._resample_rows(_CudaTensor(), 0, 100, 44100 / 48000,
                                    0, dtype)
        counters = dict(prof.counters)
    finally:
        prof.enabled = False
        prof.reset()
    assert counters == {"build.k2": 2}
    assert tres.LAUNCHES == launches
    assert list(tmp_path.iterdir()) == []

"""Port sync search (audiowmark_tpu_torch ops/search_fused.SyncSearcher,
ops/extract.block_raw) vs the JAX package's build_searcher output, in
BLOCK and CLIP mode, on watermarked noise.

Geometry: 30 sync frames per bit and 1 frame per bit give 858 + 180 =
1038 frames per block (~24 s), so 80 s of audio holds blocks A, B, A.
Candidate steps `t`, refined positions and eligibility must be exact;
qualities within rtol 2e-4, atol 2e-5 (as tests/test_search_fused.py:38:
the spectra come from another FFT library, and the port sums per-bit
scores in another order); raw soft bits, sums of ~60 dB differences, within
rtol 1e-4, atol 1e-3.

Each package reads its own Params (the same geometry is set on both) and
gets its own Key."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiowmark_tpu import tables as jtables
from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.models.embedder import add_watermark as j_add
from audiowmark_tpu.ops import search_fused as jsf
from audiowmark_tpu.ops.extract import block_raw_one
from audiowmark_tpu.ops.frames import analysis_window
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch import tables as ttables
from audiowmark_tpu_torch.crypto.keys import Key as TKey
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.params import Params as TParams
from audiowmark_tpu_torch.models import syncfinder as tsf_models
from audiowmark_tpu_torch.models.decoder import ClipDecoder
from audiowmark_tpu_torch.ops import search_fused as tsf
from audiowmark_tpu_torch.ops.extract import block_raw

torch.set_num_threads(2)
FRAME = TParams.frame_size
SECONDS = 80


def _reset():
    JParams.reset()
    TParams.reset()


def _geometry():
    for params in (JParams, TParams):
        params.sync_frames_per_bit = 30
        params.frames_per_bit = 1


@pytest.fixture(autouse=True)
def geometry():
    _reset()
    _geometry()
    yield
    _reset()


@pytest.fixture(scope="module")
def marked(tmp_path_factory):
    """80 s of seeded stereo noise, marked by the JAX package."""
    _geometry()
    d = tmp_path_factory.mktemp("search")
    rng = np.random.RandomState(2024)
    n = SECONDS * 44100 * 2
    WavData(((rng.rand(n) * 2 - 1) * 0.5).astype(np.float32), 2, 44100,
            16).save(str(d / "n.wav"))
    assert j_add(JKey(), str(d / "n.wav"), str(d / "wm.wav"), "f0" * 16) == 0
    _reset()
    return WavData.load(str(d / "wm.wav"))


def _run_both(samples, clip):
    C = 2
    true_frames = samples.size // C
    F = true_frames // FRAME
    jt = jtables.get_key_tables(JKey())
    total = jt.frames_per_block * (2 if clip else 1)
    T = tsf.bucket_frames(F)
    assert T == jsf.bucket_frames(F)
    n_starts = 4 * (F - 1 - total)
    n_starts_s = 4 * (T - 1 - total)
    K, _ = tsf_models._fused_k_for(T, jt.frames_per_block, n_starts_s)
    if clip:
        sil = tsf_models._scan_silence(samples)
    else:
        sil = (0, samples.size)
    x = np.zeros(T * FRAME * C, np.float32)
    x[:samples.size] = samples

    jfn = jsf.build_searcher(jt, clip, T, C, K, dft_bf16=False)
    want = {k: np.asarray(v) for k, v in jfn(
        jnp.asarray(x), np.int32(n_starts), np.int32(true_frames),
        np.int32(sil[0]), np.int32(sil[1]), np.int32(0),
        np.int32(n_starts_s)).items()}
    searcher = tsf.SyncSearcher(ttables.get_key_tables(TKey()), clip, "cpu")
    got = {k: v.numpy() for k, v in searcher(
        torch.from_numpy(x), C, K, n_starts, true_frames, sil[0],
        sil[1], 0, n_starts_s).items()}
    return got, want


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in ("t", "refined_pos", "eligible"):
        assert np.array_equal(got[k], want[k]), k
    assert got["eligible"].any()
    for k in ("q", "mean", "refined_q"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    assert got["raws"].shape == want["raws"].shape
    np.testing.assert_allclose(got["raws"], want["raws"], rtol=1e-4,
                               atol=1e-3)


def test_block_search_matches_jax(marked):
    got, want = _run_both(marked.samples, clip=False)
    _assert_same(got, want)
    # the three marked blocks are among the eligible candidates
    fpb = jtables.get_key_tables(JKey()).frames_per_block
    rpos = got["refined_pos"][got["eligible"]]
    for b in range(3):
        expect = (JParams.frames_pad_start + b * fpb) * FRAME
        assert np.min(np.abs(rpos - expect)) < FRAME // 2, b


def test_clip_search_matches_jax(marked):
    """CLIP mode on the zero-padded start window the clip decoder builds
    (silence bounds mask the padding)."""
    window, _ = ClipDecoder(1)._build_window([TKey()], marked, "start")
    got, want = _run_both(window.samples, clip=True)
    _assert_same(got, want)


@pytest.mark.parametrize("mix", [True, False])
def test_block_raw_matches_block_raw_one(marked, mix):
    """Mix-scatter and linear layouts; the last start reads past the end
    and is clamped like dynamic_slice."""
    tables = jtables.get_key_tables(JKey())
    count = tables.frames_per_block
    x = marked.samples
    n = x.size // 2
    starts = [0, 250 * FRAME + 17, n - count * FRAME, n]
    if mix:
        lay = (tables.mix_frame, tables.mix_up - JParams.min_band,
               tables.mix_dn - JParams.min_band)
        group = JParams.bands_per_frame * JParams.frames_per_bit
    else:
        lay = (tables.data_frame(np.arange(tables.n_data_frames)),
               tables.data_up - JParams.min_band,
               tables.data_dn - JParams.min_band)
        group = 0
    want = np.stack([np.asarray(block_raw_one(
        jnp.asarray(x), jnp.int32(s), jnp.asarray(analysis_window()),
        jnp.zeros(1), *(jnp.asarray(a.astype(np.int32)) for a in lay),
        count, 0, mix, group, JParams.frames_per_bit, 2))
        for s in starts])
    got = block_raw(
        torch.from_numpy(x).reshape(-1, 2), torch.tensor(starts),
        torch.from_numpy(analysis_window()),
        *(torch.from_numpy(a.astype(np.int64)) for a in lay), count, mix,
        group, TParams.frames_per_bit).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_candidate_eligibility_matches_jax():
    """Plateaus (ties) and opposite-sign neighbours, exact."""
    rng = np.random.RandomState(5)
    n = 600
    q = (rng.randint(-8, 9, n) / 4.0).astype(np.float32)
    q[100:106] = 1.5                        # a plateau
    mean = (rng.rand(n).astype(np.float32) - 0.5) * 0.1
    validb = np.arange(n) < 550
    je, jaq, _ = jsf.candidate_eligibility(jnp.asarray(q), jnp.asarray(mean),
                                           jnp.asarray(validb))
    te, taq = tsf.candidate_eligibility(torch.from_numpy(q),
                                        torch.from_numpy(mean),
                                        torch.from_numpy(validb))
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert np.array_equal(taq.numpy(), np.asarray(jaq))

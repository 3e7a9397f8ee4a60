"""The port's staged sync search (audiowmark_tpu_torch ops/sync.py stages
and models/syncfinder.search_staged) vs the JAX package's, and where the
search takes it.

Geometry: 30 sync frames per bit and 1 frame per bit give 858 + 180 =
1038 frames per block (~24 s), so 80 s of seeded noise marked by the JAX
package holds blocks A, B, A.

* stages: spectrogram dB values within atol 2e-3 (rfft of other
  libraries, log2 of powers up to ~1e9); `have` masks, positions and local
  means exact (the local mean sums float64 in the same order); sweep and
  refinement qualities within rtol 2e-4, atol 2e-5 (as
  tests/test_search_fused.py:38), on the same spectrogram.
* searches: positions, indices and block types exact; qualities within
  rtol 2e-4, atol 2e-5.
* the fused search's slot loop at its four callers (the whole-stream and
  tiled search, the chunk group, the clip pair), forced to saturate (8
  slots, a low threshold): escalated, each gives what the staged,
  per-chunk or per-window search gives; saturated at _K_CAP, each takes
  its fallback.

Each package reads its own Params (the same geometry is set on both) and
gets its own Key and WavData of the same samples.
"""

import numpy as np
import pytest
import torch

from audiowmark_tpu import tables as jtables
from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.io.wavdata import WavData as JWavData
from audiowmark_tpu.models import syncfinder as jsf
from audiowmark_tpu.models.decoder import ClipDecoder
from audiowmark_tpu.models.embedder import add_watermark as j_add
from audiowmark_tpu.ops import sync as jsync
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch import tables as ttables
from audiowmark_tpu_torch.crypto.keys import Key as TKey
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.params import Params as TParams
from audiowmark_tpu_torch.models import syncfinder as tsf
from audiowmark_tpu_torch.ops import sync as tsync

torch.set_num_threads(2)
SECONDS = 80
Q_TOL = dict(rtol=2e-4, atol=2e-5)


def _reset():
    JParams.reset()
    TParams.reset()


def _geometry():
    for params in (JParams, TParams):
        params.sync_frames_per_bit = 30
        params.frames_per_bit = 1


def _jwav(wav):
    """The JAX package's WavData of the same samples."""
    return JWavData(wav.samples, wav.n_channels, wav.sample_rate,
                    wav.bit_depth)


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
    d = tmp_path_factory.mktemp("staged")
    rng = np.random.RandomState(99)
    n = SECONDS * 44100 * 2
    WavData(((rng.rand(n) * 2 - 1) * 0.5).astype(np.float32), 2, 44100,
            16).save(str(d / "n.wav"))
    assert j_add(JKey(), str(d / "n.wav"), str(d / "wm.wav"), "f0" * 16) == 0
    _reset()
    return WavData.load(str(d / "wm.wav"))


@pytest.fixture(scope="module")
def clip_window(marked):
    """The zero-padded start window the clip decoder searches."""
    _geometry()
    window = ClipDecoder(1)._build_window([JKey()], _jwav(marked), "start")[0]
    return WavData(window.samples, window.n_channels, window.sample_rate,
                   window.bit_depth)


def _x(wav):
    return torch.from_numpy(wav.samples)


def _sync_bits(clip):
    return (jsync.build_sync_bits(jtables.get_key_tables(JKey()), clip),
            tsync.device_sync_bits(ttables.get_key_tables(TKey()), clip,
                                   "cpu"))


def _assert_same(got, want):
    assert len(got) == len(want)
    for kg, kw in zip(got, want):
        assert [(s.index, s.block_type.name) for s in kg.sync_scores] \
            == [(s.index, s.block_type.name) for s in kw.sync_scores]
        np.testing.assert_allclose([s.quality for s in kg.sync_scores],
                                   [s.quality for s in kw.sync_scores],
                                   **Q_TOL)


@pytest.mark.parametrize("clip", [False, True])
def test_hop_spectrogram_matches_jax(marked, clip_window, clip):
    wav = clip_window if clip else marked
    bounds = tsf._scan_silence(wav.samples) if clip else None
    S_j, have_j = jsync.hop_spectrogram(wav.samples, 2, bounds)
    S_t, have_t = tsync.hop_spectrogram(_x(wav), 2, bounds)
    have_t = have_t.numpy()
    assert have_t.dtype == np.float32 and np.isin(have_t, (0, 1)).all()
    assert np.array_equal(have_t > 0, have_j)
    assert (have_t > 0).all() != clip
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j), rtol=0,
                               atol=2e-3)


@pytest.mark.parametrize("clip", [False, True])
def test_sync_score_sweep_matches_jax(marked, clip_window, clip):
    """Both packages sweep the JAX spectrogram: the plain-mean form (no
    silence) and the count-weighted form (silence bounds)."""
    wav = clip_window if clip else marked
    bounds = tsf._scan_silence(wav.samples) if clip else None
    S, have = jsync.hop_spectrogram(wav.samples, 2, bounds)
    jb, tb = _sync_bits(clip)
    want = np.asarray(jsync.sync_score_sweep(S, have, jb))
    got = tsync.sync_score_sweep(torch.from_numpy(np.array(S)),
                                 torch.from_numpy(have.astype(np.float32)),
                                 tb).numpy()
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, **Q_TOL)

    means = tsync.local_mean(torch.from_numpy(want.astype(np.float64)))
    assert np.array_equal(means.numpy(),
                          jsync.local_mean(want.astype(np.float64)))


@pytest.mark.parametrize("clip", [False, True])
def test_refine_grid_matches_jax(marked, clip_window, clip):
    """Bases at the marked blocks, off them, at 0 (the grid starts at 0)
    and near the end (slots that read past the end are NaN)."""
    wav = clip_window if clip else marked
    bounds = tsf._scan_silence(wav.samples) if clip else None
    jb, tb = _sync_bits(clip)
    n = wav.samples.size // 2
    span = jb.total_frames * TParams.frame_size
    bases = np.array([250 * 1024, 250 * 1024 + 777, 0, 100,
                      n - span - 100, n - span + 256], np.int64)
    pos_j, q_j = jsync.refine_grid(wav.samples, 2, bases, jb, bounds)
    pos_t, q_t = tsync.refine_grid(_x(wav), 2, bases, tb, bounds)
    assert np.array_equal(pos_t, pos_j)
    assert np.array_equal(np.isnan(q_t), np.isnan(q_j))
    assert np.isnan(q_j).any() and not np.isnan(q_j).all()
    ok = ~np.isnan(q_j)
    np.testing.assert_allclose(q_t[ok], q_j[ok], **Q_TOL)


@pytest.mark.parametrize("clip", [False, True])
def test_search_staged_matches_jax(marked, clip_window, clip):
    wav = clip_window if clip else marked
    mode_j = jsf.SyncMode.CLIP if clip else jsf.SyncMode.BLOCK
    mode_t = tsf.SyncMode.CLIP if clip else tsf.SyncMode.BLOCK
    want = jsf.search_staged([JKey()], _jwav(wav), mode_j)
    got = tsf.search_staged([TKey()], wav, mode_t, "cpu")
    _assert_same(got, want)
    assert got[0].sync_scores
    assert all(s.raw is None for s in got[0].sync_scores)


def test_no_sync_matches_jax(marked):
    JParams.test_no_sync = TParams.test_no_sync = True
    want = jsf.search([JKey()], _jwav(marked), jsf.SyncMode.BLOCK)
    got = tsf.search([TKey()], marked, tsf.SyncMode.BLOCK, "cpu")
    assert [(s.index, s.quality, s.block_type.name, s.raw)
            for s in got[0].sync_scores] \
        == [(s.index, s.quality, s.block_type.name, None)
            for s in want[0].sync_scores]
    assert len(got[0].sync_scores) == 3
    assert tsf.search([TKey()], marked, tsf.SyncMode.CLIP,
                      "cpu")[0].sync_scores == []


@pytest.mark.parametrize("clip", [False, True])
def test_fused_none_falls_back_to_staged(marked, clip_window, clip,
                                         monkeypatch):
    """Where the fused search gives up (None), both packages' search
    returns the staged result."""
    wav = clip_window if clip else marked
    monkeypatch.setattr(jsf, "_search_fused_one", lambda *a: None)
    monkeypatch.setattr(tsf, "_search_fused_one", lambda *a: None)
    want = jsf.search([JKey()], _jwav(wav),
                      jsf.SyncMode.CLIP if clip else jsf.SyncMode.BLOCK)
    got = tsf.search([TKey()], wav,
                     tsf.SyncMode.CLIP if clip else tsf.SyncMode.BLOCK,
                     "cpu")
    _assert_same(got, want)


@pytest.mark.parametrize("clip", [False, True])
def test_port_fused_matches_port_staged(marked, clip_window, clip):
    wav = clip_window if clip else marked
    mode = tsf.SyncMode.CLIP if clip else tsf.SyncMode.BLOCK
    fused = tsf.search([TKey()], wav, mode, "cpu")
    assert all(s.raw is not None for s in fused[0].sync_scores)
    _assert_same(fused, tsf.search_staged([TKey()], wav, mode, "cpu"))


def test_fused_search_takes_a_partial_frame_after_a_bucket():
    """A stream of 1280 whole frames (a multiple of the 256-frame bucket)
    and a partial one: the fused search pads to the next bucket and agrees
    with the staged search."""
    rng = np.random.RandomState(1280)
    n = 1280 * TParams.frame_size + 100
    wav = WavData(((rng.rand(n * 2) * 2 - 1) * 0.5).astype(np.float32), 2,
                  44100, 16)
    fused = tsf.search([TKey()], wav, tsf.SyncMode.BLOCK, "cpu")
    assert fused[0].sync_scores
    _assert_same(fused, tsf.search_staged([TKey()], wav, tsf.SyncMode.BLOCK,
                                          "cpu"))


# a slot policy that saturates: 8 slots at first, and a threshold that
# 16 of the marked file's candidates pass (|q - mean| > 0.75 * 0.32; the
# next are ~0.24 and below), so 8 slots are saturated and 32 are not
SATURATING_THRESHOLD2 = 0.32


def _chunks(marked):
    """Two chunks of unequal length, as a long file's are."""
    return [marked, marked.with_samples(marked.samples[2 * 7001:
                                                       60 * 44100 * 2])]


def _windows(marked):
    """The clip decoder's padded start and end windows."""
    dec = ClipDecoder(1)
    return [WavData(w.samples, w.n_channels, w.sample_rate, w.bit_depth)
            for w in (dec._build_window([JKey()], _jwav(marked), pos)[0]
                      for pos in ("start", "end"))]


def _site(site, marked):
    """(the site's search, what it must equal) on the marked file: the
    whole-stream and the tiled search against the staged one, the chunk
    group against the per-chunk search, the clip pair against the
    per-window search."""
    block, clip = tsf.SyncMode.BLOCK, tsf.SyncMode.CLIP
    if site in ("one", "tiled"):
        return (lambda: tsf.search([TKey()], marked, block, "cpu"),
                lambda: tsf.search_staged([TKey()], marked, block, "cpu"))
    if site == "group":
        wavs = _chunks(marked)
        return (lambda: tsf.search_block_group([TKey()], wavs, "cpu"),
                lambda: [tsf.search([TKey()], w, block, "cpu")
                         for w in wavs])
    wavs = _windows(marked)
    return (lambda: tsf.search_clip_pair([TKey()], wavs, "cpu"),
            lambda: [tsf.search([TKey()], w, clip, "cpu") for w in wavs])


@pytest.mark.parametrize("site", ["one", "tiled", "group", "pair"])
def test_saturated_slots_escalate_and_fall_back(marked, site, monkeypatch):
    """Each of the fused search's four callers through its slot loop:
    saturated slots searched again at 4x K give what the reference gives;
    saturated at _K_CAP, the caller's fallback runs (the staged search;
    None, which sends the caller to the per-chunk or per-window search)."""
    monkeypatch.setattr(tsf.search_fused, "top_k_for", lambda T, fpb: 8)
    TParams.sync_threshold2 = SATURATING_THRESHOLD2
    if site == "tiled":
        monkeypatch.setattr(tsf.search_fused, "MAX_FUSED_FRAMES", 2560)
        launches = []
        real_launch = tsf._launch
        monkeypatch.setattr(tsf, "_launch", lambda *a: launches.append(a[2])
                            or real_launch(*a))
    ks = []
    real_k_for = tsf._fused_k_for
    monkeypatch.setattr(tsf, "_fused_k_for",
                        lambda *a: ks.append(real_k_for(*a)[0])
                        or real_k_for(*a))
    run, reference = _site(site, marked)
    got = run()
    assert ks[0] == 8 and 32 in ks, ks           # escalated from 8 slots
    if site == "tiled":
        assert launches.count(8) == 2 and 32 in launches   # 2 tiles
    want = reference()
    if site in ("one", "tiled"):
        _assert_same(got, want)
        assert len(got[0].sync_scores) > 3
    else:
        assert len(got) == len(want) == 2
        assert all(g[0].sync_scores for g in got)
        for g, w in zip(got, want):
            assert [[(s.index, s.block_type.name, s.quality)
                     for s in kr.sync_scores] for kr in g] \
                == [[(s.index, s.block_type.name, s.quality)
                     for s in kr.sync_scores] for kr in w]

    monkeypatch.setattr(tsf, "_K_CAP", 8)
    staged = []
    real_staged = tsf.search_staged
    monkeypatch.setattr(tsf, "search_staged",
                        lambda *a: staged.append(a) or real_staged(*a))
    got = run()
    if site in ("one", "tiled"):
        assert len(staged) == 1
        _assert_same(got, want)
    else:
        assert got is None and not staged

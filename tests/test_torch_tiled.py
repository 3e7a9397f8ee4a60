"""The port's tiled sync search (models/syncfinder._search_fused_tiled, for
BLOCK streams beyond MAX_FUSED_FRAMES) vs the JAX package's tiled search
and the port's staged search, and the decoder's batched extraction.

Production geometry (2226 frames per block).  A cap of 2560 frames, set in
both packages, makes 60 s of seeded noise take 2 tiles
(tests/test_search_tiled.py:56-66); 70 s cut to an odd length takes 3,
the last one ragged (tests/test_search_tiled.py:89-99).  The tiled search
equals the whole-stream one except on exact-score ties across a tile
boundary, so it is held to the JAX tiled search and to the staged search.

Positions and block types exact; qualities within rtol 2e-4, atol 2e-5
(as tests/test_search_fused.py:38); raw soft bits within rtol 1e-4, atol
1e-3 (sums of ~60 dB differences from another FFT library).  Each package
gets its own Key and WavData of the same samples.
"""

import numpy as np
import pytest
import torch

from audiowmark_tpu import tables as jtables
from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.io.wavdata import WavData as JWavData
from audiowmark_tpu.models import decoder as jdec
from audiowmark_tpu.models import syncfinder as jsf
from audiowmark_tpu.ops import search_fused as jsearch
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch import tables as ttables
from audiowmark_tpu_torch.crypto.keys import Key as TKey
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.params import Params as TParams
from audiowmark_tpu_torch.models import decoder as tdec
from audiowmark_tpu_torch.models import syncfinder as tsf
from audiowmark_tpu_torch.ops import search_fused as tsearch

torch.set_num_threads(2)
Q_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _reset_params():
    JParams.reset()
    TParams.reset()
    yield
    JParams.reset()
    TParams.reset()


def _noise(seconds, seed, cut=0):
    rng = np.random.RandomState(seed)
    x = ((rng.rand(int(seconds * 44100) * 2) * 2 - 1) * 0.9) \
        .astype(np.float32)
    return WavData(x[:x.size - 2 * cut], 2, 44100, 16)


def _scores(result):
    return [(s.index, s.block_type.name) for s in result[0].sync_scores], \
        [s.quality for s in result[0].sync_scores]


def _assert_same(got, want):
    (gi, gq), (wi, wq) = _scores(got), _scores(want)
    assert gi == wi
    np.testing.assert_allclose(gq, wq, **Q_TOL)


def _tiled(monkeypatch, wav, cap):
    """Both packages' BLOCK search with the whole-stream cap at `cap`;
    the port's tiled search must be the one that ran."""
    monkeypatch.setattr(jsearch, "MAX_FUSED_FRAMES", cap)
    monkeypatch.setattr(tsearch, "MAX_FUSED_FRAMES", cap)
    tiles = []
    real = tsf._launch
    monkeypatch.setattr(tsf, "_launch",
                        lambda *a: tiles.append(a[1][5]) or real(*a))
    want = jsf.search([JKey()], JWavData(wav.samples, 2, 44100, 16),
                      jsf.SyncMode.BLOCK)
    got = tsf.search([TKey()], wav, tsf.SyncMode.BLOCK, "cpu")
    monkeypatch.undo()
    return got, want, tiles


@pytest.mark.parametrize("seconds,cut,n_tiles", [(60, 0, 2), (70, 1337, 3)])
def test_tiled_matches_jax_and_staged(monkeypatch, seconds, cut, n_tiles):
    wav = _noise(seconds, seconds, cut)
    got, want, tiles = _tiled(monkeypatch, wav, 2560)
    assert len(tiles) == n_tiles
    tile_vals = 2560 * TParams.frame_size * 2
    assert tiles[:-1] == [tile_vals] * (n_tiles - 1)
    assert tiles[-1] < tile_vals                     # a ragged last tile
    _assert_same(got, want)
    assert len(got[0].sync_scores) == TParams.get_n_best
    assert all(s.raw is None for s in got[0].sync_scores)
    _assert_same(got, tsf.search_staged([TKey()], wav, tsf.SyncMode.BLOCK,
                                        "cpu"))


def test_block_raw_batch_matches_jax():
    """Repeated indices extract once; blocks reading past the end drop."""
    wav = _noise(60, 5)
    count = jtables.get_key_tables(JKey()).frames_per_block
    n = wav.samples.size // 2
    last = n - count * JParams.frame_size
    indices = [0, 250 * 1024 + 3, 0, last, last + 1, 377]
    want = jdec._block_raw_batch(wav.samples, 2, indices,
                                 jtables.get_key_tables(JKey()))
    got = tdec._block_raw_batch(torch.from_numpy(wav.samples), 2, indices,
                                ttables.get_key_tables(TKey()))
    assert list(got) == list(want) == [0, 250 * 1024 + 3, last, 377]
    for i in want:
        np.testing.assert_allclose(got[i], want[i], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("clip", [False, True])
def test_raw_map_needs_raws_on_every_score(clip):
    """Scores without raws (staged or tiled search, --test-no-sync) give
    no raw map, so the decoders extract in one batch."""
    tables = ttables.get_key_tables(TKey())
    samples = np.zeros(2 * 3 * tables.frames_per_block * 1024, np.float32)
    raw = np.ones(8, np.float32)
    with_raws = tsf.Score(0, 1.0, tsf.ConvBlockType.a, raw, raw)
    without = tsf.Score(4096, 1.0, tsf.ConvBlockType.b)
    assert tdec._raw_map_from_scores(samples, 2, [with_raws, without],
                                     tables, clip) is None
    assert tdec._raw_map_from_scores(samples, 2, [], tables, clip) is None
    got = tdec._raw_map_from_scores(samples, 2, [with_raws], tables, clip)
    assert sorted(got) == ([0, tables.frames_per_block * 1024] if clip
                           else [0])

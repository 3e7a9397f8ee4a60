"""The port's batched searches and the get path built on them: the chunk
group search, the clip pair search, the prefetch thread.

Geometry: 30 sync frames per bit and 1 frame per bit (1038 frames per
block, ~24 s), so 80 s of seeded stereo noise holds blocks A, B, A, a 40 s
cut holds one (and is short enough for clip decoding), and
Params.get_chunk_size = 1.25 min gives two chunks on the 80 s file.  The
group search runs on two logical devices (both the CPU), by patching
`group_device_count` as tests/test_cli_multichip.py does.

* group search and clip pair = the port's per-chunk and per-window searches
  exactly (index, block type, quality and raws bit-equal: the same stages
  run on the same rows);
* group search vs the JAX package's `search_block_group` on two devices:
  indices and block types exact, qualities rtol 2e-4 atol 2e-5;
* `get` prints the same bytes with the prefetch thread on and off and with
  a patched group count, and the same report as the JAX package's;
* an exception in the prefetch thread comes out of the main thread as exit
  code 1 with the loader's message.
"""

import numpy as np
import pytest
import torch

from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.io.wavdata import WavData as JWavData
from audiowmark_tpu.models import syncfinder as j_syncfinder
from audiowmark_tpu.models.embedder import add_watermark as j_add
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch import get_watermark as t_get
from audiowmark_tpu_torch.crypto.keys import Key as TKey
from audiowmark_tpu_torch.io.streams import StreamError
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.models import chunkloader, decoder, syncfinder
from audiowmark_tpu_torch.models.resultset import ResultSet
from audiowmark_tpu_torch.models.syncfinder import SyncMode
from audiowmark_tpu_torch.params import Params as TParams

torch.set_num_threads(2)
MSG = "f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0"
SECONDS = 80


def _geometry():
    for params in (JParams, TParams):
        params.sync_frames_per_bit = 30
        params.frames_per_bit = 1


def _reset():
    JParams.reset()
    TParams.reset()


@pytest.fixture(autouse=True)
def geometry():
    _reset()
    _geometry()
    yield
    _reset()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    _geometry()
    d = tmp_path_factory.mktemp("group")
    rng = np.random.RandomState(11)
    paths = {k: str(d / (k + ".wav")) for k in ("noise", "marked", "short")}
    WavData(((rng.rand(SECONDS * 44100 * 2) * 2 - 1) * 0.5)
            .astype(np.float32), 2, 44100, 16).save(paths["noise"])
    assert j_add(JKey(), paths["noise"], paths["marked"], MSG) == 0
    wav = WavData.load(paths["marked"])
    wav.with_samples(wav.samples[: 40 * 44100 * 2]).save(paths["short"])
    _reset()
    return paths


def _two_chunks(path, cls=WavData):
    """Two streams of unequal length, as the chunks of one file are: the
    whole marked file and a cut of it."""
    a = cls.load(path)
    b = cls.load(path)
    b.set_samples(b.samples[2 * 7001: 60 * 44100 * 2])
    return a, b


def _scores(key_results):
    return [[(s.index, s.block_type.name, s.quality) for s in kr.sync_scores]
            for kr in key_results]


def _raws(key_results):
    return [r for kr in key_results for s in kr.sync_scores
            for r in (s.raw, s.raw2) if r is not None]


@pytest.mark.parametrize("n_dev", [1, 2, 3])
def test_group_search_equals_per_chunk_search(files, monkeypatch, n_dev):
    """Rows over 1, 2 and 3 logical devices (3: one zero row pads the
    batch)."""
    monkeypatch.setattr(syncfinder, "group_device_count",
                        lambda device=None: n_dev)
    chunks = _two_chunks(files["marked"])
    group = syncfinder.search_block_group([TKey()], list(chunks), "cpu")
    assert group is not None and len(group) == 2
    for wav, got in zip(chunks, group):
        want = syncfinder.search([TKey()], wav, SyncMode.BLOCK, "cpu")
        assert _scores(got) == _scores(want) and _scores(got)[0]
        for g, w in zip(_raws(got), _raws(want)):
            assert np.array_equal(g, w)
        assert len(_raws(got)) == len(_raws(want)) > 0


def test_group_search_matches_jax(files, monkeypatch):
    monkeypatch.setattr(syncfinder, "group_device_count",
                        lambda device=None: 2)
    monkeypatch.setattr(j_syncfinder, "group_device_count", lambda: 2)
    got = syncfinder.search_block_group(
        [TKey()], list(_two_chunks(files["marked"])), "cpu")
    want = j_syncfinder.search_block_group(
        [JKey()], list(_two_chunks(files["marked"], JWavData)))
    assert got is not None and want is not None
    for g, w in zip(got, want):
        gs, ws = g[0].sync_scores, w[0].sync_scores
        assert [(s.index, s.block_type.name) for s in gs] == \
            [(s.index, s.block_type.name) for s in ws]
        assert len(gs) >= 2
        np.testing.assert_allclose([s.quality for s in gs],
                                   [s.quality for s in ws],
                                   rtol=2e-4, atol=2e-5)


def test_group_search_declines(files, monkeypatch):
    """None sends the caller to the per-chunk search: one chunk only,
    --test-no-sync, a chunk past the whole-stream search's length."""
    a, b = _two_chunks(files["marked"])
    assert syncfinder.search_block_group([TKey()], [a], "cpu") is None
    TParams.test_no_sync = True
    assert syncfinder.search_block_group([TKey()], [a, b], "cpu") is None
    TParams.test_no_sync = False
    monkeypatch.setattr(syncfinder.search_fused, "MAX_FUSED_FRAMES", 1024)
    assert syncfinder.search_block_group([TKey()], [a, b], "cpu") is None


def _clip_windows(path):
    wav = WavData.load(path)
    dec = decoder.ClipDecoder(1, "cpu")
    return [dec._build_window([TKey()], wav, pos)[0]
            for pos in ("start", "end")]


def test_clip_pair_equals_per_window_search(files):
    windows = _clip_windows(files["short"])
    pair = syncfinder.search_clip_pair([TKey()], windows, "cpu")
    assert pair is not None and len(pair) == 2
    n = 0
    for wav, got in zip(windows, pair):
        want = syncfinder.search([TKey()], wav, SyncMode.CLIP, "cpu")
        assert _scores(got) == _scores(want)
        for g, w in zip(_raws(got), _raws(want)):
            assert np.array_equal(g, w)
        n += len(_raws(got))
    assert n > 0


def test_clip_pair_launch_reads_nothing_until_finish(files, monkeypatch):
    """launch() only enqueues: the read-back (SearcherGroup.fetch) happens
    in finish()."""
    fetched = []
    real = syncfinder.search_fused.SearcherGroup.fetch
    monkeypatch.setattr(syncfinder.search_fused.SearcherGroup, "fetch",
                        staticmethod(lambda s: fetched.append(1) or real(s)))
    fin = syncfinder.search_clip_pair_launch(
        [TKey()], _clip_windows(files["short"]), "cpu")
    assert fin is not None and not fetched
    assert fin() is not None and fetched


def test_clip_decoder_pair_equals_window_by_window(files, monkeypatch):
    """ClipDecoder.run through the pair search queues the decodes that the
    window-by-window search queues."""
    wav = WavData.load(files["short"])

    def patterns():
        rs = ResultSet()
        jobs = decoder._DecodeJobs("cpu")
        decoder.ClipDecoder(1, "cpu").run([TKey()], wav, rs, jobs)
        jobs.flush()
        return [(p.time, p.sync_quality, p.decode_error, p.type,
                 tuple(p.bit_vec)) for p in rs.patterns]

    paired = patterns()
    monkeypatch.setattr(syncfinder, "search_clip_pair_launch",
                        lambda *a, **k: None)
    assert paired == patterns() and paired


def _get(path, capsys):
    capsys.readouterr()
    rc = t_get([TKey()], path, MSG, device="cpu")
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("prefetch,n_dev", [("1", 1), ("0", 2), ("1", 2)])
def test_get_prints_the_same_with_prefetch_and_groups(
        files, capsys, monkeypatch, prefetch, n_dev):
    """Two chunks: serial (no thread, one chunk at a time) against the
    prefetch thread and/or the group search on two logical devices."""
    TParams.get_chunk_size = 1.25
    monkeypatch.setenv("AUDIOWMARK_PREFETCH", "0")
    want = _get(files["marked"], capsys)
    assert want[0] == 0 and "match_count 5 " in want[1]

    monkeypatch.setenv("AUDIOWMARK_PREFETCH", prefetch)
    monkeypatch.setattr(syncfinder, "group_device_count",
                        lambda device=None: n_dev)
    calls = []
    real = syncfinder.search_block_group
    monkeypatch.setattr(
        syncfinder, "search_block_group",
        lambda *a, **k: calls.append(real(*a, **k)) or calls[-1])
    assert _get(files["marked"], capsys) == want
    assert len(calls) == (n_dev > 1) and all(c is not None for c in calls)


def test_get_short_file_prints_the_same_as_jax(files, capsys):
    """A 40 s file: block and clip decodes (the pair search) in one get."""
    from audiowmark_tpu.models.getter import get_watermark as j_get
    rc, out = _get(files["short"], capsys)
    j_rc = j_get([JKey()], files["short"], MSG)
    j_out = capsys.readouterr().out

    def exact(text):
        return [tuple(f[:3] + f[5:]) for f in
                (line.split() for line in text.splitlines())
                if f and f[0] == "pattern"]

    assert rc == j_rc == 0
    assert exact(out) == exact(j_out) and any(
        "CLIP" in line for line in out.splitlines())


def test_multichip_env_turns_groups_off(monkeypatch):
    monkeypatch.setenv("AUDIOWMARK_MULTICHIP", "0")
    assert syncfinder.group_device_count("cpu") == 1
    monkeypatch.delenv("AUDIOWMARK_MULTICHIP")
    assert syncfinder.group_device_count("cpu") == 1


def test_prefetch_thread_error_is_the_loaders_error(files, capsys,
                                                    monkeypatch):
    """The second chunk's load fails inside the prefetch thread: exit code
    1 and the loader's message on stderr, from the main thread."""
    TParams.get_chunk_size = 1.25
    monkeypatch.setenv("AUDIOWMARK_PREFETCH", "1")
    real = chunkloader.WavChunkLoader.load_next_chunk
    seen = []

    def failing(self):
        import threading
        seen.append(threading.current_thread() is threading.main_thread())
        if len(seen) == 2:
            raise StreamError("the second chunk is broken")
        return real(self)

    monkeypatch.setattr(chunkloader.WavChunkLoader, "load_next_chunk",
                        failing)
    capsys.readouterr()
    assert t_get([TKey()], files["marked"], MSG, device="cpu") == 1
    err = capsys.readouterr().err
    assert "error loading %s: the second chunk is broken" % files["marked"] \
        in err
    assert seen == [True, False]


def test_prefetch_loader_replaces_its_array(files):
    """A snapshot of chunk 1 stays what it was after chunk 2 loads."""
    from audiowmark_tpu_torch.models.getter import _load_one
    TParams.get_chunk_size = 1.25
    loader = chunkloader.WavChunkLoader(files["marked"], "cpu")
    first, off0 = _load_one(loader)
    kept = first.samples.copy()
    second, off1 = _load_one(loader)
    assert np.array_equal(first.samples, kept)
    assert off0 == 0.0 and off1 > 0 and second.samples is not first.samples
    assert _load_one(loader) is None
    loader.close()

"""The port's paths that split work over several CUDA cards, held to the
same call on one card, exactly.

On the CPU (tier 1), with a count of four cards faked
(`torch.cuda.is_available`, `device_count`, `current_device` patched):

* `device.card_count`, `spread` and `resolve` name cuda:0 .. cuda:3, a card
  always with its index, and AUDIOWMARK_MULTICHIP=0 gives one card;
* `make_mesh` follows `card_count`, so AUDIOWMARK_MULTICHIP=0 gives the
  (1, 1) mesh (tests/test_torch_mesh.py holds the four cards' mesh to the
  JAX package's order);
* a device cache (`tables_to_device`) makes one copy for the default card
  and for the same card named by its index.

On two or more cards (`-m cuda`; the card count is decided in a fixture,
and the tests skip with the reason where fewer are present):

* K1 on every card against its plain version on that card, bit for bit, at
  143 steps and B = 1, 8, 24 and 256, each launch counted on its card;
* K2 (the resampler's kernel) on every card against its plain rows on that
  card, at both coefficient precisions, each launch counted on its card;
* the chunk-group search of `get` (four chunks of a 110 s file at the
  reduced geometry, one row per card on four cards): stdout equal to the
  one-card get, and the group search equal to the per-chunk search;
* `get` under `torch.cuda.device(1)` of a 32 kHz file in two chunks with
  the prefetch thread (the loader's resampler on the caller's card): the
  same report as on card 0, K1 and K2 launched on card 1 only;
* the speed scan's centres split over the cards (uneven shares): the grid
  equal to the one-card scan, K2 launched on the cards that hold centres;
* `watermark_batch` on the (n, 1) and (2, n/2) meshes: 0 samples apart
  from the one-card call; `detect_batch` over the cards: every array equal
  to the one-card call, K1 launched once on each card.

This file imports no jax and nothing of the JAX package, so on the cards'
machine it runs without the repo's conftest:

    python -m pytest tests/test_torch_multicard.py -m cuda --noconftest -q
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from audiowmark_tpu_torch import add_watermark, device, get_watermark, tables
from audiowmark_tpu_torch.crypto.keys import Key
from audiowmark_tpu_torch.fixtures import acs_check_metrics, acs_equal
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.models import syncfinder
from audiowmark_tpu_torch.ops import resample
from audiowmark_tpu_torch.ops import speed as speed_ops
from audiowmark_tpu_torch.ops import viterbi
from audiowmark_tpu_torch.parallel import batch as fleet
from audiowmark_tpu_torch.parallel.mesh import make_mesh
from audiowmark_tpu_torch.params import Params

MSG = "f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0"


@pytest.fixture
def four_cards(monkeypatch):
    """A CPU-only process that believes it has four cards, the current
    one card 0."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.delenv("AUDIOWMARK_MULTICHIP", raising=False)
    return [torch.device("cuda", i) for i in range(4)]


def test_card_count_and_spread_name_every_card(four_cards, monkeypatch):
    assert device.card_count() == 4
    assert syncfinder.group_device_count() == 4
    assert speed_ops.scan_device_count() == 4
    assert device.spread(None, 4) == four_cards
    assert device.spread(None, 6) == four_cards + four_cards[:2]
    assert device.card_count("cpu") == 1
    monkeypatch.setenv("AUDIOWMARK_MULTICHIP", "0")
    assert device.card_count() == 1
    assert syncfinder.group_device_count() == 1
    assert speed_ops.scan_device_count() == 1


def test_resolve_names_the_card_by_its_index(four_cards, monkeypatch):
    """The default card is cuda:<current>, the very key that spread and
    every tensor's .device give (torch.device("cuda") != cuda:0)."""
    assert device.resolve() == device.resolve("cuda") == four_cards[0]
    assert device.resolve() == device.spread(None, 1)[0]
    assert device.resolve("cuda:2") == four_cards[2]
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert device.resolve() == four_cards[3]
    assert device.resolve("cpu") == torch.device("cpu")


@pytest.mark.parametrize("dp,shape", [(0, (4, 1)), (2, (2, 2))])
def test_make_mesh_lays_every_card(four_cards, dp, shape):
    mesh = make_mesh(dp=dp)
    assert mesh.shape == shape
    assert list(mesh.devices.reshape(-1)) == four_cards


def test_make_mesh_follows_the_multichip_switch(four_cards, monkeypatch):
    monkeypatch.setenv("AUDIOWMARK_MULTICHIP", "0")
    mesh = make_mesh()
    assert mesh.shape == (1, 1) and mesh.devices[0, 0] == four_cards[0]
    assert make_mesh(4).shape == (4, 1)     # a count asked for is kept


def tables_of(t, dev):
    return tables.tables_to_device(t, dev)


def test_device_cache_holds_one_copy_per_card(four_cards, monkeypatch):
    """tables_to_device for the default card and for cuda:0 is one upload
    (the chunk-group search names cuda:0, the decode the default card)."""
    uploads = []
    monkeypatch.setattr(tables, "_upload",
                        lambda t, dev: uploads.append(dev) or {"dev": dev})
    monkeypatch.setattr(tables, "_device_cache", {})
    t = tables.get_key_tables(Key())
    assert tables_of(t, None) is tables_of(t, "cuda:0") \
        is tables_of(t, four_cards[0])
    assert tables_of(t, "cuda:1") is not tables_of(t, None)
    assert uploads == [four_cards[0], four_cards[1]]


# ---- on the cards ---------------------------------------------------------

@pytest.fixture
def cards():
    """cuda:0 .. cuda:n-1 where n >= 2 cards are present; skips otherwise.
    Params are reset around each test."""
    if not torch.cuda.is_available():
        pytest.skip("needs two or more CUDA cards (none present)")
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards (%d present)" % n)
    Params.reset()
    tables.clear_cache()
    yield [torch.device("cuda", i) for i in range(n)]
    Params.reset()
    tables.clear_cache()


@contextlib.contextmanager
def one_card(monkeypatch):
    monkeypatch.setenv("AUDIOWMARK_MULTICHIP", "0")
    try:
        yield
    finally:
        monkeypatch.delenv("AUDIOWMARK_MULTICHIP")


def reduced_geometry():
    Params.sync_frames_per_bit = 30
    Params.frames_per_bit = 1


def noise_file(path, seconds, rate, seed):
    rng = np.random.RandomState(seed)
    WavData(((rng.rand(seconds * rate * 2) * 2 - 1) * 0.5).astype(np.float32),
            2, rate, 16).save(path)


def cmp_text(path):
    """`cmp` of `path` on the default card(s): (exit code, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = get_watermark([Key()], path, MSG)
    return rc, out.getvalue()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8, 24, 256])
def test_k1_on_every_card_equals_plain(cards, batch):
    viterbi.LAUNCHES_BY_CARD.clear()
    for i, card in enumerate(cards):
        bm = acs_check_metrics(batch + i, batch, 143, card)
        got = viterbi.viterbi_acs(bm)
        assert all(t.device == card for t in got)
        assert acs_equal(got, viterbi.viterbi_acs_plain(bm)), card
        del bm, got
    assert viterbi.LAUNCHES_BY_CARD == {i: 1 for i in range(len(cards))}


@pytest.mark.cuda
@pytest.mark.parametrize("coeff_dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ratio", [44100 / 48000, 0.98 / 2])
def test_k2_on_every_card_equals_plain(cards, ratio, coeff_dtype):
    """K2 against the plain rows on each card, an hour into a stream, on
    that card's current stream: bit for bit."""
    n_taps = resample._filter_params(ratio)[3]
    j0 = 3600 * 44100 + 7
    resample.LAUNCHES_BY_CARD.clear()
    for i, card in enumerate(cards):
        rng = np.random.RandomState(i)
        xpad = torch.from_numpy(((rng.rand(70000 + n_taps, 2) * 2 - 1) * 0.9)
                                .astype(np.float32)).to(card)
        args = (xpad, j0, int(70000 * ratio), ratio,
                -int(np.floor(j0 / ratio)), coeff_dtype)
        got = resample._resample_rows(*args)
        assert got.device == card
        assert torch.equal(got, resample._resample_rows_plain(*args)), card
    assert resample.LAUNCHES_BY_CARD == {i: 1 for i in range(len(cards))}


@pytest.mark.cuda
def test_group_search_over_the_cards_equals_one_card(cards, tmp_path,
                                                     monkeypatch):
    """Four chunks of 75 s of a 110 s file: one group, a row per card on
    four cards (zero rows where the cards outnumber the chunks)."""
    reduced_geometry()
    noise, marked = str(tmp_path / "n.wav"), str(tmp_path / "wm.wav")
    noise_file(noise, 110, 44100, 11)
    assert add_watermark(Key(), noise, marked, MSG) == 0
    Params.get_chunk_size = 1.25
    with one_card(monkeypatch):
        want = cmp_text(marked)
    assert want[0] == 0 and "match_count" in want[1]

    groups = []
    real = syncfinder.search_block_group

    def spy(key_list, wavs, dev=None, xs=None):
        groups.append((list(wavs), real(key_list, wavs, dev, xs)))
        return groups[-1][1]

    monkeypatch.setattr(syncfinder, "search_block_group", spy)
    assert cmp_text(marked) == want
    assert [len(w) for w, _ in groups] == [4]
    wavs, got = groups[0]
    assert got is not None
    for wav, per_card in zip(wavs, got):
        alone = syncfinder.search([Key()], wav, syncfinder.SyncMode.BLOCK)
        assert [(s.index, s.block_type, s.quality)
                for s in per_card[0].sync_scores] == \
            [(s.index, s.block_type, s.quality) for s in alone[0].sync_scores]


@pytest.mark.cuda
def test_get_follows_the_callers_current_card(cards, tmp_path, monkeypatch):
    """A 32 kHz file of 80 s in two chunks, the second loaded and resampled
    by the prefetch thread: under torch.cuda.device(1) the whole get runs
    on card 1 and prints what it prints on card 0."""
    reduced_geometry()
    noise, marked = str(tmp_path / "n.wav"), str(tmp_path / "wm.wav")
    noise_file(noise, 80, 32000, 12)
    assert add_watermark(Key(), noise, marked, MSG) == 0
    Params.get_chunk_size = 1.25
    monkeypatch.setenv("AUDIOWMARK_PREFETCH", "1")
    with one_card(monkeypatch):
        want = cmp_text(marked)
        viterbi.LAUNCHES_BY_CARD.clear()
        resample.LAUNCHES_BY_CARD.clear()
        with torch.cuda.device(1):
            got = cmp_text(marked)
    assert want[0] == 0 and got == want
    assert set(viterbi.LAUNCHES_BY_CARD) == {1}
    assert set(resample.LAUNCHES_BY_CARD) == {1}


@pytest.mark.cuda
@pytest.mark.parametrize("n_centers", [15, 5])
def test_speed_scan_split_equals_one_card(cards, monkeypatch, n_centers):
    """15 centres over 4 cards: 4 + 4 + 4 + 3; 5: 2 + 2 + 1 (card 3
    idle)."""
    reduced_geometry()
    bits = speed_ops.build_speed_sync_bits(tables.get_key_tables(Key()))
    rng = np.random.RandomState(14)
    clip = ((rng.rand(8 * 44100 * 2) * 2 - 1) * 0.5).astype(np.float32)
    centers = [0.9764 * 1.0007 ** (c - n_centers // 2)
               for c in range(n_centers)]
    rels = [1.0007 ** p for p in range(-2, 3)]
    with one_card(monkeypatch):
        want = speed_ops.speed_scan(clip, 2, centers, 6.0, rels, bits)
    on = []
    real = speed_ops._center_mag_matrix
    monkeypatch.setattr(speed_ops, "_center_mag_matrix",
                        lambda x, *a: on.append(x.device.index) or real(x, *a))
    resample.LAUNCHES_BY_CARD.clear()
    got = speed_ops.speed_scan(clip, 2, centers, 6.0, rels, bits)
    assert got == want and max(q for row in got for q, _ in row) > 0
    per = -(-n_centers // len(cards))
    assert on == [i // per for i in range(n_centers)]
    assert set(resample.LAUNCHES_BY_CARD) == set(on)


def fleet_audio(n_streams):
    rng = np.random.RandomState(7)
    return (rng.rand(n_streams, 1200 * 1024, 2).astype(np.float32) - 0.5) \
        * 0.6


@pytest.fixture
def mini_fleet(cards):
    """The mini geometry of tests/test_torch_batch.py (short-12 payload, 10
    sync frames per bit, T = 1200 frames), two streams per card."""
    Params.payload_short = 12
    Params.payload_size = 12
    Params.sync_frames_per_bit = 10
    return fleet_audio(2 * len(cards))


@pytest.mark.cuda
@pytest.mark.parametrize("dp", [0, 2])
def test_watermark_batch_over_the_cards_equals_one_card(
        cards, mini_fleet, monkeypatch, dp):
    n = len(cards)
    if dp and n % dp:
        pytest.skip("dp=%d does not divide %d cards" % (dp, n))
    mesh = make_mesh(dp=dp)
    assert mesh.shape == ((n, 1) if dp == 0 else (2, n // 2))
    with one_card(monkeypatch):
        assert make_mesh().shape == (1, 1)
        want = fleet.watermark_batch(Key(), mini_fleet, "abc")
    got = fleet.watermark_batch(Key(), mini_fleet, "abc", mesh=mesh)
    assert np.array_equal(got, want)
    assert np.abs(want - mini_fleet).max() > 1e-4


@pytest.mark.cuda
def test_detect_batch_over_the_cards_equals_one_card(cards, mini_fleet,
                                                     monkeypatch):
    with one_card(monkeypatch):
        marked = fleet.watermark_batch(Key(), mini_fleet, "abc")
        want = fleet.detect_batch(Key(), marked, top_k=4)
    viterbi.LAUNCHES_BY_CARD.clear()
    got = fleet.detect_batch(Key(), marked, top_k=4)
    assert viterbi.LAUNCHES_BY_CARD == {i: 1 for i in range(len(cards))}
    assert set(got) == set(want)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    assert got["eligible"].any()

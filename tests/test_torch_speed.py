"""Replay-speed detection of the port vs the JAX package, on the CPU.

* ops: the sync-entry tables, the mag matrix, the 16.16 offset tables and
  the row indices (exact against the int64 formula and against the JAX
  package's int32 hi/lo halves), the offset compare on one shared mag
  matrix, and the whole scan against `speed_fused.speed_scan` and against
  the port's own staged pair.
* models: clip choice, local maxima, the smoothed argmax (exact), and one
  scan of `_KeySearch` on both packages.
* end to end: `--try-speed` and `--detect-speed` through `get_watermark`
  on a file whose speed was changed; the full grid of
  tests/test_speed.py (production geometry) is marked slow.

Most tests use a reduced geometry (30 sync frames per bit, 1 frame per
bit: 1038 frames per block); both packages' Params are reset and set
alike.  Tolerances found on the CPU are written at each test.
"""

import numpy as np
import pytest
import torch

from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.io.wavdata import WavData as JWavData
from audiowmark_tpu.models import speed as j_speed
from audiowmark_tpu.ops import speed as j_ops
from audiowmark_tpu.ops import speed_fused as j_fused
from audiowmark_tpu.ops.resample import resample_buffer as j_resample_buffer
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu.tables import get_key_tables as j_tables
from audiowmark_tpu_torch.crypto.keys import Key as TKey
from audiowmark_tpu_torch.io.wavdata import WavData as TWavData
from audiowmark_tpu_torch.models import speed as t_speed
from audiowmark_tpu_torch.ops import speed as t_ops
from audiowmark_tpu_torch.ops.resample import (resample_buffer,
                                               resample_frames)
from audiowmark_tpu_torch.params import Params as TParams
from audiowmark_tpu_torch.tables import get_key_tables as t_tables

torch.set_num_threads(2)
MSG = "f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0"


def _set(**values):
    for params in (JParams, TParams):
        for name, value in values.items():
            setattr(params, name, value)


def _reset():
    JParams.reset()
    TParams.reset()


@pytest.fixture(autouse=True)
def geometry():
    _reset()
    _set(sync_frames_per_bit=30, frames_per_bit=1)
    yield
    _reset()


def _sync_bits():
    return (j_ops.build_speed_sync_bits(j_tables(JKey())),
            t_ops.build_speed_sync_bits(t_tables(TKey())))


def _clip(seed, seconds, scale=0.3):
    rng = np.random.RandomState(seed)
    return (rng.randn(2 * int(seconds * 44100)) * scale).astype(np.float32)


@pytest.mark.parametrize("production", [False, True])
def test_sync_bits_match_jax(production):
    if production:
        _reset()
    j, t = _sync_bits()
    assert t.frames_per_block == j.frames_per_block
    assert t.frame.dtype == j.frame.dtype and np.array_equal(t.frame, j.frame)
    assert np.array_equal(t.bit, j.bit)
    assert t.v.shape == (2 * 6 * TParams.sync_frames_per_bit, t_ops.N_BANDS)
    assert np.array_equal(t.v, j.v)
    assert np.array_equal(t_ops._sub_window(), j_ops._sub_window())


@pytest.mark.parametrize("ratio", [0.425, 0.5, 0.6, 1.0])
def test_resample_frames_is_resample_buffer(ratio):
    """The tensor form gives resample_buffer's output bit for bit (it is
    its body), and the JAX package's within the resampler's atol 1e-6."""
    x = _clip(5, 1.5)
    got = resample_frames(torch.from_numpy(x.reshape(-1, 2)), ratio)
    assert got.shape == (int(round(x.size // 2 * ratio)), 2)
    want = resample_buffer(x, 2, ratio, device="cpu")
    assert np.array_equal(got.numpy().reshape(-1), want)
    np.testing.assert_allclose(want, j_resample_buffer(x, 2, ratio),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("center", [0.85, 1.0, 1.2])
def test_mag_matrix_matches_jax(center):
    """prepare_mag_matrix on a seeded stereo clip: shape exact; the dB band
    sums (30 bands x 2 channels, each ~ -60..-20 dB) within rtol 1e-4,
    atol 2e-3.  Found on the CPU: max abs difference 9.8e-4 (two float32
    steps at ~ -4000)."""
    j_bits, t_bits = _sync_bits()
    clip = _clip(3, 6)
    want = j_ops.prepare_mag_matrix(clip, 2, center, 4.0, j_bits)
    got = t_ops.prepare_mag_matrix(clip, 2, center, 4.0, t_bits,
                                   device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    assert got.shape[0] == t_ops.mag_rows(
        int(round(int(round(44100 * 4.0 / center)) * (center / 2))))
    print("mag matrix max abs difference: %g" % np.abs(got - want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-3)


def test_mag_rows_is_the_loop_rule():
    for n in (0, 511, 512, 513, 640, 641, 5000):
        rows, pos = 0, 0
        while pos + t_ops.SUB_FRAME < n:
            rows += 1
            pos += t_ops.SUB_HOP
        assert t_ops.mag_rows(n) == rows


def test_mag_matrix_of_silence_is_minus_96_db():
    """abs2 == 0 takes -96 dB, not log2(0)."""
    _, t_bits = _sync_bits()
    D = t_ops.prepare_mag_matrix(np.zeros(2 * 4000, np.float32), 2, 1.0, 1.0,
                                 t_bits, device="cpu")
    assert D.shape[0] > 0
    assert np.array_equal(D, np.full_like(D, -96.0 * 2 * 30))


RELS = [1.0007 ** p for p in range(-5, 6)] + \
       [1.00005 ** p for p in range(-40, 41)]


@pytest.mark.parametrize("production", [False, True])
def test_offset_tables_and_row_indices_are_exact(production):
    """The port's int64 tables equal the JAX package's int32 hi/lo halves
    put together again, and the rows the device computes from them,
    (state_off + frame_off) >> 16, equal both the int64 formula in numpy
    and the JAX package's hi + hi + carry."""
    if production:
        _reset()
    j_bits, t_bits = _sync_bits()
    s_off, f_off = t_ops.offset_tables(RELS, t_bits)
    assert s_off.dtype == f_off.dtype == np.int64
    assert s_off.shape == (len(RELS), 4 * t_bits.frames_per_block + 4)
    assert f_off.shape == (len(RELS), 3 * t_bits.frame.size)
    so_hi, so_lo, fo_hi, fo_lo = j_fused._offset_tables(tuple(RELS), j_bits)
    assert np.array_equal(s_off, (so_hi.astype(np.int64) << 16) | so_lo)
    assert np.array_equal(f_off, (fo_hi.astype(np.int64) << 16) | fo_lo)

    for r in (0, 5, 10, 11, 51, len(RELS) - 1):
        states = slice(None, None, 7 if production else 1)
        idx, nonneg = t_ops.row_index(torch.from_numpy(s_off[r, states]),
                                      torch.from_numpy(f_off[r]))
        raw = s_off[r, states, None] + f_off[r][None, :]
        assert np.array_equal(idx.numpy(), raw >> 16)
        assert np.array_equal(nonneg.numpy(), raw >= 0)
        carry = (so_lo[r, states, None] + fo_lo[r][None, :]) >> 16
        j_idx = so_hi[r, states, None] + fo_hi[r][None, :] + carry
        assert np.array_equal(idx.numpy(), j_idx)
        assert np.array_equal(nonneg.numpy(), j_idx >= 0)


def test_compare_on_the_same_mag_matrix_matches_jax():
    """compare_speed_batch of both packages on ONE mag matrix (the JAX
    package's): speeds exact, qualities within abs 1e-5.  Found on the
    CPU: max abs difference 3.4e-6."""
    j_bits, t_bits = _sync_bits()
    D = j_ops.prepare_mag_matrix(_clip(4, 30, 0.2), 2, 1.0, 25.0, j_bits)
    rels = [1.0007 ** p for p in (-5, -1, 0, 2, 5)] + [0.7, 1.4]
    want = j_ops.compare_speed_batch(D, j_bits, rels, 0.95)
    got = t_ops.compare_speed_batch(D, t_bits, rels, 0.95, device="cpu")
    assert [s for _, s in got] == [s for _, s in want]
    dq = np.abs(np.array([q for q, _ in got]) - [q for q, _ in want])
    print("compare on equal D, max abs quality difference: %g" % dq.max())
    assert max(q for q, _ in want) > 0.01
    assert dq.max() <= 1e-5


def test_compare_passes_do_not_change_the_result(monkeypatch):
    """The rels go through compare_speed_core in passes bounded by
    _WORKSPACE: one rel per pass gives what all in one pass give."""
    _, t_bits = _sync_bits()
    D = t_ops.prepare_mag_matrix(_clip(9, 8), 2, 1.0, 6.0, t_bits,
                                 device="cpu")
    rels = [1.0007 ** p for p in range(-3, 4)]
    whole = t_ops.compare_speed_batch(D, t_bits, rels, 1.0, device="cpu")
    monkeypatch.setattr(t_ops, "_WORKSPACE", 1)
    assert t_ops.compare_speed_batch(D, t_bits, rels, 1.0,
                                     device="cpu") == whole


def _staged(clip, centers, seconds, rels, bits):
    return [t_ops.compare_speed_batch(
        t_ops.prepare_mag_matrix(clip, 2, c, seconds, bits, device="cpu"),
        bits, rels, c, device="cpu") for c in centers]


def test_speed_scan_matches_jax_and_the_staged_pair():
    """A short scan (6 s clip, 3 centres, one off the grid, 5 rels):
    speeds within 1e-12 and qualities within abs 1e-4 of the JAX package's
    speed_fused.speed_scan, as its own tests hold it to its staged pair;
    the port's staged pair gives the scan's qualities within 1e-6 (the
    scan drops entries that are masked everywhere).  Found on the CPU:
    3.5e-6 against the JAX package, 0 against the staged pair."""
    j_bits, t_bits = _sync_bits()
    clip = _clip(3, 6)
    centers = [0.95, 1.0, 1.0007 ** 33]
    rels = [1.0007 ** p for p in range(-2, 3)]
    want = j_fused.speed_scan(clip, 2, centers, 4.0, rels, j_bits)
    got = t_ops.speed_scan(clip, 2, centers, 4.0, rels, t_bits, device="cpu")
    staged = _staged(clip, centers, 4.0, rels, t_bits)
    assert [len(row) for row in got] == [len(rels)] * len(centers)
    worst = [0.0, 0.0]
    for grow, wrow, srow in zip(got, want, staged):
        for (q, sp), (wq, wsp), (sq, ssp) in zip(grow, wrow, srow):
            assert sp == pytest.approx(wsp, abs=1e-12) and sp == ssp
            worst = [max(worst[0], abs(q - wq)), max(worst[1], abs(q - sq))]
    print("speed_scan max abs quality difference: %g vs jax, %g vs staged"
          % tuple(worst))
    assert max(q for row in want for q, _ in row) > 0.01
    assert worst[0] <= 1e-4 and worst[1] <= 1e-6


def test_speed_scan_truncates_like_jax():
    """scan_seconds / centre of the clip is read, for a centre above and
    one below 1."""
    j_bits, t_bits = _sync_bits()
    clip = _clip(11, 8, 0.2)
    want = j_fused.speed_scan(clip, 2, [0.85, 1.2], 5.0, [1.0], j_bits)
    got = t_ops.speed_scan(clip, 2, [0.85, 1.2], 5.0, [1.0], t_bits,
                           device="cpu")
    for grow, wrow in zip(got, want):
        assert grow[0][0] == pytest.approx(wrow[0][0], abs=1e-4)


def test_speed_scan_of_a_tiny_clip_is_zero():
    _, t_bits = _sync_bits()
    clip = np.zeros(2 * 512, np.float32)   # fewer than SUB_FRAME sub-frames
    assert t_ops.speed_scan(clip, 2, [1.0], 1.0, [1.0], t_bits,
                            device="cpu") == [[(0.0, 1.0)]]
    assert t_ops.compare_speed_batch(np.zeros((0, 360), np.float32), t_bits,
                                     [1.0, 1.1], 0.9, device="cpu") \
        == [(0.0, 0.9), (0.0, 1.1 * 0.9)]


@pytest.mark.parametrize("n_dev,n_centers", [(2, 5), (4, 5), (8, 1),
                                             (3, 12)])
def test_speed_scan_over_devices_equals_one_device(monkeypatch, n_dev,
                                                   n_centers):
    """The centres split over logical devices (every one the CPU), shares
    of unequal size and more devices than centres included: the grid of
    one device, bit for bit (tests/test_speed_multichip.py's cases)."""
    _, t_bits = _sync_bits()
    clip = _clip(5, 4, 0.3)
    centers = [0.9 * 1.0007 ** (11 * c) for c in range(n_centers)]
    rels = [1.0007 ** p for p in range(-2, 3)]
    assert t_ops.scan_device_count("cpu") == 1
    single = t_ops.speed_scan(clip, 2, centers, 3.0, rels, t_bits,
                              device="cpu")
    seen = []
    monkeypatch.setattr(t_ops, "scan_device_count",
                        lambda device=None: seen.append(device) or n_dev)
    sharded = t_ops.speed_scan(clip, 2, centers, 3.0, rels, t_bits,
                               device="cpu")
    assert seen == ["cpu"] and sharded == single
    assert max(q for row in single for q, _ in row) > 0


def test_scan_device_count_follows_the_multichip_switch(monkeypatch):
    monkeypatch.setenv("AUDIOWMARK_MULTICHIP", "0")
    assert t_ops.scan_device_count("cpu") == 1
    monkeypatch.setenv("AUDIOWMARK_MULTICHIP", "1")
    assert t_ops.scan_device_count("cpu") == 1
    assert t_ops.spread("cpu", 3) == [torch.device("cpu")] * 3


def test_speed_scan_needs_a_card_unless_told():
    _, t_bits = _sync_bits()
    if torch.cuda.is_available():
        pytest.skip("there is a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ops.speed_scan(_clip(1, 1), 2, [1.0], 1.0, [1.0], t_bits)


# ---- models/speed.py ---------------------------------------------------------

def _wavs(seed, seconds):
    x = _clip(seed, seconds)
    return JWavData(x, 2, 44100, 16), TWavData(x, 2, 44100, 16)


def test_clip_choice_matches_jax():
    """The keyed, content-hashed clip locations and the one of most
    energy: exact (host PRNG and float64 sums on both sides)."""
    j_wav, t_wav = _wavs(21, 12)
    j_key, t_key = JKey(), TKey()
    j_key.set_test_key(3)
    t_key.set_test_key(3)
    want = j_speed._get_clip_locations(j_key, j_wav, 5)
    assert t_speed._get_clip_locations(t_key, t_wav, 5) == want
    assert len(set(want)) == 5 and all(0 <= x < 1 for x in want)
    best = j_speed._get_best_clip_location(j_key, j_wav, 4.0, 5)
    assert t_speed._get_best_clip_location(t_key, t_wav, 4.0, 5) == best
    assert best in want
    a = j_speed._get_speed_clip(0.37, j_wav, 4.0).samples
    b = t_speed._get_speed_clip(0.37, t_wav, 4.0).samples
    assert a.size == 2 * 4 * 44100 and np.array_equal(a, b)


def test_score_selection_matches_jax():
    """Local maxima (double peaks included), top n, and the cosine-smoothed
    argmax on the 1e-6 grid: exact."""
    rng = np.random.RandomState(8)
    speeds = 0.9 * 1.0007 ** np.arange(60)
    quals = rng.rand(60)
    quals[10] = quals[11] = 0.99            # a double peak
    quals[30:33] = 0.5                      # a plateau
    order = rng.permutation(60)
    j_scores = [j_speed.Score(speeds[i], quals[i]) for i in order]
    t_scores = [t_speed.Score(speeds[i], quals[i]) for i in order]
    for n in (1, 5, 15, 100):
        want = j_speed._select_n_best_scores(j_scores, n)
        got = t_speed._select_n_best_scores(t_scores, n)
        assert [(s.speed, s.quality) for s in got] == \
            [(s.speed, s.quality) for s in want]
    assert t_speed._select_n_best_scores([], 3) == []
    fine = [1.01 * 1.00005 ** p for p in range(-40, 41)]
    fq = np.exp(-((np.arange(81) - 47.3) / 9.0) ** 2) + 0.01 * rng.rand(81)
    want = j_speed._score_smooth_find_best(
        [j_speed.Score(s, q) for s, q in zip(fine, fq)], 1 - 1.00005, 20.0)
    got = t_speed._score_smooth_find_best(
        [t_speed.Score(s, q) for s, q in zip(fine, fq)], 1 - 1.00005, 20.0)
    assert got == want and fine[40] < got < fine[55]
    assert t_speed._score_smooth_find_best([t_speed.Score(1.0, 0.3)],
                                           1 - 1.00005, 20.0) == 1.0


def test_key_search_scan_matches_jax():
    """One scan of _KeySearch (4 s, step 1.0007, 2 steps, 1 centre step
    around 0.98 and 1.02: 6 centres x 5 rels) on both packages: the same
    speeds in the same order, qualities within abs 1e-4."""
    j_wav, t_wav = _wavs(13, 8)
    j_ks = j_speed._KeySearch(JKey(), j_wav, 0.4)
    t_ks = t_speed._KeySearch(TKey(), t_wav, 0.4, "cpu")
    j_ks.run_scan(j_speed.ScanParams(4, 1.0007, 2, 1), [0.98, 1.02])
    t_ks.run_scan(t_speed.ScanParams(4, 1.0007, 2, 1), [0.98, 1.02])
    assert len(t_ks.scores) == 30
    assert [s.speed for s in t_ks.scores] == \
        pytest.approx([s.speed for s in j_ks.scores], abs=1e-12)
    dq = np.abs(np.array([s.quality for s in t_ks.scores])
                - [s.quality for s in j_ks.scores])
    print("run_scan max abs quality difference: %g" % dq.max())
    assert dq.max() <= 1e-4


# ---- end to end --------------------------------------------------------------

@pytest.fixture(scope="module")
def fast_file(tmp_path_factory):
    """80 s of seeded noise marked by the port on the CPU (reduced
    geometry: blocks A, B, A, no clip decoder at that length), played at
    speed 1.01."""
    from audiowmark_tpu_torch import add_watermark
    from audiowmark_tpu_torch.ops.resample import resample_ratio
    _reset()
    _set(sync_frames_per_bit=30, frames_per_bit=1)
    d = tmp_path_factory.mktemp("speed")
    noise, marked, fast = (str(d / n) for n in ("n.wav", "wm.wav", "s.wav"))
    rng = np.random.RandomState(7)
    TWavData(((rng.rand(80 * 44100 * 2) * 2 - 1) * 0.5).astype(np.float32),
             2, 44100, 16).save(noise)
    assert add_watermark(TKey(), noise, marked, MSG, device="cpu") == 0
    resample_ratio(TWavData.load(marked), 1 / 1.01, 44100,
                   device="cpu").save(fast)
    _reset()
    return fast


def _short_scans(monkeypatch, seconds):
    """detect_speed of both packages with every scan cut to `seconds` of
    audio and scan1 to 3 centres (speeds 0.9890 to 1.0112)."""
    for mod in (j_speed, t_speed):
        def short(secs, step, n_steps, n_center_steps=0, cls=mod.ScanParams):
            return cls(min(secs, seconds), step, n_steps,
                       min(n_center_steps, 1))
        monkeypatch.setattr(mod, "ScanParams", short)


@pytest.mark.parametrize("patient", [False, True])
def test_detect_speed_matches_jax_on_short_scans(fast_file, monkeypatch,
                                                 capsys, patient):
    """The three scans, the choice of local maxima between them, the
    smoothed argmax and the acceptance, on 14 s of the file at speed 1.01
    with scans of 10 s (44.1 kHz input: both packages hash the same
    samples and scan the same clip): the same key and a speed within 5e-6
    of the JAX package's and 0.05 % of the truth, the printed quality
    within 1e-3.  Found on the CPU: speeds equal, quality 1e-6 apart."""
    _short_scans(monkeypatch, 10)
    _set(test_speed=1.01, detect_speed_patient=patient)
    x = TWavData.load(fast_file).samples[:14 * 44100 * 2]
    capsys.readouterr()
    want = j_speed.detect_speed([JKey()], JWavData(x, 2, 44100, 16), True)
    j_line = capsys.readouterr().out.split()
    got = t_speed.detect_speed([TKey()], TWavData(x, 2, 44100, 16), True,
                               "cpu")
    t_line = capsys.readouterr().out.split()
    assert len(got) == len(want) == 1
    assert abs(got[0][1] - want[0][1]) <= 5e-6
    assert abs(got[0][1] - 1.01) / 1.01 < 0.0005
    assert j_line[0] == t_line[0] == "detect_speed" and len(t_line) == 4
    assert abs(float(t_line[1]) - float(j_line[1])) <= 5e-6
    assert abs(float(t_line[2]) - float(j_line[2])) <= 1e-3
    assert float(t_line[2]) > 0.4
    assert t_speed.detect_speed([TKey()], TWavData(x[:4000], 2, 44100, 16),
                                True, "cpu") == []      # under 0.25 s


def test_detect_speed_at_48k_matches_jax(fast_file, monkeypatch, capsys,
                                         tmp_path):
    """cmp --detect-speed of 20 s of the file at speed 1.01 resampled to
    48 kHz (short scans as above), through each package's get_watermark.
    Each package's chunk loader resamples to 44.1 kHz with its own
    resampler (~1e-6 apart), and the clip is chosen by a hash of those
    float32 samples, so the packages may scan different clips: either clip
    is accepted.  Both detect a speed within the reference's 0.05 % of the
    truth (tests/test_speed.py:43-48) and within 0.05 % of each other."""
    from audiowmark_tpu.models.getter import get_watermark as j_get
    from audiowmark_tpu_torch import get_watermark as t_get
    from audiowmark_tpu_torch.ops.resample import resample
    _short_scans(monkeypatch, 10)
    x = TWavData.load(fast_file).samples[:20 * 44100 * 2]
    path = str(tmp_path / "s48.wav")
    resample(TWavData(x, 2, 44100, 16), 48000, device="cpu").save(path)
    _set(detect_speed=True, test_speed=1.01)
    lines = {}
    for name, get, key, kw in (("jax", j_get, JKey, {}),
                               ("port", t_get, TKey, dict(device="cpu"))):
        capsys.readouterr()
        get([key()], path, MSG, **kw)
        lines[name] = [line.split() for line in capsys.readouterr().out
                       .splitlines() if line.startswith("detect_speed ")]
    assert len(lines["jax"]) == len(lines["port"]) == 1
    got, want = float(lines["port"][0][1]), float(lines["jax"][0][1])
    print("48 kHz detect_speed: port %s, JAX %s" % (lines["port"][0],
                                                    lines["jax"][0]))
    assert abs(got - 1.01) / 1.01 < 5e-4 and abs(want - 1.01) / 1.01 < 5e-4
    assert abs(got - want) / want < 5e-4


@pytest.mark.parametrize("option", ["detect_speed", "detect_speed_patient",
                                    "try_speed"])
def test_get_watermark_with_a_speed_option(fast_file, monkeypatch, capsys,
                                           option):
    """get_watermark as cmp on the CPU with each speed option (short scans
    as above): without one the file at speed 1.01 does not match; with one
    it does, at a speed within 0.05 % of 1.01, with -SPEED patterns that
    carry the message.  With --try-speed no scan runs."""
    from audiowmark_tpu_torch import get_watermark
    _short_scans(monkeypatch, 10)
    capsys.readouterr()
    assert get_watermark([TKey()], fast_file, MSG, device="cpu") == 1
    plain = capsys.readouterr().out
    assert "match_count 0 " in plain and "SPEED" not in plain
    TParams.reset()
    _set(sync_frames_per_bit=30, frames_per_bit=1)
    setattr(TParams, option, 1.01 if option == "try_speed" else True)
    assert get_watermark([TKey()], fast_file, MSG, device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(l.startswith("detect_speed ") for l in lines) \
        == (option != "try_speed")
    speed = [float(l.split()[1]) for l in lines if l.startswith("speed ")]
    assert len(speed) == 1 and abs(speed[0] - 1.01) / 1.01 < 0.0005
    marked = [l.split() for l in lines if l.startswith("pattern")
              and l.split()[2] == MSG]
    assert marked and all(f[-1].endswith("SPEED") for f in marked)
    assert int([l for l in lines if l.startswith("match_count")][0]
               .split()[1]) == len(marked)


@pytest.fixture(scope="module")
def production_wavs(tmp_path_factory):
    """30 s of test-gen-noise, marked by the JAX package at production
    geometry, as in tests/test_speed.py."""
    from audiowmark_tpu.cli import main as j_main
    d = tmp_path_factory.mktemp("grid")
    noise, marked = str(d / "n.wav"), str(d / "wm.wav")
    _reset()
    assert j_main(["test-gen-noise", noise, "30", "44100"]) == 0
    _reset()
    assert j_main(["--strict", "add", noise, marked, MSG]) == 0
    return d, marked


@pytest.mark.slow
@pytest.mark.parametrize("patient", [False, True])
@pytest.mark.parametrize("speed", ["0.9764", "1.0", "1.01"])
def test_detect_speed_grid_matches_jax(production_wavs, capsys, monkeypatch,
                                       speed, patient):
    """The grid of tests/test_speed.py::test_detect_speed_grid through both
    CLIs at production geometry: exit codes 0, the detect_speed lines
    within 5e-6 in speed and 1e-3 in quality, the other lines equal with
    qualities and errors within their 3 decimals."""
    from audiowmark_tpu.cli import main as j_main
    from audiowmark_tpu_torch.cli import main as t_main
    monkeypatch.setenv("AUDIOWMARK_TORCH_DEVICE", "cpu")
    d, marked = production_wavs
    spd = str(d / ("grid_%s.wav" % speed))
    _reset()
    assert j_main(["test-change-speed", marked, spd, speed]) == 0
    flag = "--detect-speed-patient" if patient else "--detect-speed"
    argv = ["--strict", "cmp", spd, MSG, flag, "--test-speed", speed]
    outs = []
    for main in (j_main, t_main):
        _reset()
        capsys.readouterr()
        assert main(list(argv)) == 0
        outs.append(capsys.readouterr().out.splitlines())
    j_out, t_out = outs
    print("\n".join(l for l in j_out + t_out if "pattern" not in l))
    assert len(j_out) == len(t_out)
    for j_line, t_line in zip(j_out, t_out):
        j_words, t_words = j_line.split(), t_line.split()
        if j_words[0] == "detect_speed":
            assert abs(float(t_words[1]) - float(j_words[1])) <= 5e-6
            assert abs(float(t_words[2]) - float(j_words[2])) <= 1e-3
        elif j_words[0] == "speed":
            assert abs(float(t_words[1]) - float(j_words[1])) <= 5e-6
        elif j_words[0] == "pattern":
            assert t_words[1:3] + t_words[5:] == j_words[1:3] + j_words[5:]
            assert abs(float(t_words[3]) - float(j_words[3])) <= 0.002
            assert abs(float(t_words[4]) - float(j_words[4])) <= 0.002
        else:
            assert t_line == j_line

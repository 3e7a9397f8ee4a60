"""Replay-speed detection of the port against the benchmark's plain
reference (wmbench/reference/speed.py: float64 torch, no port, no JAX),
on the CPU.

* the keyed, content-hashed clip location and the clip's bounds: exact;
* the 16.16 offset tables and the mag rows they give: exact;
* the mag matrices of a few centres: within the tolerance below;
* the offset scan of one mag matrix: qualities within 2e-5;
* local maxima, top n and the smoothed argmax on the same scores: exact;
* the reference's sync search (the decode at a speed) keeps, beside
  reference/scan.py's candidates, those of start hops that rounding could
  make a local maximum;
* detect_speed with its scans cut to a few seconds on a marked excerpt
  played at 0.97 and at 1.03: both accept a speed within the benchmark's
  `speed_gap` limit of the other's and of the truth;
* the same comparisons with the reference in bfloat16 stages: at least
  one tolerance fails.

A small geometry (a 12-bit payload under the 128-bit code, 10 sync frames
per bit: 384 frames, 8.9 s, per block) keeps the scans small; the
entries' order differs (the port sorts them by frame
across the bits, the reference bit by bit), so the tables are compared
entry for entry through that order.
"""

import json
import os

import numpy as np
import pytest
import torch

from audiowmark_tpu_torch.crypto.keys import Key
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.models import speed as t_speed
from audiowmark_tpu_torch.ops import speed as t_ops
from audiowmark_tpu_torch.params import Params
from audiowmark_tpu_torch.tables import get_key_tables
from wmbench.reference import mark
from wmbench.reference import speed as ref
from wmbench.reference.keyed import Geom
from wmbench.reference.prec import Prec

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = bytes(range(16))
SMALL = dict(payload_size=12, sync_frames_per_bit=10)
# scans cut to a few seconds, scan 1 over 0.953-1.049 in 3 centres
SHORT = {"scan1": (5, 1.003, 5, 1), "scan2": (6, 1.0015, 1, 0),
         "scan3": (6, 1.0001, 20, 0)}
F64, BF16 = Prec("f64"), Prec("bf16")
# the dB band sums of a mag matrix (30 bands x 2 channels of 10 log10
# |X|^2, ~ -4000 in all) lie ~1e-3 from float64's: float32 resampler
# coefficients, rfft and log2, a few float32 steps of 4000 (found on the
# CPU: 1.7e-3 at most)
MAG_ATOL = 5e-3
# the offset scan's qualities on one float64 matrix, the port's float32
# sums against float64 (found: 2.4e-7)
Q_ATOL = 2e-5


def _limit(name):
    with open(os.path.join(ROOT, "wmbench", "traffic",
                           "cd44-scan-speed.json")) as f:
        return json.load(f)["check"]["limits"][name]


@pytest.fixture(autouse=True)
def reduced():
    Params.reset()
    for k, v in SMALL.items():
        setattr(Params, k, v)
    yield
    Params.reset()


def _geom():
    return Geom(**SMALL)


def _port_key():
    """The port's Key holding KEY (its key file's form)."""
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".key", delete=False) as f:
        f.write("key %s\n" % KEY.hex())
    k = Key()
    try:
        k.load_key(f.name)
    finally:
        os.remove(f.name)
    return k


def _noise(seed, seconds, scale=0.3):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(seconds * 44100), 2) * scale * 32767).clip(
        -32768, 32767).astype(np.int16)


def _order(port_bits, entries):
    """Index into the reference's entries of each of the port's."""
    by = {(int(f), int(b)): j for j, (f, b) in
          enumerate(zip(entries.frame, entries.bit))}
    return np.array([by[(int(f), int(b))]
                     for f, b in zip(port_bits.frame, port_bits.bit)])


def _tables(prec=F64):
    bits = t_ops.build_speed_sync_bits(get_key_tables(_port_key()))
    return bits, ref.sync_entries(KEY, _geom(), prec, "cpu")


def test_clip_location_is_exact():
    x = _noise(3, 12)
    flat = (x.astype(np.float32) / np.float32(32768)).reshape(-1)
    wav = WavData(flat, 2, 44100, 16)
    key = _port_key()
    want = t_speed._get_clip_locations(key, wav, 5)
    assert ref.clip_locations(KEY, flat, 5) == want
    xt = torch.from_numpy(x.astype(np.float64) / 32768.0)
    best = t_speed._get_best_clip_location(key, wav, 4.0, 5)
    assert ref.best_clip_location(KEY, xt, flat, 44100, 4.0, 5) == best
    for loc in want + [0.0, 0.999]:
        s, e = ref.clip_bounds(loc, x.shape[0], 44100, 4.0 * 1.3)
        clip = t_speed._get_speed_clip(loc, wav, 4.0 * 1.3).samples
        assert np.array_equal(clip, flat[2 * s:2 * e])


@pytest.mark.parametrize("production", [False, True])
def test_offset_tables_and_rows_are_exact(production):
    if production:
        Params.reset()
    g = Geom() if production else _geom()
    bits = t_ops.build_speed_sync_bits(get_key_tables(_port_key()))
    entries = ref.sync_entries(KEY, g, F64, "cpu")
    order = _order(bits, entries)
    J = order.size
    cols = np.concatenate([b * J + order for b in range(3)])
    rels = [1.0007 ** p for p in range(-5, 6)] + [1.00005 ** 40, 0.8, 1.25]
    s_port, f_port = t_ops.offset_tables(rels, bits)
    s_ref, f_ref = ref.offsets(rels, entries, g)
    assert s_port.dtype == s_ref.dtype == np.int64
    assert np.array_equal(s_port, s_ref)
    assert np.array_equal(f_port, f_ref[:, cols])
    states = slice(None, None, 11 if production else 1)
    for r in (0, 5, 11, len(rels) - 1):
        idx, nonneg = t_ops.row_index(torch.from_numpy(s_port[r, states]),
                                      torch.from_numpy(f_port[r]))
        row, valid = ref.rows_of(torch.from_numpy(s_ref[r, states]),
                                 torch.from_numpy(f_ref[r, cols]), 4000)
        assert torch.equal(idx, row)
        assert torch.equal(nonneg & (idx < 4000), valid)


def _mags(center, prec, seconds=3.0):
    bits, entries = _tables(prec)
    clip = _noise(5, 4)
    port = t_ops.prepare_mag_matrix(
        (clip.astype(np.float32) / np.float32(32768)).reshape(-1), 2,
        center, seconds, bits, device="cpu")
    x = prec.q(torch.from_numpy(clip).to(prec.dtype) / 32768.0)
    up, dn = ref.mag_matrix(x, center, seconds, entries, _geom(), prec)
    order = _order(bits, entries)
    want = np.empty((up.shape[0], 2 * order.size))
    want[:, 0::2] = up.double().numpy()[:, order]
    want[:, 1::2] = dn.double().numpy()[:, order]
    return port, want


def _mag_gap(prec):
    worst = 0.0
    for center in (0.82, 1.0, 1.22):
        port, want = _mags(center, prec)
        assert port.shape == want.shape and port.shape[0] > 0
        worst = max(worst, float(np.abs(port - want).max()))
    return worst


def test_mag_matrices_within_tolerance():
    gap = _mag_gap(F64)
    print("mag matrix max abs difference: %g" % gap)
    assert gap <= MAG_ATOL


def test_compare_grid_on_one_mag_matrix():
    """The port's offset scan of the reference's own float64 matrix (as
    float32) against the reference's scan of it."""
    bits, entries = _tables()
    g = _geom()
    x = torch.from_numpy(_noise(6, 6).astype(np.float64) / 32768.0)
    up, dn = ref.mag_matrix(x, 0.97, 5.0, entries, g, F64)
    order = _order(bits, entries)
    D = np.empty((up.shape[0], 2 * order.size), np.float32)
    D[:, 0::2] = up.numpy()[:, order]
    D[:, 1::2] = dn.numpy()[:, order]
    rels = [1.0007 ** p for p in range(-5, 6)]
    port = np.array([q for q, _ in t_ops.compare_speed_batch(
        D, bits, rels, 0.97, device="cpu")])
    want = ref.compare(up, dn, rels, entries, g, F64)
    gap = float(np.abs(port - want).max())
    print("compare max abs quality difference: %g" % gap)
    assert want.max() > 0.01 and gap <= Q_ATOL


def test_selection_and_smoothing_are_exact():
    rng = np.random.RandomState(8)
    speeds = 0.9 * 1.0007 ** np.arange(60)
    quals = rng.rand(60)
    quals[10] = quals[11] = 0.99            # a double peak
    quals[30:33] = 0.5                      # a plateau
    order = rng.permutation(60)
    scores = [(float(speeds[i]), float(quals[i])) for i in order]
    port_scores = [t_speed.Score(s, q) for s, q in scores]
    for n in (1, 5, 15, 100):
        got = t_speed._select_n_best_scores(port_scores, n)
        assert [(s.speed, s.quality) for s in got] == \
            ref.select_n_best(scores, n)
    fine = [1.01 * 1.00005 ** p for p in range(-40, 41)]
    fq = np.exp(-((np.arange(81) - 47.3) / 9.0) ** 2) + 0.01 * rng.rand(81)
    got = t_speed._score_smooth_find_best(
        [t_speed.Score(s, q) for s, q in zip(fine, fq)], 1 - 1.00005, 20.0)
    assert got == ref.smooth_find_best(list(zip(fine, fq)), 1 - 1.00005,
                                       20.0)
    assert fine[40] < got < fine[55]


# start hops' sweep qualities around two ties (4e-5 and 1.8e-5 apart,
# under scan.TIE) and the position that only the tied hop's +-256
# refinement reaches: a twin of the peak, which a float32 sweep may take
# as the maximum instead, and a shoulder two hops right of the peak (the
# scan skips the peak's right neighbour), which it may take beside it
TIES = {"twin": ({19: 0.1, 20: 0.2045, 21: 0.20446, 22: 0.1}, 5576),
        "shoulder": ({19: 0.1, 20: 0.178, 21: 0.171937, 22: 0.171919,
                      23: 0.154}, 5832)}


@pytest.mark.parametrize("extra", [0, 8])
@pytest.mark.parametrize("case", sorted(TIES))
def test_reference_search_follows_a_tie_of_local_maxima(monkeypatch, case,
                                                        extra):
    """The reference's search keeps scan.py's candidates and, with
    `extra`, the refinement of a hop that rounding could make a local
    maximum; with `extra` 0 (upstream's own selection) it is scan.py's
    search."""
    from wmbench.reference import keyed, scan

    g = _geom()
    hops, far = TIES[case]
    q = np.zeros(40)
    for h, v in hops.items():
        q[h] = v
    raw = {20 * 256: 0.21, far: 0.23}
    monkeypatch.setattr(scan, "sweep",
                        lambda *a, **k: torch.from_numpy(q.copy()))
    monkeypatch.setattr(scan, "local_mean", lambda v: np.zeros(v.size))
    monkeypatch.setattr(scan, "_quality_at", lambda x, pos, *a: torch.tensor(
        [raw.get(int(p), 0.0) for p in pos], dtype=torch.float64))
    lay = keyed.layout(KEY, g)
    x = torch.zeros((g.frames_per_block * g.frame_size + 6000, 2),
                    dtype=torch.float64)
    upstream = scan.search(x, lay, False, F64, extra)
    got = ref._search(x, lay, False, F64, extra)
    assert (20 * 256, 0.21, "a") in upstream
    assert all(c in got for c in upstream)
    if extra:
        assert (far, 0.23, "a") in got
        assert all(c[0] != far for c in upstream)
    else:
        assert got == upstream


@pytest.fixture(scope="module")
def played():
    """A 30 s excerpt of noise that the reference marked, replayed at
    0.97 and at 1.03 by the reference's resample (upstream's
    test-change-speed)."""
    g = _geom()
    rng = np.random.RandomState(7)
    track = ((rng.rand(36 * 44100, 2) * 2 - 1) * 0.5 * 32767).astype(
        np.int16)
    bits = np.random.default_rng(1).integers(0, 2, g.payload_size)
    marked = mark.mark(track, 44100, KEY, bits, g, F64, "cpu")
    excerpt = marked[3 * 44100:33 * 44100]
    return {s: ref.change_speed(excerpt, s, F64, "cpu") for s in (0.97, 1.03)}


def _short(monkeypatch):
    for k, v in SHORT.items():
        monkeypatch.setattr(t_speed, k.upper(), v)
    sg = ref.SpeedGeom(scans=tuple(ref.Scan(*SHORT[k]) for k in
                                   ("scan1", "scan2", "scan3")),
                       n_best=5, clip_candidates=5, smooth_distance=20.0,
                       accept_quality=0.4, accept_band=(0.9999, 1.0001))
    return sg


def _detected(samples, sg, prec):
    wav = WavData((samples.astype(np.float32) / np.float32(32768))
                  .reshape(-1), 2, 44100, 16)
    found = t_speed.detect_speed([_port_key()], wav, False, "cpu")
    want = ref.detect_speed(samples, KEY, _geom(), sg, prec, "cpu")
    return (found[0][1] if found else None), want


@pytest.mark.parametrize("speed", [0.97, 1.03])
def test_detect_speed_matches_the_reference(played, monkeypatch, speed):
    sg = _short(monkeypatch)
    got, want = _detected(played[speed], sg, F64)
    print("speed %.2f: port %r, reference %r" % (speed, got, want))
    limit = _limit("speed_gap")
    assert got is not None and want.speed is not None
    assert abs(got - want.speed) <= limit
    assert abs(got - speed) / speed < 5e-4 and want.quality > 0.4


def test_bf16_reference_fails_a_tolerance(played, monkeypatch):
    """The reference with bfloat16 stages in the comparisons above: the
    mag matrices leave their tolerance (and the speeds may stay close:
    the argmax is robust to a uniform error)."""
    sg = _short(monkeypatch)
    gaps = {"mag": _mag_gap(BF16) > MAG_ATOL}
    got, want = _detected(played[0.97], sg, BF16)
    gaps["speed"] = got is None or want.speed is None \
        or abs(got - want.speed) > _limit("speed_gap")
    print("bf16 fails: %r (port %r, reference %r)" % (gaps, got, want))
    assert any(gaps.values())

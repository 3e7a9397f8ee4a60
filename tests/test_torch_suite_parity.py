"""The behaviours the JAX package's own suite pins, run on both packages
with the same inputs (seeded numpy; the CLI's test-gen-noise, whose bytes
both packages write alike).

* sync selection (tests/test_sync_selection.py): _select_local_maxima,
  _mask_avg_false_positives and _threshold_n_best_order, exact tie
  plateaus included: indices and order exact;
* ResultSet (tests/test_resultset_and_chunks.py): rating, sort, merge,
  apply_time_offset, best_quality: text and order exact;
* WavChunkLoader on one chunk, on 32 kHz input, truncated, and over two
  chunks: chunk boundaries, counts, offsets and lengths exact, the
  samples exact at 44.1 kHz and within atol 1e-6 resampled;
* the add's frame counts (tests/test_add_fast_path.py):
  _ref_gen_frame_count exact, the "Data Blocks" line of the whole-file,
  streaming and resampled adds equal, and equal to the reference-loop
  simulation;
* the codec (tests/test_codec.py): the impulse response, the short code's
  error detection and its minimum distance: bits and distances exact;
* the limiter and the windows (tests/test_ops.py): the windows and the
  streaming limiter exact, the whole-signal limiter within 1 f32 ulp;
* the resampler (tests/test_ops.py): identity exact, the length protocol
  and the skip counts exact, samples within atol 1e-6;
* the embedder's zero-frames alignment (tests/test_ops.py:185): each
  package's skip-then-run delta against its own full run within atol
  1e-5, as the JAX test holds it, and the port's against the JAX
  package's within atol 1e-5.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from audiowmark_tpu.codec import convcode as jconv
from audiowmark_tpu.codec import shortcode as jshort
from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.models import chunkloader as jchunk
from audiowmark_tpu.models import common as jcommon
from audiowmark_tpu.models import embedder as jemb
from audiowmark_tpu.models import resultset as jrs
from audiowmark_tpu.models import syncfinder as jsync
from audiowmark_tpu.ops import frames as jframes
from audiowmark_tpu.ops import limiter as jlim
from audiowmark_tpu.ops import resample as jres
from audiowmark_tpu.params import Format as JFormat
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu.tables import get_key_tables as j_tables
from audiowmark_tpu_torch.codec import convcode as tconv
from audiowmark_tpu_torch.codec import shortcode as tshort
from audiowmark_tpu_torch.crypto.keys import Key as TKey
from audiowmark_tpu_torch.fixtures import gen_noise
from audiowmark_tpu_torch.io.converters import RawConverter
from audiowmark_tpu_torch.models import chunkloader as tchunk
from audiowmark_tpu_torch.models import common as tcommon
from audiowmark_tpu_torch.models import embedder as temb
from audiowmark_tpu_torch.models import resultset as trs
from audiowmark_tpu_torch.models import syncfinder as tsync
from audiowmark_tpu_torch.ops import frames as tframes
from audiowmark_tpu_torch.ops import limiter as tlim
from audiowmark_tpu_torch.ops import resample as tres
from audiowmark_tpu_torch.params import Format as TFormat
from audiowmark_tpu_torch.params import Params as TParams

torch.set_num_threads(2)
FRAME = TParams.frame_size
MSG = "f0" * 16


def _set(**values):
    for params in (JParams, TParams):
        for name, value in values.items():
            setattr(params, name, value)


@pytest.fixture(autouse=True)
def _reset_params():
    JParams.reset()
    TParams.reset()
    yield
    JParams.reset()
    TParams.reset()


@pytest.fixture(scope="module")
def noise(tmp_path_factory):
    """{(seconds, rate): path} of test-gen-noise files, made on demand."""
    d = tmp_path_factory.mktemp("noise")
    made = {}

    def get(seconds, rate):
        if (seconds, rate) not in made:
            made[seconds, rate] = str(d / ("n%d_%d.wav" % (seconds, rate)))
            gen_noise(TKey(), made[seconds, rate], seconds, rate)
        return made[seconds, rate]
    return get


def _ulps_apart(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return np.abs(np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
                  - np.where(ib < 0, -(ib & 0x7FFFFFFF), ib))


# ------------------------------------------------------------ sync selection

PLATEAUS = [np.zeros(50), np.ones(7),
            np.array([1.0, 1.0, 0.5, 1.0, 1.0, 1.0, 0.2]), np.array([0.3]),
            np.zeros(0), np.array([0.4, 0.4, 0.4, 0.0, 0.4, 0.4])]


def _random_q(seed):
    rng = np.random.RandomState(seed)
    q = rng.rand(500)
    q[rng.rand(500) < 0.3] = 0.0                      # silence plateaus
    return q


@pytest.mark.parametrize("q", [_random_q(s) for s in range(6)] + PLATEAUS)
def test_local_maxima_equals_jax(q):
    got = tsync._select_local_maxima(q)
    want = jsync._select_local_maxima(q)
    assert got.dtype == want.dtype == bool
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_mask_false_positives_equals_jax(seed):
    rng = np.random.RandomState(seed)
    n = 120
    taus = np.sort(rng.choice(np.arange(2000), size=n, replace=False))
    indices = taus * JParams.sync_search_step
    raw = rng.randn(n) * 0.4
    mean = rng.randn(n) * 0.1
    if seed == 5:                                   # exact ties in |raw-mean|
        raw[::3] = 0.3 + mean[::3]
    assert np.array_equal(tsync._mask_avg_false_positives(indices, raw, mean),
                          jsync._mask_avg_false_positives(indices, raw, mean))


@pytest.mark.parametrize("seed", range(6))
def test_threshold_n_best_equals_jax(seed):
    rng = np.random.RandomState(seed)
    aq = rng.rand(40)
    aq[rng.rand(40) < 0.4] = 0.25                     # ties
    for threshold in (0.2625, 0.35, 0.9):
        got = tsync._threshold_n_best_order(aq, threshold)
        assert got.tolist() == \
            jsync._threshold_n_best_order(aq, threshold).tolist()
    short = np.array([0.1, 0.5])
    assert tsync._threshold_n_best_order(short, 0.35).tolist() == \
        jsync._threshold_n_best_order(short, 0.35).tolist()


# ------------------------------------------------------------ ResultSet

def _result_sets(build):
    """build(rs module, Key class, ConvBlockType) on both packages ->
    (port's ResultSet, JAX's, each one's print() text)."""
    out = []
    for rs, key_cls, bt in ((trs, TKey, tconv.ConvBlockType),
                            (jrs, JKey, jconv.ConvBlockType)):
        result = build(rs, key_cls, bt)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            result.print()
        out.append((result, text.getvalue()))
    return out


def _key(key_cls, n):
    k = key_cls()
    k.set_test_key(n)
    return k


def _summary(result):
    return [(p.key.name(), p.time, p.sync_quality, p.sync_block_type.name,
             p.bit_vec, p.decode_error, p.type.name, p.rating, p.speed)
            for p in result.patterns]


def test_resultset_rating_and_sort_equals_jax():
    def build(rs, key_cls, bt):
        r = rs.ResultSet()
        k = _key(key_cls, 1)
        a, b = [1, 0, 1, 0] * 8, [0, 0, 0, 0] * 8
        for t, q, typ, bits, err, kind in (
                (10.0, 1.2, bt.a, a, 0.1, "BLOCK"),
                (62.0, 1.1, bt.b, a, 0.1, "BLOCK"),
                (30.0, 0.3, bt.a, b, 0.4, "BLOCK"),
                (0.0, 1.15, bt.ab, a, 0.05, "ALL"),
                (44.0, 0.9, bt.ab, b, 0.2, "CLIP"),
                (20.0, 1.1, bt.b, a, 0.1, "BLOCK")):
            r.add_pattern(k, t, q, typ, bits, err, rs.PatternType[kind], 1)
        r.sort([k])
        return r
    (port, port_text), (jax, jax_text) = _result_sets(build)
    assert _summary(port) == _summary(jax)
    assert port_text == jax_text and port_text.count("\n") == 7
    assert port.patterns[0].rating == pytest.approx(4.6 + 1.1)
    assert port.best_quality() == jax.best_quality() == 1.2
    assert trs.ResultSet().best_quality() == \
        jrs.ResultSet().best_quality() == -1.0


def test_resultset_merge_and_time_offset_equal_jax():
    def build(rs, key_cls, bt):
        k = _key(key_cls, 2)
        a = rs.ResultSet()
        a.add_pattern(k, 10.0, 1.0, bt.a, [1] * 32, 0.1, rs.PatternType.BLOCK,
                      1)
        b = rs.ResultSet()
        for t, typ in ((10.01, bt.a), (10.01, bt.b), (10.9, bt.a),
                       (10.0, bt.a)):
            b.add_pattern(k, t, 1.0, typ, [1] * 32, 0.1,
                          rs.PatternType.BLOCK, 1)
        a.merge(b)
        a.apply_time_offset(1800.0)
        a.sort([k])
        return a
    (port, port_text), (jax, jax_text) = _result_sets(build)
    assert _summary(port) == _summary(jax)
    assert port_text == jax_text
    assert min(p.time for p in port.patterns) >= 1800.0


# ------------------------------------------------------------ chunk loader

def _chunks(module, path, **kw):
    loader = module.WavChunkLoader(path, **kw)
    out = []
    while not loader.done():
        loader.load_next_chunk()
        if not loader.done():
            w = loader.wav_data()
            out.append((w.samples.copy(), w.n_channels, w.sample_rate,
                        loader.time_offset()))
    return out, loader.length()


@pytest.mark.parametrize("case", ["one_chunk", "32k", "truncate",
                                  "two_chunks"])
def test_chunk_loader_equals_jax(noise, case):
    settings, path = {}, None
    if case == "one_chunk":
        path = noise(10, 44100)
    elif case == "32k":
        path = noise(5, 32000)
    elif case == "truncate":
        path = noise(10, 44100)
        settings = dict(test_truncate=4)
    else:
        # reduced geometry: 2-block overlap ~63 s, chunks of 75 s
        path = noise(80, 44100)
        settings = dict(sync_frames_per_bit=30, frames_per_bit=1,
                        get_chunk_size=1.25)
    _set(**settings)
    got, got_len = _chunks(tchunk, path, device="cpu")
    want, want_len = _chunks(jchunk, path)
    assert [c[1:] for c in got] == [c[1:] for c in want]
    assert [c[0].size for c in got] == [c[0].size for c in want]
    assert got_len == want_len
    for g, w in zip(got, want):
        if case == "32k":
            np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-6)
        else:
            assert np.array_equal(g[0], w[0])
    sizes = [c[0].size // 2 for c in got]
    if case == "two_chunks":
        assert len(got) == 2 and got[1][3] > 0
    else:
        assert len(got) == 1 and got[0][3] == 0.0
        assert sizes == [{"one_chunk": 10 * 44100, "truncate": 4 * 44100}
                         .get(case, sizes[0])]
        if case == "32k":
            assert abs(sizes[0] - 5 * 44100) <= 50
    print("%s: chunks of %s frames" % (case, sizes))


# ------------------------------------------------------------ frame counts

@pytest.mark.parametrize("no_limiter", [True, False])
def test_ref_gen_frame_count_equals_jax(no_limiter):
    for block in (44100, 4410, 1024):
        for n in (0, 1, FRAME - 1, FRAME, 10 * FRAME, 10 * FRAME + 7,
                  44100, 3 * 44100 + 999, 120 * 44100):
            assert temb._ref_gen_frame_count(n, no_limiter, block) == \
                jemb._ref_gen_frame_count(n, no_limiter, block)
    if no_limiter:
        assert temb._ref_gen_frame_count(10 * FRAME, True, 44100) == 11
        assert temb._ref_gen_frame_count(0, True, 44100) == 0


def _data_blocks(module, key_cls, src, dst, stream, **kw):
    saved = module._FAST_PATH_MAX_FRAMES
    if stream:
        module._FAST_PATH_MAX_FRAMES = 0
    buf = io.StringIO()
    try:
        with contextlib.redirect_stderr(buf):
            assert module.add_watermark(key_cls(), src, dst, MSG, **kw) == 0
    finally:
        module._FAST_PATH_MAX_FRAMES = saved
    found = re.findall(r"^Data Blocks:\s+(\d+)$", buf.getvalue(), re.M)
    assert len(found) == 1, buf.getvalue()
    return int(found[0])


@pytest.mark.parametrize("stream", [False, True])
def test_data_blocks_of_120s_equal_jax(noise, tmp_path, stream):
    """tests/test_add_fast_path.py:49 and :87: 120 s prints 2 on the
    whole-file and the streaming path."""
    src = noise(120, 44100)
    got = _data_blocks(temb, TKey, src, str(tmp_path / "t.wav"), stream,
                       device="cpu")
    want = _data_blocks(jemb, JKey, src, str(tmp_path / "j.wav"), stream)
    assert got == want == 2


def test_data_blocks_resampled_equal_jax_and_the_simulation(tmp_path):
    """tests/test_add_fast_path.py:105 on raw 32 kHz input of unknown
    length (its tiles ramp from 16 frames; a known length pads its last
    tile to 4096 frames at 32 kHz, which the JAX package's host resampler
    takes ~40 s for), at the reduced geometry (1038 frames per block): the
    printed count equals the boundaries within the reference-loop
    simulation's generator budget."""
    _set(sync_frames_per_bit=30, frames_per_bit=1)
    seconds, rate = 50, 32000
    rng = np.random.RandomState(32)
    x = ((rng.rand(seconds * rate * 2) * 2 - 1) * 0.9).astype(np.float32)
    src = str(tmp_path / "n32.raw")
    with open(src, "wb") as f:
        f.write(RawConverter(TParams.raw_input_format).to_raw(x))
    for params, fmt in ((TParams, TFormat), (JParams, JFormat)):
        params.input_format = fmt.RAW
        params.raw_input_format.set_sample_rate(rate)
        params.output_format = fmt.RAW
        params.raw_output_format.set_sample_rate(rate)
    got = _data_blocks(temb, TKey, src, str(tmp_path / "t.raw"), False,
                       device="cpu")
    want = _data_blocks(jemb, JKey, src, str(tmp_path / "j.raw"), False)
    block = rate * int(JParams.limiter_block_size_ms) // 1000
    cap = jemb._ref_generator_frame_cap(seconds * rate, rate, False, block)
    fpb = j_tables(JKey()).frames_per_block
    t = np.arange(cap)
    m = int(np.sum((2 * fpb - JParams.frames_pad_start + t + 1) % fpb == 0))
    assert got == want == max(m - 1, 0) >= 1


# ------------------------------------------------------------ codec

def test_encode_impulse_property_equals_jax():
    bits = np.zeros(100, dtype=int)
    bits[0] = 1
    for bt in tconv.ConvBlockType:
        got = tconv.conv_encode(bt, bits)
        assert np.array_equal(got, jconv.conv_encode(
            jconv.ConvBlockType[bt.name], bits))
    out = tconv.conv_encode(tconv.ConvBlockType.ab, bits).reshape(-1, 12)
    for t in range(15):
        for p, poly in enumerate(tconv.AB_GENERATORS):
            assert out[t, p] == ((poly >> t) & 1)


def test_shortcode_error_detection_equals_jax():
    assert tshort.short_code_init(12) == jshort.short_code_init(12) == 56
    bad = np.zeros(56, dtype=np.int32)
    bad[0] = 1
    zeros = np.zeros(56, dtype=np.int32)
    for row, want in ((bad, np.zeros(0, np.int32)),
                      (zeros, np.zeros(12, np.int32))):
        got = tshort.short_decode_blk(row)
        assert np.array_equal(got, jshort.short_decode_blk(row))
        assert np.array_equal(got, want) and got.dtype == np.int32


@pytest.mark.parametrize("k,d", [(12, 22), (16, 21), (20, 20)])
def test_shortcode_min_distance_equals_jax(k, d):
    mat = tshort._MATRICES[k].astype(np.int32)
    assert np.array_equal(mat, jshort._MATRICES[k])
    rng = np.random.RandomState(5)
    weights = []
    for _ in range(200):
        m = rng.randint(0, 2, k)
        if m.any():
            weights.append(int(((m @ mat) & 1).sum()))
            assert weights[-1] == int(
                ((m @ jshort._MATRICES[k].astype(np.int32)) & 1).sum())
    assert min(weights) >= d


# ------------------------------------------------------------ limiter, windows

def test_windows_equal_jax():
    assert np.array_equal(tframes.analysis_window(), jframes.analysis_window())
    assert np.array_equal(tframes.synthesis_window(),
                          jframes.synthesis_window())
    w = tframes.analysis_window()
    assert abs(w.sum() - 2.0) < 1e-4 and w[0] == 0.0


@pytest.mark.parametrize("case", ["passthrough", "peak", "loud", "6ch_48k"])
def test_limiter_apply_equals_jax(case):
    rng = np.random.RandomState(0)
    C, rate = 2, 44100
    if case == "passthrough":
        x = (rng.rand(rate * 3 * C).astype(np.float32) * 2 - 1) * 0.5
    elif case == "peak":
        x = np.zeros(rate * 3 * C, dtype=np.float32)
        x[rate * 2 + 100] = 2.0
    elif case == "loud":
        x = ((rng.rand(rate * 5 * C).astype(np.float32) * 2 - 1) * 1.2)
    else:
        C, rate = 6, 48000
        x = ((rng.rand(rate * 3 * C + 5 * C).astype(np.float32) * 2 - 1)
             * 1.5)
    got = tlim.limiter_apply(x, C, rate, device="cpu")
    want = jlim.limiter_apply(x, C, rate)
    assert got.dtype == want.dtype == np.float32
    ulps = _ulps_apart(got, want)
    print("limiter %s: %d of %d samples 1 ulp apart" % (
        case, np.count_nonzero(ulps), ulps.size))
    assert ulps.max() <= 1
    if case == "passthrough":
        np.testing.assert_allclose(got, x, atol=1e-7)
    else:
        assert np.abs(got).max() <= 0.99 + 1e-6


def test_streaming_limiter_equals_jax():
    rng = np.random.RandomState(1)
    x = ((rng.rand(44100 * 5 * 2).astype(np.float32) * 2 - 1) * 1.2)
    outs = []
    for lim in (tlim.StreamingLimiter(2, 44100),
                jlim.StreamingLimiter(2, 44100)):
        parts = [lim.process(c) for c in np.array_split(x, 13)]
        parts.append(lim.flush())
        outs.append(np.concatenate(parts))
    assert np.array_equal(outs[0], outs[1]) and outs[0].size == x.size
    batch = tlim.limiter_apply(x, 2, 44100, device="cpu")
    np.testing.assert_allclose(outs[0], batch, atol=1e-6)


# ------------------------------------------------------------ resampler

def test_resample_identity_and_length_equal_jax():
    x = np.random.RandomState(2).randn(1000 * 2).astype(np.float32)
    assert np.array_equal(tres.resample_buffer(x, 2, 1.0, device="cpu"), x)
    assert np.array_equal(jres.resample_buffer(x, 2, 1.0), x)
    z = np.zeros(44100 * 2, dtype=np.float32)
    got = tres.resample_buffer(z, 2, 48000 / 44100, device="cpu")
    want = jres.resample_buffer(z, 2, 48000 / 44100)
    assert got.size == want.size == 48000 * 2
    t = np.arange(44100 * 2) / 44100
    tone = np.sin(2 * np.pi * 1000 * t).astype(np.float32)
    got = tres.resample_buffer(tone, 1, 48000 / 44100, device="cpu")
    want = jres.resample_buffer(tone, 1, 48000 / 44100)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ref = np.sin(2 * np.pi * 1000 * np.arange(got.size) / 48000)
    assert np.abs(got[200:-200] - ref[200:-200]).max() < 2e-3


def test_streaming_resampler_skip_periodicity_equals_jax():
    zeros = 32000 * 3 + 2048
    zeros -= zeros % FRAME
    x = np.random.RandomState(4).randn(32000 * 2).astype(np.float32)
    runs = []
    for sr in (tres.StreamingResampler(2, 32000, 44100, "cpu"),
               jres.StreamingResampler(2, 32000, 44100)):
        out = sr.skip(zeros)
        sr.write_frames(x)
        n = sr.can_read_frames()
        runs.append((out, n, np.asarray(sr.read_frames(n))))
    (t_out, t_n, t_y), (j_out, j_n, j_y) = runs
    assert (t_out, t_n) == (j_out, j_n) and t_out % FRAME == 0
    np.testing.assert_allclose(t_y, j_y, rtol=0, atol=1e-6)
    # the JAX test's bound: skip counts the fast-forwarded seconds
    sr = tres.StreamingResampler(2, 32000, 44100, "cpu")
    sr.write_frames(np.zeros(zeros * 2, dtype=np.float32))
    assert t_out <= sr.can_read_frames() + 44100 * 3


def test_streaming_resampler_skip_underflow_equals_jax():
    x = np.random.RandomState(9).randn(48000 * 2).astype(np.float32)
    runs = []
    for sr in (tres.StreamingResampler(2, 48000, 44100, "cpu"),
               jres.StreamingResampler(2, 48000, 44100)):
        out = sr.skip(49024)      # 1 whole second + 1024 residual zeros
        lead = np.asarray(sr.read_frames(sr.can_read_frames()))
        sr.write_frames(x)
        runs.append((out, lead, np.asarray(sr.read_frames(
            sr.can_read_frames()))))
    (t_out, t_lead, t_y), (j_out, j_lead, j_y) = runs
    assert t_out == j_out and t_out % FRAME == 0
    assert t_lead.shape == j_lead.shape and not t_lead.any()
    assert t_y.shape == j_y.shape and t_y.size > 0
    assert np.isfinite(t_y).all()
    np.testing.assert_allclose(t_y, j_y, rtol=0, atol=1e-6)


# ------------------------------------------------------------ embedder

def _zero_frames_alignment(emb_module, common, key, **kw):
    """tests/test_ops.py:185 on one package: (the skip-then-run delta, the
    matching part of the full run, the skip's output count)."""
    bitvec = common.parse_payload("f0" * 16)
    rng = np.random.RandomState(5)
    n_frames_total = 64
    audio = (rng.rand(n_frames_total * FRAME * 2).astype(np.float32) * 2 - 1)
    zero = np.zeros(FRAME * 2, np.float32)
    emb1 = emb_module.StreamingEmbedder(key, 2, 44100, bitvec, **kw)
    full = np.concatenate([emb1.run(audio)] + [emb1.run(zero)
                                               for _ in range(3)])
    skip_frames = 32
    emb2 = emb_module.StreamingEmbedder(key, 2, 44100, bitvec, **kw)
    out = emb2.skip(skip_frames * FRAME)
    mid = np.concatenate([emb2.run(audio[skip_frames * FRAME * 2:])]
                         + [emb2.run(zero) for _ in range(3)])
    ref = full[out * 2: out * 2 + mid.size]
    ofs = 2 * FRAME * 2
    n = (n_frames_total * FRAME - out) * 2 - 2 * FRAME * 2
    return mid[ofs:n], ref[ofs:n], out


def test_embedder_zero_frames_alignment_equals_jax():
    t_mid, t_ref, t_out = _zero_frames_alignment(temb, tcommon, TKey(),
                                                 device="cpu")
    j_mid, j_ref, j_out = _zero_frames_alignment(jemb, jcommon, JKey())
    assert t_out == j_out and t_mid.size == j_mid.size > 0
    np.testing.assert_allclose(t_mid, t_ref, atol=1e-5)
    np.testing.assert_allclose(j_mid, j_ref, atol=1e-5)
    np.testing.assert_allclose(t_mid, j_mid, atol=1e-5)

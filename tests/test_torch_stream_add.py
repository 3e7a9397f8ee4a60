"""The port's streaming add (audiowmark_tpu_torch models/embedder.py tile
path) vs the JAX package's, and vs the port's own whole-file add.

Both packages are forced onto the streaming path by setting their
_FAST_PATH_MAX_FRAMES to 0, unless the input takes it anyway (another
rate, unknown length, --snr, a zero lead-in).  Geometry: 30 sync frames
per bit and 1 frame per bit (1038 frames per block, ~24 s), so 30 s at
44.1 kHz holds two block boundaries and prints "Data Blocks:  1".

A known-length input pads its last tile to 4096 frames (~87 s of audio
at 48 kHz), all of which goes through the resampler pair; the 48 kHz case
reads raw input of unknown length instead, whose tiles ramp from 16
frames, to keep the CPU run short.

* port vs JAX: int16 samples at most 1 LSB apart, on at most 1e-3 of
  them (the count is reported; FFTs, exp and log come from other
  libraries); the "Data Blocks" lines equal; the "SNR" lines within
  1e-3 dB.
* port streaming vs port whole-file (the JAX package's own contract,
  tests/test_add_fast_path.py): bit-exact with the limiter off, at most 1
  LSB on fewer than 1e-3 of the samples with it on, Data Blocks equal.

Each package reads its own Params (the same settings go to both) and gets
its own Key and streams.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from audiowmark_tpu import params as jparams
from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.io import streams as jstreams
from audiowmark_tpu.models import embedder as jemb
from audiowmark_tpu.models.common import parse_payload
from audiowmark_tpu_torch import params as tparams
from audiowmark_tpu_torch.crypto.keys import Key as TKey
from audiowmark_tpu_torch.io import streams as tstreams
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.models import embedder as temb

torch.set_num_threads(2)
MSG = "f0" * 16
FRAME = tparams.Params.frame_size
# per package: (its embedder, its params module, its Key, its streams)
SIDES = ((temb, tparams, TKey, tstreams), (jemb, jparams, JKey, jstreams))


def _set(**values):
    """The same settings on the JAX package's Params and the port's."""
    for _, params, _, _ in SIDES:
        for name, value in values.items():
            setattr(params.Params, name, value)


def _reset():
    for _, params, _, _ in SIDES:
        params.Params.reset()


def _side(module):
    return next(side for side in SIDES if side[0] is module)


@pytest.fixture(autouse=True)
def _params():
    _reset()
    _set(sync_frames_per_bit=30, frames_per_bit=1)
    yield
    _reset()


def _noise(path, seconds, rate, seed=11):
    rng = np.random.RandomState(seed)
    WavData(((rng.rand(int(seconds * rate) * 2) * 2 - 1) * 0.9)
            .astype(np.float32), 2, rate, 16).save(path)


def _add(module, src, dst, stream=True, **kw):
    """add_watermark of `module` (jemb or temb); returns its stderr."""
    saved = module._FAST_PATH_MAX_FRAMES
    if stream:
        module._FAST_PATH_MAX_FRAMES = 0
    buf = io.StringIO()
    try:
        with contextlib.redirect_stderr(buf):
            assert module.add_watermark(_side(module)[2](), src, dst, MSG,
                                        **kw) == 0
    finally:
        module._FAST_PATH_MAX_FRAMES = saved
    return buf.getvalue()


def _line(info, name):
    found = re.findall(r"^%s:\s+(.*)$" % name, info, re.M)
    assert len(found) == 1, info
    return found[0]


def _lsb_apart(a_path, b_path):
    a = WavData.load(a_path).samples.astype(np.float64)
    b = WavData.load(b_path).samples.astype(np.float64)
    assert a.shape == b.shape
    lsb = np.abs(np.round((a - b) * 32768))
    n = int(np.count_nonzero(lsb))
    print("int16 samples 1 LSB apart: %d of %d" % (n, lsb.size))
    return lsb, n


def _assert_close_to_jax(tmp_path, src, **params):
    _set(**params)
    port = _add(temb, src, str(tmp_path / "port.wav"), device="cpu")
    jax = _add(jemb, src, str(tmp_path / "jax.wav"))
    lsb, n = _lsb_apart(str(tmp_path / "port.wav"), str(tmp_path / "jax.wav"))
    assert lsb.max() <= 1 and n <= 1e-3 * lsb.size
    assert _line(port, "Data Blocks") == _line(jax, "Data Blocks")
    return port, jax


@pytest.mark.parametrize("no_limiter", [False, True])
def test_stream_add_44k_matches_jax(tmp_path, no_limiter):
    src = str(tmp_path / "n.wav")
    _noise(src, 30, 44100)
    port, _ = _assert_close_to_jax(tmp_path, src,
                                   test_no_limiter=no_limiter)
    assert _line(port, "Data Blocks") == "1"


def _raw_noise(path, seconds, rate):
    rng = np.random.RandomState(12)
    (rng.randint(-30000, 30000, int(seconds * rate) * 2).astype("<i2")
     .tofile(path))
    for _, params, _, _ in SIDES:
        params.Params.input_format = params.Format.RAW
        params.Params.raw_input_format.set_sample_rate(rate)


def test_stream_add_48k_matches_jax(tmp_path):
    """20 s at 48 kHz through the resampler pair."""
    src = str(tmp_path / "n48.raw")
    _raw_noise(src, 20, 48000)
    port, _ = _assert_close_to_jax(tmp_path, src)
    assert _line(port, "Sample Rate") == "48000"


def test_stream_add_snr_matches_jax(tmp_path):
    src = str(tmp_path / "n.wav")
    _noise(src, 20, 44100)
    port, jax = _assert_close_to_jax(tmp_path, src, snr=True)
    p = float(_line(port, "SNR").split()[0])
    j = float(_line(jax, "SNR").split()[0])
    print("SNR port %.6f dB, JAX %.6f dB" % (p, j))
    assert abs(p - j) <= 1e-3


def test_stream_add_unknown_length_matches_jax(tmp_path):
    """Raw input has no length: the tile ramp 16 -> 512 and the drain."""
    src = str(tmp_path / "n.raw")
    _raw_noise(src, 12, 44100)
    port, jax = _assert_close_to_jax(tmp_path, src)
    assert _line(port, "Time") == _line(jax, "Time") == "unknown"


def _add_stream(module, src, dst, zero_frames, **kw):
    _, params, key, streams = _side(module)
    in_stream = streams.create_input_stream(src)
    out_stream = streams.create_output_stream(
        dst, 2, 44100, 16, params.Encoding.SIGNED, in_stream.n_frames())
    buf = io.StringIO()
    try:
        with contextlib.redirect_stderr(buf):
            assert module.add_stream_watermark(
                key(), in_stream, out_stream, MSG, zero_frames, **kw) == 0
    finally:
        in_stream.close()
    return buf.getvalue()


def test_stream_add_zero_lead_in_matches_jax(tmp_path):
    """A segment that starts 3.5 s into its stream (an HLS segment): the
    lead-in skip keeps the frame phase; only the segment is written."""
    src = str(tmp_path / "seg.wav")
    _noise(src, 10, 44100)
    zero_frames = int(3.5 * 44100)
    port = _add_stream(temb, src, str(tmp_path / "port.wav"), zero_frames,
                       device="cpu")
    jax = _add_stream(jemb, src, str(tmp_path / "jax.wav"), zero_frames)
    assert _line(port, "Data Blocks") == _line(jax, "Data Blocks")
    lsb, n = _lsb_apart(str(tmp_path / "port.wav"), str(tmp_path / "jax.wav"))
    assert lsb.size == 10 * 44100 * 2
    assert lsb.max() <= 1 and n <= 1e-3 * lsb.size


def test_embedder_skip_matches_jax():
    """StreamingEmbedder.skip then run (tests/test_ops.py:185): the port's
    delta equals the JAX package's within atol 1e-5."""
    bitvec = parse_payload(MSG)
    rng = np.random.RandomState(5)
    audio = (rng.rand(40 * FRAME * 2).astype(np.float32) * 2 - 1)
    outs = []
    for emb in (temb.StreamingEmbedder(TKey(), 2, 44100, bitvec, "cpu"),
                jemb.StreamingEmbedder(JKey(), 2, 44100, bitvec)):
        out = emb.skip(16 * FRAME)
        deltas = [emb.run(audio)]
        deltas.append(emb.run(np.zeros(FRAME * 2, np.float32)))
        outs.append((out, emb.frame_number, np.concatenate(deltas)))
    (t_out, t_fn, t_delta), (j_out, j_fn, j_delta) = outs
    assert (t_out, t_fn) == (j_out, j_fn)
    assert t_delta.shape == j_delta.shape
    np.testing.assert_allclose(t_delta, j_delta, rtol=0, atol=1e-5)


@pytest.mark.parametrize("no_limiter", [True, False])
def test_stream_add_matches_port_fast_path(tmp_path, no_limiter):
    tparams.Params.test_no_limiter = no_limiter
    src = str(tmp_path / "n.wav")
    _noise(src, 30, 44100, seed=13)
    fast = _add(temb, src, str(tmp_path / "fast.wav"), stream=False,
                device="cpu")
    slow = _add(temb, src, str(tmp_path / "slow.wav"), device="cpu")
    assert _line(fast, "Data Blocks") == _line(slow, "Data Blocks") == "1"
    lsb, n = _lsb_apart(str(tmp_path / "fast.wav"), str(tmp_path / "slow.wav"))
    if no_limiter:
        assert n == 0
    else:
        assert lsb.max() <= 1 and n < 1e-3 * lsb.size

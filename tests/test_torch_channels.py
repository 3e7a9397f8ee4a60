"""The port at channel counts and rates other than stereo 44.1 kHz, against
the JAX package: mono at 44.1 kHz here, 6 channels at 48 kHz and stereo at
22.05 and at 96 kHz in tests/test_torch_channels_{6ch,22k,96k}.py (a file
each, so that each runs well inside its worker's share of the tier-1 run),
and the fleet API with one channel.

Reduced geometry (30 sync frames per bit, 1 frame per bit: 1038 frames per
block, ~24 s at 44.1 kHz), RandomState(7) noise at half scale written as
16-bit WAV and as raw PCM.  For each case, with the limiter off:

* the add of the raw PCM (unknown length: the streaming add, its tiles
  ramping 16 -> 512 frames, through the resampler pair at other rates) by
  each package: int16 samples at most 1 LSB apart on at most 1e-3 of them
  (the count is printed);
* cmp of the JAX-marked file by each package: the same stdout, byte for
  byte, and the same exit code; the message is found;
* the port's unknown-length add equals its known-length add of the WAV
  (the whole-file add at 44.1 kHz, 4096-frame tiles otherwise), 0 samples
  apart.

Fleet: watermark_batch and detect_batch on 2 mono streams at the mini
geometry of tests/test_torch_batch.py (short-12 payload, 10 sync frames
per bit, T = 1200): the marked audio within atol 1e-5 of the JAX
package's, detect_batch slot for slot (discrete outputs exact, qualities
rtol 2e-4 atol 2e-5), the codeword in each stream's best eligible slot.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from audiowmark_tpu import params as jparams
from audiowmark_tpu import tables as j_tables
from audiowmark_tpu.codec.shortcode import short_encode_blk
from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.models import embedder as jemb
from audiowmark_tpu.models import getter as jget
from audiowmark_tpu.models.common import parse_payload
from audiowmark_tpu.parallel import batch as j_batch
from audiowmark_tpu.parallel.mesh import make_mesh as j_make_mesh
from audiowmark_tpu_torch import params as tparams
from audiowmark_tpu_torch import tables as t_tables
from audiowmark_tpu_torch.crypto.keys import Key as TKey
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.models import embedder as temb
from audiowmark_tpu_torch.models import getter as tget
from audiowmark_tpu_torch.ops.frames import FRAME
from audiowmark_tpu_torch.parallel import batch as t_batch

torch.set_num_threads(2)
MSG = "0123456789abcdef0011223344556677"
REDUCED = dict(sync_frames_per_bit=30, frames_per_bit=1)
# (channels, rate, seconds): long enough for a whole block after the
# add's lead-in, so that cmp decodes blocks (a shorter file leaves only the
# clip decoder, whose padded windows take longer on the CPU)
CASES = [(1, 44100, 30)]
# per package: (its params module, its embedder, its getter, its Key)
SIDES = {"port": (tparams, temb, tget, TKey),
         "jax": (jparams, jemb, jget, JKey)}


def _set(raw=None, **values):
    """Both packages' Params reset, then `values`; raw=(channels, rate):
    raw PCM input (16-bit signed little-endian)."""
    for params, _, _, _ in SIDES.values():
        params.Params.reset()
        for name, value in values.items():
            setattr(params.Params, name, value)
        if raw:
            params.Params.input_format = params.Format.RAW
            params.Params.raw_input_format.set_channels(raw[0])
            params.Params.raw_input_format.set_sample_rate(raw[1])


@pytest.fixture(autouse=True)
def _reset_params():
    _set()
    yield
    _set()


def _add(side, src, dst):
    _, emb, _, key = SIDES[side]
    kw = dict(device="cpu") if side == "port" else {}
    with contextlib.redirect_stderr(io.StringIO()):
        assert emb.add_watermark(key(), src, dst, MSG, **kw) == 0


def _cmp(side, path):
    _, _, get, key = SIDES[side]
    kw = dict(device="cpu") if side == "port" else {}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = get.get_watermark([key()], path, MSG, **kw)
    return rc, out.getvalue()


def _lsb_apart(a_path, b_path):
    a = WavData.load(a_path).samples.astype(np.float64)
    b = WavData.load(b_path).samples.astype(np.float64)
    assert a.shape == b.shape
    return np.abs(np.round((a - b) * 32768))


def run_case(d, channels, rate, seconds):
    """Every add and cmp of one case in directory d; returns their
    results."""
    rng = np.random.RandomState(7)
    x = ((rng.rand(int(seconds * rate) * channels) * 2 - 1) * 0.5) \
        .astype(np.float32)
    wav, raw = str(d / "in.wav"), str(d / "in.raw")
    WavData(x, channels, rate, 16).save(wav)
    (np.round(WavData.load(wav).samples * 32768).astype("<i2")).tofile(raw)
    out = {"samples": x.size}
    for side in SIDES:
        _set(raw=(channels, rate), test_no_limiter=True, **REDUCED)
        out[side + "_marked"] = str(d / (side + ".wav"))
        _add(side, raw, out[side + "_marked"])
    _set(test_no_limiter=True, **REDUCED)
    out["port_known"] = str(d / "port_known.wav")
    _add("port", wav, out["port_known"])
    for side in SIDES:
        _set(**REDUCED)
        out[side + "_cmp"] = _cmp(side, out["jax_marked"])
    return out


@pytest.fixture(scope="module", params=CASES,
                ids=["%dch_%d_%ds" % c for c in CASES])
def case(request, tmp_path_factory):
    return run_case(tmp_path_factory.mktemp("case"), *request.param)


def check_add_within_one_lsb_of_jax(case):
    lsb = _lsb_apart(case["port_marked"], case["jax_marked"])
    n = int(np.count_nonzero(lsb))
    print("int16 samples 1 LSB apart: %d of %d" % (n, lsb.size))
    assert lsb.size == case["samples"]
    assert lsb.max() <= 1 and n <= 1e-3 * lsb.size


def check_cmp_prints_what_jax_prints(case):
    (p_rc, p_out), (j_rc, j_out) = case["port_cmp"], case["jax_cmp"]
    assert p_out == j_out and p_rc == j_rc == 0
    counts = [int(line.split()[1]) for line in p_out.splitlines()
              if line.startswith("match_count")]
    assert counts and counts[0] >= 1, p_out


def check_unknown_length_add_equals_known_length_add(case):
    lsb = _lsb_apart(case["port_marked"], case["port_known"])
    assert lsb.size == case["samples"] and not lsb.any()


def test_add_within_one_lsb_of_jax(case):
    check_add_within_one_lsb_of_jax(case)


def test_cmp_prints_what_jax_prints(case):
    check_cmp_prints_what_jax_prints(case)


def test_unknown_length_add_equals_known_length_add(case):
    check_unknown_length_add_equals_known_length_add(case)


# ------------------------------------------------------------ fleet, C = 1

B, T, PAYLOAD = 2, 1200, "abc"


@pytest.fixture
def mini():
    _set(payload_short=True, payload_size=12, sync_frames_per_bit=10)
    j_tables.clear_cache()
    t_tables.clear_cache()
    yield
    _set()
    j_tables.clear_cache()
    t_tables.clear_cache()


def test_fleet_api_on_mono_streams_equals_jax(mini):
    rng = np.random.RandomState(1)
    audio = ((rng.rand(B, T * FRAME, 1).astype(np.float32) - 0.5) * 0.6)
    want = j_batch.watermark_batch(JKey(), audio, PAYLOAD,
                                   mesh=j_make_mesh(2, dp=2))
    got = t_batch.watermark_batch(TKey(), audio, PAYLOAD, device="cpu")
    assert got.shape == want.shape == audio.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    want = j_batch.detect_batch(JKey(), got, mesh=j_make_mesh(2), top_k=4)
    found = t_batch.detect_batch(TKey(), got, top_k=4, device="cpu")
    assert set(found) == set(want)
    for name in ("positions", "block_is_a", "bits", "eligible"):
        assert np.array_equal(found[name], want[name]), name
    np.testing.assert_allclose(found["qualities"], want["qualities"],
                               rtol=2e-4, atol=2e-5)
    codeword = list(short_encode_blk(parse_payload(PAYLOAD)))
    for b in range(B):
        best = int(np.argmax(np.where(found["eligible"][b],
                                      found["qualities"][b], -np.inf)))
        assert found["bits"][b][best].tolist() == codeword, b

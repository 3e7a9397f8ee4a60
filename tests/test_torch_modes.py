"""The command line's modes on the port vs the JAX package, end to end.

One case per mode of the JAX side's tests: --linear, --hard and
--frames-per-bit 4 (tests/test_modes.py); two keys in one get, a double
watermark and a wrong key (tests/test_keys_e2e.py); cut-start
(tests/test_end_to_end.py::test_sync_cut,
tests/test_clip_and_rate.py::test_clip_decoder_after_cut) and the get's
test_cut; test_truncate; --short 12/16/20
(tests/test_short_payload_e2e.py); 24-bit input
(tests/test_pipes_and_formats.py::test_24bit_wav_roundtrip).

Geometry and fixture of tests/test_torch_slice.py: 30 sync frames per bit
and 1 frame per bit (1038 frames per block), 80 s of RandomState(7) stereo
noise (blocks A, B, A).  Each case checks that

(a) the port's marked file and the JAX package's are at most 1 LSB apart,
    on at most 1e-3 of the samples at 16 bits; at 24 bits an LSB is 2^-8
    of a 16-bit one, within the two packages' float32 rounding, and up to
    5e-2 of the samples may differ by it (~2.4 % do); the count printed;
(b) the port's `get`/`cmp` on the JAX-marked file prints byte for byte what
    the JAX package prints, with the same exit code;
(c) the port's `get`/`cmp` on its own marked file gives the same match
    counts.

Marked files are made once per module and shared between cases.  Each
package reads its own settings and gets its own Key.
"""

import numpy as np
import pytest
import torch

from audiowmark_tpu import cli as j_cli
from audiowmark_tpu.codec import convcode as j_conv
from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.models.embedder import add_watermark as j_add
from audiowmark_tpu.models import decoder as j_dec
from audiowmark_tpu.models.getter import get_watermark as j_get
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch import add_watermark as t_add
from audiowmark_tpu_torch import cli as t_cli
from audiowmark_tpu_torch import get_watermark as t_get
from audiowmark_tpu_torch.codec import convcode as t_conv
from audiowmark_tpu_torch.crypto.keys import Key as TKey
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.params import Params as TParams

torch.set_num_threads(2)
MSG = "f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0"
MSG2 = "0123456789abcdef0123456789abcdef"
SECONDS = 80
# cut-start of 2 s: the blocks move by a fraction of a frame, as with
# tests/test_end_to_end.py::test_sync_cut's 882300 (which chip_smoke.py's
# phase 20 cuts), and the file keeps the 80 s file's frame bucket, so the
# JAX side compiles no new search
CUT_FRAMES = 88200
SHORT = {12: "abc", 16: "abcd", 20: "abcde"}

# marked files: name -> (input, [(test key or None, message, settings)])
ADDS = {
    "default": ("noise", [(None, MSG, {})]),
    "linear": ("noise", [(None, MSG, dict(mix=False))]),
    "fpb4": ("noise", [(None, MSG, dict(frames_per_bit=4))]),
    "24bit": ("noise24", [(None, MSG, {})]),
    "double": ("noise", [(None, MSG, {}), (9, MSG2, {})]),
}
for _bits, _msg in SHORT.items():
    ADDS["short%d" % _bits] = ("noise", [(None, _msg, dict(
        payload_size=_bits, payload_short=True))])

# cases: name -> (marked file, cut-start frames, [(test keys, message,
# settings)] of the gets; a key None is the default key, message "" a get)
CASES = {
    "linear": ("linear", 0, [([None], MSG, dict(mix=False))]),
    "hard": ("default", 0, [([None], MSG, dict(hard=True))]),
    "frames_per_bit_4": ("fpb4", 0, [([None], MSG,
                                      dict(frames_per_bit=4))]),
    "two_keys_one_get": ("double", 0, [([None, 9], "", {})]),
    "double_watermark": ("double", 0, [([None], MSG, {}),
                                       ([9], MSG2, {})]),
    "wrong_key": ("default", 0, [([5], MSG, {})]),
    "cut_start": ("default", CUT_FRAMES, [([None], MSG, {})]),
    "test_cut": ("default", 0, [([None], MSG, dict(test_cut=30000))]),
    "test_truncate": ("default", 0, [([None], MSG,
                                      dict(test_truncate=20))]),
    "24bit": ("24bit", 0, [([None], MSG, {})]),
}
for _bits, _msg in SHORT.items():
    CASES["short_%d" % _bits] = ("short%d" % _bits, 0, [([None], _msg, dict(
        payload_size=_bits, payload_short=True))])


def _set(**values):
    """The reduced geometry and `values` on both packages' Params."""
    for params in (JParams, TParams):
        params.reset()
        params.sync_frames_per_bit = 30
        params.frames_per_bit = 1
        for name, value in values.items():
            setattr(params, name, value)


def _key(cls, test_key):
    key = cls()
    if test_key is not None:
        key.set_test_key(test_key)
    return key


@pytest.fixture(scope="module")
def marked(tmp_path_factory):
    """marked(name) -> {"jax": path, "port": path}, made at first use."""
    d = tmp_path_factory.mktemp("modes")
    rng = np.random.RandomState(7)
    x = ((rng.rand(SECONDS * 44100 * 2) * 2 - 1) * 0.5).astype(np.float32)
    inputs = {"noise": str(d / "noise.wav"), "noise24": str(d / "noise24.wav")}
    WavData(x, 2, 44100, 16).save(inputs["noise"])
    WavData(x, 2, 44100, 24).save(inputs["noise24"])
    made = {}

    def make(name):
        if name not in made:
            src, adds = ADDS[name]
            paths = {}
            for side, add, key_cls, kw in (("jax", j_add, JKey, {}),
                                           ("port", t_add, TKey,
                                            dict(device="cpu"))):
                path = inputs[src]
                for i, (test_key, msg, settings) in enumerate(adds):
                    out = str(d / ("%s_%s_%d.wav" % (name, side, i)))
                    _set(**settings)
                    assert add(_key(key_cls, test_key), path, out, msg,
                               **kw) == 0
                    path = out
                paths[side] = path
            _set()
            made[name] = paths
        return made[name]

    yield make
    JParams.reset()
    TParams.reset()


def _lsb_apart(a_path, b_path):
    a, b = WavData.load(a_path), WavData.load(b_path)
    assert a.bit_depth == b.bit_depth and a.samples.shape == b.samples.shape
    lsb = np.abs(np.round((a.samples.astype(np.float64) - b.samples)
                          * 2.0 ** (a.bit_depth - 1)))
    return float(lsb.max()), int(np.count_nonzero(lsb)), int(lsb.size)


def _cut(path, frames, tmp_path, side):
    """cut-start of `frames` through each package's command line: the two
    commands write the same bytes."""
    if not frames:
        return path
    outs = []
    for name, cli, params in (("jax", j_cli, JParams), ("port", t_cli,
                                                        TParams)):
        outs.append(str(tmp_path / ("cut_%s_%s.wav" % (side, name))))
        params.reset()
        assert cli.main(["cut-start", path, outs[-1], str(frames)]) == 0
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert a.read() == b.read()
    return outs[1]


def _gets(get, key_cls, path, gets, capsys, **kw):
    """[(rc, stdout)] of each get of the case on `path`."""
    out = []
    for test_keys, msg, settings in gets:
        _set(**settings)
        capsys.readouterr()
        rc = get([_key(key_cls, k) for k in test_keys], path, msg, **kw)
        out.append((rc, capsys.readouterr().out))
    _set()
    return out


def _counts(reports):
    return [[line for line in out.splitlines()
             if line.startswith("match_count") or line.startswith("key ")]
            for _, out in reports]


@pytest.mark.parametrize("mode", sorted(CASES))
def test_mode_matches_jax(mode, marked, tmp_path, capsys):
    name, cut, gets = CASES[mode]
    files = marked(name)

    # (a) the two adds
    worst, n_apart, n = _lsb_apart(files["port"], files["jax"])
    with capsys.disabled():
        print("\n%s: %d of %d samples 1 LSB apart" % (mode, n_apart, n))
    share = 5e-2 if ADDS[name][0] == "noise24" else 1e-3
    assert worst <= 1 and n_apart <= share * n

    # (b) the port's report on the JAX-marked file is the JAX package's
    jax_file = _cut(files["jax"], cut, tmp_path, "jax")
    want = _gets(j_get, JKey, jax_file, gets, capsys)
    got = _gets(t_get, TKey, jax_file, gets, capsys, device="cpu")
    assert got == want

    # (c) the port on its own marked file: the same match counts
    own = _gets(t_get, TKey, _cut(files["port"], cut, tmp_path, "port"),
                gets, capsys, device="cpu")
    assert [rc for rc, _ in own] == [rc for rc, _ in want]
    assert _counts(own) == _counts(want)

    # what the JAX side's tests hold of each mode
    text = "".join(out for _, out in want)
    if mode == "wrong_key":
        assert "match_count 0 " in text
    elif mode == "two_keys_one_get":
        assert "key test-key-9" in text and MSG in text and MSG2 in text
    elif mode.startswith("short_"):
        payload = gets[0][1]
        lines = [line for line in text.splitlines()
                 if line.startswith("pattern")]
        assert lines and all(payload in line for line in lines)
    else:
        assert "match_count 0 " not in text and "match_count" in text


def test_cut_start_44300_differs_only_in_the_bits_of_noise(marked, tmp_path,
                                                            capsys,
                                                            monkeypatch):
    """cut-start of 44300 frames (the cut of
    tests/test_clip_and_rate.py::test_clip_decoder_after_cut): at most one
    candidate below the sync threshold decodes to other bits than with the
    JAX package.  Its soft bits, ~2e-6 from the JAX package's (another
    FFT), sit on a near-tie of the trellis.  Every other field of every
    line is equal, and the port decodes the JAX package's soft bits of
    every candidate to the JAX package's bits (errors within rtol 1e-6, as
    tests/test_torch_viterbi.py holds them): the decode is exact, its input
    is not."""
    path = _cut(marked("default")["jax"], 44300, tmp_path, "jax")
    jobs = []
    add = j_dec._DecodeJobs.add

    def recording(self, block_type, soft_bits, emit):
        jobs.append((block_type, np.array(soft_bits, np.float32)))
        return add(self, block_type, soft_bits, emit)

    monkeypatch.setattr(j_dec._DecodeJobs, "add", recording)
    gets = [([None], MSG, {})]
    (j_rc, want), = _gets(j_get, JKey, path, gets, capsys)
    (t_rc, got), = _gets(t_get, TKey, path, gets, capsys, device="cpu")
    assert j_rc == t_rc == 0
    assert len(got.splitlines()) == len(want.splitlines())
    differ = [(g.split(), w.split()) for g, w in
              zip(got.splitlines(), want.splitlines()) if g != w]
    with capsys.disabled():
        print("\ncut-start 44300: lines that differ: %s" % differ)
    assert len(differ) <= 1
    for g, w in differ:
        assert g[0] == w[0] == "pattern" and g[1] == w[1] and g[3:] == w[3:]
        assert float(w[3]) < JParams.sync_threshold2
    assert jobs
    for block_type, soft_bits in jobs:
        want_bits, want_err = j_conv.conv_decode_soft(block_type, soft_bits,
                                                      return_error=True)
        bits, err = t_conv.conv_decode_soft(
            t_conv.ConvBlockType(block_type.value), soft_bits,
            return_error=True, device="cpu")
        assert np.array_equal(bits, want_bits)
        np.testing.assert_allclose(err, want_err, rtol=1e-6)

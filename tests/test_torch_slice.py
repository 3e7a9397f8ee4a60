"""The port's whole slice, add -> get/cmp, vs the JAX package.

Geometry: 30 sync frames per bit and 1 frame per bit give 858 + 180 =
1038 frames per block (~24 s), so 80 s of seeded stereo noise holds blocks
A, B, A and `cmp` finds 5 matches (A, B, A, AB, all) with either package.

* add: the port's marked file vs the JAX package's, int16 samples at most
  1 LSB apart, with the count of such samples small and reported.
* get: the port's report on the JAX-marked file vs the JAX report on the
  same file: the same patterns (time, bits, type) and match counts, with
  qualities and errors within 0.002 (their printed 3 decimals).
* cross-decode: each package decodes the other's marked file with the same
  match count.
* 48 kHz: the port marks 32 s of raw 48 kHz input (the resampler pair of
  the streaming add), and its report on that file equals the JAX
  package's (a cross-decode through the resampling chunk loader).  Raw
  input has no length, so the streaming tiles ramp up from 16 frames
  instead of padding to 4096 (~87 s of audio at 48 kHz to resample).
* a get over 2 chunks (Params.get_chunk_size 1.25 min, above the 2-block
  overlap of ~63 s) and a --test-no-sync get: reports equal the JAX ones.
* the port imports and runs with jax blocked from import, a resampled
  streaming add included.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audiowmark_tpu.crypto.keys import Key
from audiowmark_tpu.io.wavdata import WavData
from audiowmark_tpu.models.embedder import add_watermark as j_add
from audiowmark_tpu.models.getter import get_watermark as j_get
from audiowmark_tpu.params import Format, Params
from audiowmark_tpu_torch import add_watermark as t_add
from audiowmark_tpu_torch import get_watermark as t_get

torch.set_num_threads(2)
MSG = "f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0"
SECONDS = 80
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _geometry():
    Params.sync_frames_per_bit = 30
    Params.frames_per_bit = 1


@pytest.fixture(autouse=True)
def geometry():
    _geometry()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    _geometry()
    d = tmp_path_factory.mktemp("slice")
    rng = np.random.RandomState(7)
    n = SECONDS * 44100 * 2
    paths = {k: str(d / (k + ".wav")) for k in ("noise", "jax", "port")}
    WavData(((rng.rand(n) * 2 - 1) * 0.5).astype(np.float32), 2, 44100,
            16).save(paths["noise"])
    assert j_add(Key(), paths["noise"], paths["jax"], MSG) == 0
    assert t_add(Key(), paths["noise"], paths["port"], MSG,
                 device="cpu") == 0
    Params.reset()
    return paths


def _report(get, path, capsys, **kw):
    capsys.readouterr()
    rc = get([Key()], path, MSG, **kw)
    return rc, capsys.readouterr().out


def _patterns(out):
    """(exact fields, (quality, error)) per pattern line, and the
    match_count line."""
    exact, floats = [], []
    for line in out.splitlines():
        f = line.split()
        if f and f[0] == "pattern":
            # "pattern  0:05 <bits> q err A"  or  "pattern   all <bits> q err"
            exact.append((f[1], f[2]) + tuple(f[5:]))
            floats.append((float(f[3]), float(f[4])))
    counts = [line for line in out.splitlines()
              if line.startswith("match_count")]
    return exact, np.array(floats), counts


def test_add_matches_jax(files):
    a = WavData.load(files["port"]).samples
    b = WavData.load(files["jax"]).samples
    assert a.shape == b.shape
    lsb = np.abs(np.round((a.astype(np.float64) - b) * 32768))
    n_lsb = int(np.count_nonzero(lsb))
    print("int16 samples 1 LSB apart: %d of %d" % (n_lsb, lsb.size))
    assert lsb.max() <= 1
    assert n_lsb <= 1e-3 * lsb.size
    noise = WavData.load(files["noise"]).samples
    assert not np.array_equal(a, noise)


def test_get_report_matches_jax(files, capsys):
    j_rc, j_out = _report(j_get, files["jax"], capsys)
    t_rc, t_out = _report(t_get, files["jax"], capsys, device="cpu")
    assert j_rc == t_rc == 0
    je, jf, jc = _patterns(j_out)
    te, tf, tc = _patterns(t_out)
    assert te == je
    np.testing.assert_allclose(tf, jf, rtol=0, atol=0.002)
    assert tc == jc and tc[0].startswith("match_count 5 ")


def test_cross_decode(files, capsys):
    _, jax_on_port = _report(j_get, files["port"], capsys)
    _, port_on_jax = _report(t_get, files["jax"], capsys, device="cpu")
    _, port_on_port = _report(t_get, files["port"], capsys, device="cpu")
    counts = [_patterns(o)[2][0].split()[1]
              for o in (jax_on_port, port_on_jax, port_on_port)]
    assert counts == ["5", "5", "5"]


def test_short_payload_cross_decode(files, capsys, tmp_path):
    """A 16-bit short payload (the exhaustive codeword match after the
    Viterbi): the port marks, both packages decode with equal match
    counts.  61-bit codewords give 456 + 180 = 636 frames per block, so the
    80 s file holds 5 blocks."""
    Params.payload_short = True
    Params.payload_size = 16
    wm = str(tmp_path / "short.wav")
    assert t_add(Key(), files["noise"], wm, "abcd", device="cpu") == 0
    capsys.readouterr()
    assert j_get([Key()], wm, "abcd") == 0
    jax_out = capsys.readouterr().out
    assert t_get([Key()], wm, "abcd", device="cpu") == 0
    port_out = capsys.readouterr().out
    je, _, jc = _patterns(jax_out)
    te, _, tc = _patterns(port_out)
    assert te == je
    assert tc == jc and int(tc[0].split()[1]) >= 5


def _assert_same_report(j_out, t_out):
    je, jf, jc = _patterns(j_out)
    te, tf, tc = _patterns(t_out)
    assert te == je
    np.testing.assert_allclose(tf, jf, rtol=0, atol=0.002)
    assert tc == jc


def test_unported_paths_raise(files):
    """Speed detection is the one path of add and get still unported."""
    for name, value in (("detect_speed", True), ("detect_speed_patient", True),
                        ("try_speed", 1.01)):
        Params.reset()
        setattr(Params, name, value)
        with pytest.raises(NotImplementedError, match="speed detection"):
            t_get([Key()], files["port"], MSG, device="cpu")


def test_48k_add_get_matches_jax(tmp_path, capsys):
    """The port marks 32 s of raw 48 kHz input; the JAX package's report
    on that file (a cross-decode) and the port's are equal."""
    raw = str(tmp_path / "n48.raw")
    marked = str(tmp_path / "wm48.wav")
    rng = np.random.RandomState(48)
    (rng.randint(-16000, 16000, 32 * 48000 * 2).astype("<i2").tofile(raw))
    Params.input_format = Format.RAW
    Params.raw_input_format.set_sample_rate(48000)
    assert t_add(Key(), raw, marked, MSG, device="cpu") == 0
    Params.reset()
    _geometry()
    assert WavData.load(marked).sample_rate == 48000
    j_rc, j_out = _report(j_get, marked, capsys)
    t_rc, t_out = _report(t_get, marked, capsys, device="cpu")
    assert j_rc == t_rc == 0
    _assert_same_report(j_out, t_out)


@pytest.mark.parametrize("name,value", [("get_chunk_size", 1.25),
                                        ("test_no_sync", True)])
def test_get_variant_matches_jax(files, capsys, name, value):
    """Two chunks (0-75 s and 12.3-80 s), or the fixed block positions of
    --test-no-sync (whose scores carry no raws: the decoder extracts)."""
    setattr(Params, name, value)
    j_rc, j_out = _report(j_get, files["jax"], capsys)
    t_rc, t_out = _report(t_get, files["jax"], capsys, device="cpu")
    assert j_rc == t_rc == 0
    _assert_same_report(j_out, t_out)


_NO_JAX = r"""
import sys
class _BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked")
sys.meta_path.insert(0, _BlockJax())
import numpy as np
import torch
torch.set_num_threads(2)
from audiowmark_tpu.crypto.keys import Key
from audiowmark_tpu.io.wavdata import WavData
from audiowmark_tpu.params import Params
import audiowmark_tpu_torch as port
Params.sync_frames_per_bit = 30
Params.frames_per_bit = 1
d = sys.argv[1]
rng = np.random.RandomState(1)
WavData(((rng.rand(30 * 44100 * 2) * 2 - 1) * 0.5).astype(np.float32), 2,
        44100, 16).save(d + "/n.wav")
assert port.add_watermark(Key(), d + "/n.wav", d + "/wm.wav", "ab" * 16,
                          device="cpu") == 0
assert port.get_watermark([Key()], d + "/wm.wav", "ab" * 16,
                          device="cpu") == 0
from audiowmark_tpu.params import Format
from audiowmark_tpu_torch.models import chunkloader, embedder, syncfinder
from audiowmark_tpu_torch.ops import resample, sync
from audiowmark_tpu_torch import profile_cells
(rng.randint(-16000, 16000, 2 * 48000 * 2).astype("<i2")
 .tofile(d + "/n48.raw"))
Params.input_format = Format.RAW
Params.raw_input_format.set_sample_rate(48000)
assert port.add_watermark(Key(), d + "/n48.raw", d + "/wm48.wav", "ab" * 16,
                          device="cpu") == 0
Params.input_format = Format.AUTO
assert WavData.load(d + "/wm48.wav").n_frames == 2 * 48000
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
print("NO_JAX_OK")
"""


def test_port_runs_without_jax(tmp_path):
    """A tiny add + cmp in a fresh interpreter where importing jax fails
    (30 s: one block, found by the block and the clip decoder; cmp
    returns 0 only when it matches), then the modules of the resampler,
    the streaming add, the staged search and the profile script, and a
    2 s streaming add of raw 48 kHz input."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path)],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert "\nmatch_count " in proc.stdout, proc.stdout


def test_profile_device_time_is_the_union_of_device_intervals():
    """profile_cells counts overlapping device intervals once, ignores
    host events, and sums each device op's own time by name."""
    from types import SimpleNamespace

    from audiowmark_tpu_torch.profile_cells import _busy_intervals

    def ev(name, start, end, dev=torch.autograd.DeviceType.CUDA):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    events = [ev("k", 0, 1000), ev("copy", 500, 1500), ev("k", 3000, 3500),
              ev("host", 0, 9000, torch.autograd.DeviceType.CPU)]
    union_ms, per_name = _busy_intervals(events)
    assert union_ms == 2.0
    assert per_name == {"k": 1.5, "copy": 1.0}
    assert _busy_intervals([]) == (0.0, {})

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
* the port imports and runs with jax blocked from import.
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
from audiowmark_tpu.params import Params
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


def test_unported_paths_raise(files, tmp_path):
    Params.test_no_sync = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_get([Key()], files["port"], MSG, device="cpu")
    Params.test_no_sync = False
    WavData(np.zeros(48000 * 2, np.float32), 2, 48000, 16).save(
        str(tmp_path / "48k.wav"))
    with pytest.raises(NotImplementedError, match="resampl"):
        t_add(Key(), str(tmp_path / "48k.wav"), str(tmp_path / "o.wav"),
              MSG, device="cpu")


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
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]
print("NO_JAX_OK")
"""


def test_port_runs_without_jax(tmp_path):
    """A tiny add + cmp in a fresh interpreter where importing jax fails
    (30 s: one block, found by the block and the clip decoder); cmp
    returns 0 only when it matches."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, str(tmp_path)],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert "\nmatch_count " in proc.stdout, proc.stdout

"""The port's time-to-first-byte harness (audiowmark_tpu_torch/ttfb.py,
the port's copy of tools/ttfb_test.py) on the CPU
(AUDIOWMARK_TORCH_DEVICE=cpu), on 5 s of 16-bit stereo noise:

* `python -m audiowmark_tpu_torch.ttfb` of the WAV (known length) and of
  the same samples as raw PCM (`--input-format raw --raw-rate 44100`,
  unknown length) prints the tool's two lines, and the bytes it counts are
  those of the same add written to a file;
* against the JAX tool run on the JAX package (AUDIOWMARK_JAX_PLATFORM=cpu)
  on the same WAV: the same byte count, and the marked stream that
  ttfb.measure passes on within 1 LSB of the JAX package's add of the file
  (count printed).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from audiowmark_tpu_torch import ttfb
from audiowmark_tpu_torch.fixtures import raw_format
from audiowmark_tpu_torch.io.converters import RawConverter
from audiowmark_tpu_torch.io.wavdata import WavData

torch.set_num_threads(2)
MSG = "0123456789abcdef0011223344556677"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, AUDIOWMARK_TORCH_DEVICE="cpu",
           AUDIOWMARK_JAX_PLATFORM="cpu", PYTHONPATH=REPO)
LINES = re.compile(r"ttfb (\d+\.\d{3}) s\n"
                   r"total (\d+\.\d{3}) s, (\d+) bytes \((\d+\.\d) MB/s\)\n")


@pytest.fixture(scope="module")
def noise(tmp_path_factory):
    """(5 s of noise as WAV, the same samples as raw s16le)."""
    d = tmp_path_factory.mktemp("ttfb")
    wav, raw = str(d / "n.wav"), str(d / "n.raw")
    x = np.random.RandomState(5).uniform(-0.8, 0.8, 5 * 44100 * 2)
    WavData(x.astype(np.float32), 2, 44100, 16).save(wav)
    with open(raw, "wb") as f:
        f.write(RawConverter(raw_format("signed", 16)).to_raw(
            WavData.load(wav).samples))
    return wav, raw


def _report(cmd):
    """(ttfb s, total s, bytes) that a ttfb tool printed."""
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                          env=ENV, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    m = LINES.fullmatch(proc.stdout)
    assert m, proc.stdout
    first, total, n = float(m.group(1)), float(m.group(2)), int(m.group(3))
    assert 0 < first <= total
    return first, total, n


def _add_to_file(argv):
    subprocess.run([sys.executable, "-m", "audiowmark_tpu_torch", "-q",
                    "add"] + argv, check=True, cwd=REPO, env=ENV,
                   timeout=600)


@pytest.mark.parametrize("raw", [False, True], ids=["wav", "raw"])
def test_ttfb_counts_the_bytes_of_the_add(noise, tmp_path, raw):
    src = noise[1] if raw else noise[0]
    options = ["--input-format", "raw", "--raw-rate", "44100"] if raw else []
    _, _, n = _report([sys.executable, "-m", "audiowmark_tpu_torch.ttfb"]
                      + options + [src, MSG])
    out = str(tmp_path / "out.wav")
    _add_to_file(options + [src, out, MSG])
    assert n == os.path.getsize(out) == 44 + 5 * 44100 * 2 * 2


def test_ttfb_matches_the_jax_tool(noise, tmp_path, monkeypatch):
    from audiowmark_tpu import cli as j_cli
    from audiowmark_tpu.params import Params as JParams
    wav = noise[0]
    _, _, n_jax = _report([sys.executable, "tools/ttfb_test.py", wav, MSG])
    marked = tmp_path / "port.wav"
    monkeypatch.setenv("AUDIOWMARK_TORCH_DEVICE", "cpu")
    with open(marked, "wb") as sink:
        _, _, n = ttfb.measure(wav, MSG, sink=sink)
    assert n == n_jax == os.path.getsize(marked)

    jax_out = str(tmp_path / "jax.wav")
    JParams.reset()
    try:
        assert j_cli.main(["-q", "add", wav, jax_out, MSG]) == 0
    finally:
        JParams.reset()
    with open(jax_out, "rb") as f:
        jax_bytes = f.read()
    port_bytes = marked.read_bytes()
    assert len(jax_bytes) == len(port_bytes)
    port = np.frombuffer(port_bytes[44:], dtype="<i2").astype(np.int32)
    jax = np.frombuffer(jax_bytes[44:], dtype="<i2").astype(np.int32)
    print("ttfb.py vs the JAX package's add: %d of %d samples apart"
          % (np.count_nonzero(port - jax), port.size))
    assert np.abs(port - jax).max() <= 1

"""audiowmark_tpu_torch.ber_row, the port's robustness matrix, against the
tools that made docs/BER.md (tools/ber_report.py, tools/ber_test.py):

* its rows are tools/ber_report.py's ROWS;
* each carrier is the tool's, byte for byte (`noise`: the JAX package's
  test-gen-noise);
* the transforms that need no codec give the files tools/ber_test.py
  gives, from the same random state (resample:48000 within 1 LSB: each
  package resamples with its own resampler);
* it reads docs/BER.md's 37 rows, and its table and verdict follow the
  tool's rules (a FLOOR row with a frame error fails, so does a matrix
  whose CONTROL rows show no bit error).

The matrix itself (docs/BER_torch.md) is a script run, not a test:
`python3 -m audiowmark_tpu_torch.ber_row --all`.
"""

import os
import sys

import numpy as np
import pytest
import torch

from audiowmark_tpu import cli as j_cli
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch import ber_row
from audiowmark_tpu_torch.io.wavdata import WavData

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def test_rows_are_the_ber_tools_rows():
    assert ber_row.ROWS == _tool("ber_report").ROWS
    free = [r for r in ber_row.ROWS if not ber_row.codec_of(r[2])]
    assert len(ber_row.ROWS) == 37 and len(free) == 10
    assert {r[2].split(":")[0] for r in free} == {"none", "resample",
                                                  "trunc", "clip"}


@pytest.mark.parametrize("carrier", ["noise", "speech", "chords", "piano",
                                     "chirp"])
def test_carrier_is_the_ber_tools_carrier(carrier, tmp_path):
    a, b = str(tmp_path / "tool.wav"), str(tmp_path / "port.wav")
    if carrier == "noise":
        JParams.reset()
        assert j_cli.main(["test-gen-noise", a, "3", "44100"]) == 0
    else:
        _tool("ber_report")._GENERATORS[carrier](a, 3)
    ber_row.GENERATORS[carrier](b, 3)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("kind", ["none", "trunc:15", "clip:10",
                                  "resample:48000"])
def test_codec_free_transform_is_the_ber_tools(kind, tmp_path, monkeypatch):
    monkeypatch.setenv("AUDIOWMARK_TORCH_DEVICE", "cpu")
    src = str(tmp_path / "chirp.wav")
    ber_row.gen_chirp(src, 20)
    a, b = str(tmp_path / "tool.wav"), str(tmp_path / "port.wav")
    j_rng, t_rng = np.random.RandomState(42), np.random.RandomState(42)
    _tool("ber_test").transform(kind, src, a, rng=j_rng)
    ber_row.transform(kind, src, b, t_rng)
    JParams.reset()
    wa, wb = WavData.load(a), WavData.load(b)
    assert (wa.sample_rate, wa.n_channels, wa.samples.shape) == \
        (wb.sample_rate, wb.n_channels, wb.samples.shape)
    lsb = np.abs(np.round((wa.samples.astype(np.float64) - wb.samples)
                          * 32768))
    assert lsb.max() <= (1 if kind.startswith("resample") else 0)
    assert j_rng.randint(0, 1 << 30) == t_rng.randint(0, 1 << 30)


def test_reads_docs_ber_md():
    ref = ber_row.reference_rows()
    assert len(ref) == 37
    assert ref[("music", "speed-mp3:0.9764:128", "10")] == \
        ("0.425781 (109/256)", "1.000000 (2/2)")
    assert ref[("noise@200s", "none", "10")] == ("0.000000 (0/256)",
                                                 "0.000000 (0/2)")
    for r in ber_row.ROWS:
        assert (ber_row.label(r[0], r[1]), r[2], r[3]) in ref


def _result(label, kind, counts):
    return dict(label=label, transform="none", strength="10", kind=kind,
                note="n", counts=counts, seconds=1.0)


def test_table_and_verdict():
    ok = [_result("noise", "floor", (0, 256, 0, 2)),
          _result("music", "control", (100, 256, 2, 2)),
          _result("chirp", "info", (3, 256, 1, 2))]
    assert ber_row.verdict(ok) == ([], True)
    text = ber_row.table(ok, "python3 -m audiowmark_tpu_torch.ber_row --all",
                         "on the CPU")
    assert "| noise | `none` | 10 | FLOOR | 0.000000 (0/256) | 0.000000 " \
           "(0/2) | 0.000000 (0/256) | 0.000000 (0/2) | n |" in text
    assert "| chirp | `none` | 10 | INFO | 0.011719 (3/256)" in text
    assert "Generated by `python3 -m audiowmark_tpu_torch.ber_row --all`" \
        in text
    bad = ok + [_result("piano", "floor", (1, 256, 1, 2))]
    assert ber_row.verdict(bad) == ([("piano", "none")], True)
    quiet = [_result("music", "control", (0, 256, 0, 2))]
    assert ber_row.verdict(quiet) == ([], False)
    assert ber_row.verdict(ok[:1]) == ([], True)

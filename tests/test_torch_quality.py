"""audiowmark_tpu_torch.quality_report, the port's strength sweep, against
the tool that made docs/QUALITY.md (tools/quality_report.py):

* both carriers are the tool's, byte for byte (noise: the JAX package's
  test-gen-noise at 0.6 peak; music: tools/ber_report.py's gen_tonal);
* `add --strength S --snr` on the port (CPU) and on the JAX package prints
  SNRs within 1e-4 dB, and the NMR of the two marked files is within 1e-4
  dB, at strengths 30, 10 and 1 on the noise carrier and 10 on the tonal
  one (measured apart: <= 1e-6 dB), 30 s as docs/QUALITY.md;
* the tool's checks pass on the port's rows, with the mp3 anchors where
  libmp3lame loads;
* the port's nmr_db is the tool's on the same arrays, and its report
  reads docs/QUALITY.md's numbers.

The whole sweep (docs/QUALITY_torch.md) is a script run, not a test:
`python3 -m audiowmark_tpu_torch.quality_report --out docs/QUALITY_torch.md`.
"""

import os
import sys

import numpy as np
import pytest
import torch

from audiowmark_tpu_torch import quality_report as qr
from audiowmark_tpu_torch.io.wavdata import WavData

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import quality_report as tool  # noqa: E402

SECONDS = 30


@pytest.fixture(scope="module")
def carriers(tmp_path_factory):
    """{carrier: (the tool's file, the port's file)}."""
    d = tmp_path_factory.mktemp("quality")
    out = {}
    for name, tool_gen in (("noise", tool.gen_noise),
                           ("music", tool.gen_music)):
        a, b = str(d / (name + "_tool.wav")), str(d / (name + "_port.wav"))
        tool_gen(a, SECONDS)
        qr.GENERATORS[name](b, SECONDS)
        out[name] = (a, b)
    return out


@pytest.fixture(scope="module")
def rows(carriers, tmp_path_factory):
    """{carrier: [(strength, (JAX SNR, NMR), (port SNR, NMR))]}."""
    d = str(tmp_path_factory.mktemp("marked"))
    out = {}
    for carrier, strengths in (("noise", (30, 10, 1)), ("music", (10,))):
        src = carriers[carrier][0]
        orig = WavData.load(src)
        out[carrier] = []
        for s in strengths:
            j_dst = os.path.join(d, "%s_jax_%d.wav" % (carrier, s))
            t_dst = os.path.join(d, "%s_port_%d.wav" % (carrier, s))
            j_snr = tool.add_with_snr(src, j_dst, s)
            t_snr = qr.add_with_snr(src, t_dst, s, device="cpu")
            out[carrier].append((s, (j_snr, tool.nmr_db(
                orig.samples, WavData.load(j_dst).samples, 2)),
                (t_snr, qr.nmr_db(orig.samples, WavData.load(t_dst).samples,
                                  2))))
    return out


@pytest.mark.parametrize("carrier", ["noise", "music"])
def test_carrier_is_the_quality_tools_carrier(carriers, carrier):
    a, b = carriers[carrier]
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("carrier,strength", [("noise", 30), ("noise", 10),
                                              ("noise", 1), ("music", 10)])
def test_snr_and_nmr_match_jax(rows, carrier, strength):
    (jax_snr, jax_nmr), (port_snr, port_nmr) = [
        (j, t) for s, j, t in rows[carrier] if s == strength][0]
    print("%s s%d: SNR %.6f / %.6f, NMR %.6f / %.6f (JAX / port)"
          % (carrier, strength, jax_snr, port_snr, jax_nmr, port_nmr))
    assert abs(port_snr - jax_snr) <= 1e-4
    assert abs(port_nmr - jax_nmr) <= 1e-4
    assert np.isfinite(port_nmr)


@pytest.mark.parametrize("carrier", ["noise", "music"])
def test_checks_pass_on_the_ports_rows(rows, carriers, carrier):
    port_rows = [(s, snr, nmr) for s, _, (snr, nmr) in rows[carrier]]
    anchors = None
    if qr.anchors_missing() is None:
        orig = WavData.load(carriers[carrier][1])
        anchors = {br: qr.mp3_anchor_nmr(orig, br)
                   for br in qr.ANCHOR_BITRATES}
    assert qr.checks(carrier, port_rows, anchors) == []


def test_checks_find_what_the_tool_finds():
    """A sweep whose SNR rises with strength, an SNR under 20 dB at
    strength 10, an NMR over 0 dB and a ladder out of order each fail."""
    good = [(30, 21.4, -11.0), (10, 31.0, -20.6), (1, 51.0, -40.6)]
    ladder = {320: -15.7, 256: -12.8, 128: -4.4, 64: 7.4}
    assert qr.checks("noise", good, ladder) == []
    assert len(qr.checks("noise", [(30, 35.0, -11.0), (10, 31.0, -20.6)])) \
        == 1
    assert len(qr.checks("noise", [(10, 19.0, 0.5)])) == 2
    assert len(qr.checks("noise", good, {**ladder, 64: -20.0})) == 1
    assert len(qr.checks("noise", good, {**ladder, 256: -25.0})) == 2


def test_nmr_db_is_the_tools():
    rng = np.random.RandomState(11)
    orig = (rng.randn(2 * 3 * 44100) * 0.1).astype(np.float32)
    marked = orig + (rng.randn(orig.size) * 1e-3).astype(np.float32)
    assert qr.nmr_db(orig, marked, 2) == tool.nmr_db(orig, marked, 2)
    assert qr.nmr_db(orig, orig, 2) == float("-inf")
    lag = np.zeros(100, np.float32)
    shifted = np.concatenate([lag, marked])
    assert qr._align_delay(marked, shifted, 2) == tool._align_delay(
        marked, shifted, 2) == 50
    anchors = {320: -15.7, 256: -12.8, 128: -4.4, 64: 7.4}
    for nmr in (-20.0, -14.0, 0.0, 10.0):
        assert qr.odg_region(nmr, anchors) == tool.odg_region(nmr, anchors)


def test_report_reads_quality_md():
    sweep, anchors = qr.reference()
    assert sorted(sweep) == sorted(qr.STRENGTHS)
    assert sweep[10] == ("31.008", "-20.567", "30.936", "-0.809")
    assert anchors["music"][4] == "-0.809"

"""The port on a CUDA card: kernel K1 vs its plain version, and the slice,
the streaming resampler, the 48 kHz streaming add and the staged search on
the card vs the port on the CPU.

Every test here needs the card and skips without one.  This file imports
no jax, so it runs where jax is absent, without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from audiowmark_tpu.crypto.keys import Key
from audiowmark_tpu.io.wavdata import WavData
from audiowmark_tpu.params import Params
from audiowmark_tpu_torch import add_watermark, get_watermark
from audiowmark_tpu_torch.fixtures import acs_check_metrics
from audiowmark_tpu_torch.ops import frames, viterbi

pytestmark = pytest.mark.cuda
MSG = "f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0"


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    Params.reset()
    yield
    Params.reset()


def test_kernel_matches_plain_on_card():
    """K1 vs the plain trellis, both on the card, at the main path's 143
    steps, on clean codewords of each block type (exact ties), an all-NaN
    row and random rows: decisions, final metrics (NaN equal to NaN) and
    bits exact."""
    bm = acs_check_metrics(1, 6, 143, "cuda")
    before = viterbi.LAUNCHES
    dec, met, bits = viterbi.viterbi_acs(bm)
    assert viterbi.LAUNCHES == before + 1
    pdec, pmet, pbits = viterbi.viterbi_acs_plain(bm)
    torch.cuda.synchronize()
    assert torch.equal(dec, pdec)
    torch.testing.assert_close(met, pmet, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(bits, pbits)
    assert torch.isnan(met[3]).all()


def test_add_core_on_card_matches_cpu():
    """The add core on the card vs on the CPU, int16 out: at most 1 LSB
    apart, on at most 3e-3 of the samples.  The FFTs and exp/log of the two
    devices differ in the last bits, which moves a few samples across a
    quantization step: 95 to 131 of 81920 (1.2e-3 to 1.6e-3) in the card
    runs so far (H100, 700 W), so the limit is about twice the worst."""
    rng = np.random.RandomState(2)
    n_frames, C = 40, 2
    x = rng.randint(-30000, 30000, n_frames * frames.FRAME * C) \
        .astype(np.float32) / np.float32(32768.0)
    mods = rng.randint(-1, 2, (n_frames, frames.N_BINS)).astype(np.int8)
    outs = []
    for dev in ("cuda", "cpu"):
        outs.append(frames.add_file_core(
            torch.from_numpy(x).to(dev), torch.from_numpy(mods).to(dev),
            Params.water_delta,
            torch.from_numpy(frames.analysis_window()).to(dev),
            torch.from_numpy(frames.synthesis_window()).to(dev), C, x.size,
            False, True, 4096).cpu().numpy().astype(np.int32))
    diff = np.abs(outs[0] - outs[1])
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= 3e-3 * diff.size


def test_slice_on_card_matches_cpu(tmp_path):
    """add + cmp at the reduced geometry of tests/test_torch_slice.py: the
    card's marked file is within 1 LSB of the CPU's, and the card's report
    on it equals the CPU's, pattern for pattern (qualities and errors
    within their printed 3 decimals)."""
    Params.sync_frames_per_bit = 30
    Params.frames_per_bit = 1
    rng = np.random.RandomState(7)
    WavData(((rng.rand(80 * 44100 * 2) * 2 - 1) * 0.5).astype(np.float32),
            2, 44100, 16).save(str(tmp_path / "n.wav"))
    marked = []
    for dev in ("cuda", "cpu"):
        wm = str(tmp_path / ("wm_%s.wav" % dev))
        assert add_watermark(Key(), str(tmp_path / "n.wav"), wm, MSG,
                             device=dev) == 0
        marked.append(WavData.load(wm).samples.astype(np.float64))
    assert np.abs(marked[0] - marked[1]).max() * 32768 <= 1.0
    reports = []
    for dev in ("cuda", "cpu"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert get_watermark([Key()], str(tmp_path / "wm_cuda.wav"), MSG,
                                 device=dev) == 0
        reports.append([line.split() for line in out.getvalue().splitlines()])
    card, cpu = reports
    assert len(card) == len(cpu)
    for a, b in zip(card, cpu):
        if a[0] == "pattern":
            assert a[1:3] + a[5:] == b[1:3] + b[5:]
            assert abs(float(a[3]) - float(b[3])) <= 0.002
            assert abs(float(a[4]) - float(b[4])) <= 0.002
        else:
            assert a == b
    assert ["match_count", "5"] == [w for w in card if w[0] ==
                                    "match_count"][0][:2]


def test_resampler_on_card_matches_cpu():
    """The streaming resampler on the card vs on the CPU, over the same
    writes: readable counts exact, samples within atol 1e-6 (float64
    coefficients on each device by one formula, whose sin and cos may
    differ in the last float64 bit; the multiply-adds round alike).  The
    float32 coefficient rows themselves agree within atol 1e-7."""
    from audiowmark_tpu_torch.ops.resample import (StreamingResampler,
                                                   _coeffs)
    frac = torch.from_numpy(np.random.RandomState(4).rand(65536))
    rows = [_coeffs(frac.to(dev), 44100 / 48000).cpu().numpy()
            for dev in ("cuda", "cpu")]
    print("coefficients that differ: %d of %d"
          % (np.count_nonzero(rows[0] != rows[1]), rows[0].size))
    np.testing.assert_allclose(rows[0], rows[1], rtol=0, atol=1e-7)
    rng = np.random.RandomState(3)
    x = ((rng.rand(48000 * 2) * 2 - 1) * 0.9).astype(np.float32)
    outs = []
    for dev in ("cuda", "cpu"):
        res = StreamingResampler(2, 48000, 44100, dev)
        got, counts = [], []
        for lo, hi in ((0, 1000), (1000, 30000), (30000, 48000)):
            res.write_frames(x[2 * lo:2 * hi])
            counts.append(res.can_read_frames())
            got.append(res.read_frames(counts[-1]).cpu().numpy())
        outs.append((np.concatenate(got), counts))
    assert outs[0][1] == outs[1][1]
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=0, atol=1e-6)


def test_streaming_add_and_staged_search_on_card_match_cpu(tmp_path):
    """A 48 kHz streaming add (raw input of unknown length, through the
    resampler pair) on the card vs on the CPU, within 1 LSB; then the
    staged and the fused search of the card's file, on the card, equal
    the CPU's staged search.  Geometry of tests/test_torch_slice.py."""
    from audiowmark_tpu.params import Format
    from audiowmark_tpu_torch.models import syncfinder as sf
    Params.sync_frames_per_bit = 30
    Params.frames_per_bit = 1
    rng = np.random.RandomState(48)
    rng.randint(-16000, 16000, 32 * 48000 * 2).astype("<i2").tofile(
        str(tmp_path / "n48.raw"))
    marked = []
    for dev in ("cuda", "cpu"):
        Params.input_format = Format.RAW
        Params.raw_input_format.set_sample_rate(48000)
        wm = str(tmp_path / ("wm_%s.wav" % dev))
        assert add_watermark(Key(), str(tmp_path / "n48.raw"), wm, MSG,
                             device=dev) == 0
        Params.input_format = Format.AUTO
        marked.append(WavData.load(wm))
    a, b = (m.samples.astype(np.float64) for m in marked)
    assert a.shape == b.shape == (32 * 48000 * 2,)
    assert np.abs(a - b).max() * 32768 <= 1.0

    from audiowmark_tpu_torch.ops.resample import resample
    wav44 = resample(marked[0], 44100, device="cuda")
    results = [sf.search_staged([Key()], wav44, sf.SyncMode.BLOCK, dev)
               for dev in ("cuda", "cpu")]
    results.append(sf.search([Key()], wav44, sf.SyncMode.BLOCK, "cuda"))
    want = [(s.index, s.block_type) for s in results[1][0].sync_scores]
    assert want
    for r in (results[0], results[2]):
        assert [(s.index, s.block_type) for s in r[0].sync_scores] == want
        np.testing.assert_allclose(
            [s.quality for s in r[0].sync_scores],
            [s.quality for s in results[1][0].sync_scores],
            rtol=2e-4, atol=2e-5)

"""The port on a CUDA card: kernel K1 vs its plain version, and the slice,
the streaming resampler, the 48 kHz streaming add, the staged search and
a speed scan on the card vs the port on the CPU; the command line on the
card; the fleet API (watermark_batch, detect_batch) card vs CPU and K1 at
its batch of 256 rows; the add's delta of every tile size of the
unknown-length add's ramp against one call on 4096 frames, bit for bit;
kernel K2 vs the resampler's plain rows on the card, and the streaming
resampler on the card written in one piece and in many; the streaming
limiter on the card vs the numpy one, and the 48 kHz streaming add's
output on the card vs the host finish of its own tiles, byte for byte.

Every test here needs the card and skips without one.  This file imports
no jax and nothing of the JAX package, so it runs where jax is absent,
without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from audiowmark_tpu_torch import add_watermark, get_watermark
from audiowmark_tpu_torch.crypto.keys import Key
from audiowmark_tpu_torch.fixtures import acs_check_metrics, acs_equal
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.ops import frames, viterbi
from audiowmark_tpu_torch.params import Format, Params

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
    row and random rows: decisions (packed, and unpacked to one int8 per
    state), final metrics (NaN equal to NaN) and bits exact."""
    bm = acs_check_metrics(1, 6, 143, "cuda")
    before = viterbi.LAUNCHES
    dec, met, bits = viterbi.viterbi_acs(bm)
    assert viterbi.LAUNCHES == before + 1
    pdec, pmet, pbits = viterbi.viterbi_acs_plain(bm)
    torch.cuda.synchronize()
    assert torch.equal(dec, pdec)
    assert torch.equal(viterbi.unpack_decisions(dec),
                       viterbi.unpack_decisions(pdec))
    torch.testing.assert_close(met, pmet, rtol=0, atol=0, equal_nan=True)
    assert torch.equal(bits, pbits)
    assert torch.isnan(met[3]).all()


@pytest.mark.parametrize("steps", [1, 17, 143])
@pytest.mark.parametrize("batch", [1, 3, 16, 52, 140])
def test_kernel_matches_plain_at_every_batch(batch, steps):
    """K1 at the cluster size each B picks (printed) vs the plain version,
    bit for bit; 140 rows at C = 2 run in more than one wave."""
    bm = acs_check_metrics(batch + steps, batch, steps, "cuda")
    assert acs_equal(viterbi.viterbi_acs(bm), viterbi.viterbi_acs_plain(bm))
    cluster = viterbi.cluster_size(
        batch, torch.cuda.get_device_properties(0).multi_processor_count)
    active = viterbi.launch(bm, *viterbi.outputs(bm), cluster)
    print("B=%d steps=%d: %d CTAs per row, %d clusters at once"
          % (batch, steps, cluster, active))
    if batch == 140:
        assert batch > active


@pytest.mark.parametrize("cluster", viterbi.CLUSTER_SIZES)
def test_kernel_matches_plain_at_every_cluster_size(cluster):
    bm = acs_check_metrics(cluster, 5, 40, "cuda")
    outs = viterbi.outputs(bm)
    assert viterbi.launch(bm, *outs, cluster) > 0
    assert acs_equal(outs, viterbi.viterbi_acs_plain(bm))


def test_wrapper_limits_raise():
    """Each limit of the kernel raises a ValueError that names it: the
    16-byte alignment of cp.async.bulk, the step and row counts the
    kernel's 32-bit counters take, the cluster sizes."""
    S = viterbi.STATE_COUNT
    flat = torch.zeros(2 * 3 * S + 1, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        viterbi.viterbi_acs(flat[1:].view(2, 3, S))
    row = torch.zeros(1, 1, S, device="cuda")
    with pytest.raises(ValueError, match="MAX_STEPS"):
        viterbi.viterbi_acs(row.expand(1, viterbi.MAX_STEPS + 1, S))
    with pytest.raises(ValueError, match="MAX_BATCH"):
        viterbi.viterbi_acs(row.expand(viterbi.MAX_BATCH + 1, 1, S))
    bm = torch.zeros(1, 2, S, device="cuda")
    with pytest.raises(ValueError, match="cluster"):
        viterbi.launch(bm, *viterbi.outputs(bm), 16)


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


@pytest.mark.parametrize("tile", [16, 32, 64, 128, 256, 512])
def test_delta_of_every_ramp_tile_equals_the_4096_frame_batch(tile):
    """_delta_iffts of consecutive tiles of each size of the unknown-length
    add's ramp, bit for bit the same rows as one call on 4096 frames (laid
    out as the add lays them out).  cuFFT's rows at batches of up to 1024
    rows differ in the last bit from those at 2048 rows and more (H100,
    tile_probe.py stages); _delta_iffts launches one batch shape."""
    rng = np.random.RandomState(tile)
    n, C = 4096, 2
    x = torch.from_numpy(rng.uniform(-0.9, 0.9, n * frames.FRAME * C)
                         .astype(np.float32)).cuda()
    f = x.reshape(n, frames.FRAME, C).transpose(1, 2)
    mods = torch.from_numpy(rng.randint(-1, 2, (n, frames.N_BINS))
                            .astype(np.int8)).cuda()
    awin = torch.from_numpy(frames.analysis_window()).cuda()
    full = frames._delta_iffts(f, mods, Params.water_delta, awin)
    tiles = torch.cat([frames._delta_iffts(
        f[s:s + tile], mods[s:s + tile], Params.water_delta, awin)
        for s in range(0, n, tile)])
    assert torch.equal(tiles, full)


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


@pytest.mark.parametrize("coeff_dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ratio", [44100 / 48000, 48000 / 44100, 0.98 / 2])
def test_k2_matches_plain_rows_on_card(ratio, coeff_dtype):
    """K2 vs the plain rows on the card at 48, 32 and 80 taps, an hour
    into a stream and across the plain version's 64 K-row tiles: one
    launch, counted, and the largest difference printed (the aim is 0: one
    formula, op for op)."""
    from audiowmark_tpu_torch.ops import resample
    from audiowmark_tpu_torch.utils import prof
    n_taps = resample._filter_params(ratio)[3]
    rng = np.random.RandomState(17)
    xpad = torch.from_numpy(((rng.rand(70000 + n_taps, 2) * 2 - 1) * 0.9)
                            .astype(np.float32)).cuda()
    j0 = 3600 * 44100 + 7
    args = (xpad, j0, int(70000 * ratio), ratio,
            -int(np.floor(j0 / ratio)), coeff_dtype)
    before = resample.LAUNCHES
    prof.reset()
    prof.enabled = True
    try:
        got = resample._resample_rows(*args)
        counters = dict(prof.counters)
    finally:
        prof.enabled = False
        prof.reset()
    assert resample.LAUNCHES == before + 1
    assert counters.get("resample.k2") == 1 and "resample.plain" not in counters
    want = resample._resample_rows_plain(*args)
    err = float((got - want).abs().max())
    print("K2 vs plain at %d taps, %s: max abs %g" % (n_taps, coeff_dtype,
                                                      err))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("old,new", [(48000, 44100), (44100, 48000)])
def test_k2_stream_on_card_is_write_size_independent(old, new):
    """The streaming resampler on the card: 3 s in one write and in seeded
    writes of 1 frame up give the same output, bit for bit."""
    from audiowmark_tpu_torch.ops.resample import StreamingResampler
    n = 3 * old
    rng = np.random.RandomState(old)
    x = ((rng.rand(2 * n) * 2 - 1) * 0.9).astype(np.float32)
    outs = []
    for bounds in ([0, n], sorted({0, 1, 2, n, *rng.randint(3, n, 20)})):
        res = StreamingResampler(2, old, new, "cuda")
        got = []
        for lo, hi in zip(bounds, bounds[1:]):
            res.write_frames(x[2 * lo:2 * hi])
            got.append(res.read_frames(res.can_read_frames()).cpu())
        res.write_trailing_frames()
        got.append(res.read_frames(res.can_read_frames()).cpu())
        outs.append(torch.cat(got))
    assert torch.equal(outs[0], outs[1])


def test_streaming_add_and_staged_search_on_card_match_cpu(tmp_path):
    """A 48 kHz streaming add (raw input of unknown length, through the
    resampler pair) on the card vs on the CPU, within 1 LSB; then the
    staged and the fused search of the card's file, on the card, equal
    the CPU's staged search.  Geometry of tests/test_torch_slice.py."""
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


@pytest.mark.parametrize("rate", [44100, 48000])
def test_device_limiter_on_card_equals_numpy(rate):
    """DeviceStreamingLimiter on the card, bit for bit the numpy
    StreamingLimiter (fixtures.limiters_apart: stereo noise at peak 1.2,
    so the ceiling engages, a first piece of several blocks and 12 uneven
    ones, after a zero lead-in's skip and through flush)."""
    from audiowmark_tpu_torch.fixtures import limiters_apart
    sizes, apart, skipped = limiters_apart(rate, 2, 1.2, 2 * rate + 777,
                                           "cuda")
    assert skipped[0] == skipped[1] and sizes[0] == sizes[1]
    assert apart == 0


@pytest.mark.parametrize("output,known", [("wav16", True),
                                          ("float", False)])
def test_streaming_48k_add_on_card_equals_host_finish(output, known):
    """A 48 kHz streaming add on the card, byte for byte the host finish of
    its own tiles (fixtures.host_finish: numpy mix, StreamingLimiter, the
    writer's encode): 100 s of known length into 16-bit WAV (two 4096-frame
    tiles and the drain, each finished to int16 on the card), and 30 s of
    unknown length into float WAV (the ramp of tiles, read back as
    float32)."""
    from audiowmark_tpu_torch.fixtures import (MemoryWav, add_and_host_finish,
                                               limiter_signal)
    from audiowmark_tpu_torch.params import Encoding
    x = limiter_signal(48, 100 if known else 30, 48000, 2, 1.2)
    bits, enc = (16, Encoding.SIGNED) if output == "wav16" \
        else (32, Encoding.FLOAT)
    r = add_and_host_finish(
        x, 2, 48000, lambda name: MemoryWav(2, 48000, bits, enc,
                                            x.size // 2 if known else None),
        known, device="cuda")
    assert r["rc"] == 0 and r["tiles"] > 1
    got, want = r["device"].buf.getvalue(), r["host"].buf.getvalue()
    assert len(got) == len(want) > 0
    assert got == want
    assert set(r["device"].dtypes) == {
        np.dtype(np.int16 if output == "wav16" else np.float32)}
    finish = {k: v for k, v in r["counters"].items()
              if k.startswith("add.finish")}
    assert finish == {"add.finish_i16" if output == "wav16"
                      else "add.finish_f32": r["writes"]}


def test_speed_scan_on_card_matches_cpu():
    """One short scan (6 s, 3 centres, 5 rels, reduced geometry) of a seeded
    stereo clip on the card vs the port on the CPU: speeds equal, qualities
    within abs 1e-4 (the resampler's coefficients and the rfft round
    differently on the two devices, and the dB of a weak bin amplifies
    that)."""
    from audiowmark_tpu_torch.ops import speed as speed_ops
    from audiowmark_tpu_torch.tables import get_key_tables
    Params.sync_frames_per_bit = 30
    Params.frames_per_bit = 1
    bits = speed_ops.build_speed_sync_bits(get_key_tables(Key()))
    rng = np.random.RandomState(14)
    clip = ((rng.rand(8 * 44100 * 2) * 2 - 1) * 0.5).astype(np.float32)
    centers = [0.95, 1.0, 1.05]
    rels = [1.0007 ** p for p in range(-2, 3)]
    card, cpu = (speed_ops.speed_scan(clip, 2, centers, 6.0, rels, bits, dev)
                 for dev in ("cuda", "cpu"))
    assert [[sp for _, sp in row] for row in card] \
        == [[sp for _, sp in row] for row in cpu]
    q_card = np.array([[q for q, _ in row] for row in card])
    q_cpu = np.array([[q for q, _ in row] for row in cpu])
    assert q_cpu.max() > 0
    print("speed_scan card vs CPU: max |dq| %g" % np.abs(q_card - q_cpu).max())
    np.testing.assert_allclose(q_card, q_cpu, rtol=0, atol=1e-4)


def test_command_line_on_card(tmp_path, capsys):
    """`main([...])` with no device setting runs on the card: a 30 s file is
    marked, played at speed 1.01 and compared with --try-speed 1.01, which
    decodes it at that speed and at speed 1, each with a K1 launch of its
    own, and finds the message at the given speed."""
    from audiowmark_tpu_torch.cli import main
    noise, wm, fast = (str(tmp_path / name)
                       for name in ("n.wav", "wm.wav", "fast.wav"))
    assert main(["test-gen-noise", noise, "30", "44100"]) == 0
    assert main(["add", noise, wm, MSG]) == 0
    assert main(["test-change-speed", wm, fast, "1.01"]) == 0
    capsys.readouterr()
    before = viterbi.LAUNCHES
    assert main(["cmp", fast, MSG, "--try-speed", "1.01"]) == 0
    assert viterbi.LAUNCHES == before + 2
    out = capsys.readouterr().out
    assert "\nspeed 1.010000\n" in "\n" + out
    assert any(line.startswith("pattern") and "-SPEED" in line
               and line.split()[2] == MSG for line in out.splitlines())


def test_kernel_matches_plain_at_the_fleet_batch():
    """B = 256 rows at 143 steps, the batch detect_batch gives K1 for 16
    streams with top_k = 8, on branch metrics made on the card from seeded
    soft bits as ViterbiDecoder.forward makes them (A tables on the first
    half, B tables on the second)."""
    from audiowmark_tpu_torch.codec import convcode
    dec = convcode.viterbi_decoder("cuda")
    gen = torch.Generator(device="cuda").manual_seed(256)
    soft = torch.rand((128, 143 * 6), generator=gen, device="cuda")
    bm = torch.cat([convcode.batch_branch_metrics(soft, dec.table(bt))
                    for bt in (convcode.ConvBlockType.a,
                               convcode.ConvBlockType.b)]).contiguous()
    assert bm.shape == (256, 143, viterbi.STATE_COUNT)
    assert acs_equal(viterbi.viterbi_acs(bm), viterbi.viterbi_acs_plain(bm))


def test_detect_batch_on_card_matches_cpu():
    """The fleet API at the mini geometry (short-12 payload, 10 sync frames
    per bit, T = 1200, 4 streams, top_k = 4), card vs CPU: the marked
    batches within 1e-5, and on one marked batch positions, block types,
    bits and eligibility exact in every slot, qualities rtol 2e-4 atol
    2e-5; the card's detect_batch launches K1 once."""
    from audiowmark_tpu_torch import tables
    from audiowmark_tpu_torch.parallel.batch import (detect_batch,
                                                     watermark_batch)
    Params.payload_short = 12
    Params.payload_size = 12
    Params.sync_frames_per_bit = 10
    tables._cache.clear()
    try:
        rng = np.random.RandomState(7)
        audio = (rng.rand(4, 1200 * 1024, 2).astype(np.float32) - 0.5) * 0.6
        marked = watermark_batch(Key(), audio, "abc", device="cpu")
        on_card = watermark_batch(Key(), audio, "abc")
        np.testing.assert_allclose(on_card, marked, atol=1e-5, rtol=0)
        want = detect_batch(Key(), marked, top_k=4, device="cpu")
        before = viterbi.LAUNCHES
        got = detect_batch(Key(), marked, top_k=4)
        assert viterbi.LAUNCHES == before + 1
    finally:
        tables._cache.clear()
    for name in ("positions", "block_is_a", "bits", "eligible"):
        assert np.array_equal(got[name], want[name]), name
    np.testing.assert_allclose(got["qualities"], want["qualities"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["errors"], want["errors"], atol=1e-4)
    for b in range(4):
        best = int(np.argmax(got["qualities"][b]))
        assert abs(int(got["positions"][b][best]) - 250 * 1024) < 512


def test_forward_branch_metrics_in_one_buffer_equal_the_cat():
    """ViterbiDecoder.forward's branch metrics, written group by group into
    one buffer on the card, equal bit for bit the torch.cat of each group's
    metrics made apart, and those equal the CPU's."""
    from audiowmark_tpu_torch.codec import convcode
    dec = convcode.viterbi_decoder("cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    groups = [(bt, torch.rand((n, 143 * len(
        convcode.get_block_type_generators(bt))), generator=gen,
        device="cuda")) for bt, n in ((convcode.ConvBlockType.a, 5),
                                      (convcode.ConvBlockType.b, 3),
                                      (convcode.ConvBlockType.ab, 4))]
    want = [convcode.batch_branch_metrics(c, dec.table(bt))
            for bt, c in groups]
    seen = []
    acs = convcode.viterbi_acs
    convcode.viterbi_acs = lambda bm: seen.append(bm.clone()) or acs(bm)
    try:
        dec(groups)
    finally:
        convcode.viterbi_acs = acs
    assert len(seen) == 1 and torch.equal(seen[0], torch.cat(want))
    cpu = convcode.viterbi_decoder("cpu")
    on_cpu = torch.cat([convcode.batch_branch_metrics(c.cpu(), cpu.table(bt))
                        for bt, c in groups])
    print("branch metrics card vs CPU: %d of %d differ"
          % (int((seen[0].cpu() != on_cpu).sum()), on_cpu.numel()))

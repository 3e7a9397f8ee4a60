"""HLS on the port: hls-prepare and hls-add through
`audiowmark_tpu_torch.cli.main` on the CPU, the cases of
tests/test_hls_e2e.py.

The segments are cut as there: each 1024-aligned window of a seeded master
is AAC-encoded into MPEG-TS by the shim's segment writer (the port's copy
of the binding).  hls-prepare runs no device code, so its output must be
byte-equal to the JAX package's; hls-add goes through the port's streaming
add with zero_frames = start_pos - prev_size.
"""

import os

import numpy as np
import pytest
import torch

from audiowmark_tpu import cli as j_cli
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch import cli as t_cli
from audiowmark_tpu_torch.hls import hls as t_hls
from audiowmark_tpu_torch.hls.mpegts import TSReader
from audiowmark_tpu_torch.io import ffshim
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.params import Params as TParams

pytestmark = pytest.mark.skipif(not ffshim.available(),
                                reason="libffshim.so not built")

torch.set_num_threads(2)
PAYLOAD = "0123456789abcdef0011223344556677"


@pytest.fixture(autouse=True)
def cpu_port(monkeypatch):
    monkeypatch.setenv("AUDIOWMARK_TORCH_DEVICE", "cpu")
    JParams.reset()
    TParams.reset()
    yield
    JParams.reset()
    TParams.reset()


def _cli(cli, *args):
    JParams.reset()
    TParams.reset()
    assert cli.main(list(args)) == 0, args


def _make_hls(tmp_path, seconds_per_seg, n_segments, rate=44100, ch=2,
              seed=3, scale=0.125):
    """Master wav (Gaussian noise of standard deviation `scale`) + AAC TS
    segments + playlist."""
    seg_frames = (int(seconds_per_seg * rate) // 1024) * 1024
    total = seg_frames * n_segments
    rng = np.random.default_rng(seed)
    master = (rng.standard_normal(total * ch) * scale).astype(np.float32)

    in_dir = tmp_path / "as0"
    in_dir.mkdir()
    wav_path = tmp_path / "master.wav"
    WavData(master, ch, rate, 16).save(str(wav_path))
    # re-load: segment content must match the 16-bit master exactly
    master = WavData.load(str(wav_path)).samples

    names = []
    for k in range(n_segments):
        name = "out%d.ts" % k
        w = ffshim.HLSSegmentWriter(
            str(in_dir / name), rate, ch, 192000, 0, seg_frames // 1024,
            pts_start=k * seg_frames / rate)
        w.write(master[k * seg_frames * ch:(k + 1) * seg_frames * ch])
        w.close()
        names.append(name)

    playlist = ["#EXTM3U", "#EXT-X-VERSION:3",
                "#EXT-X-TARGETDURATION:%d" % (int(seconds_per_seg) + 1),
                "#EXT-X-MEDIA-SEQUENCE:0"]
    for name in names:
        playlist.append("#EXTINF:%.6f," % (seg_frames / rate))
        playlist.append(name)
    playlist.append("#EXT-X-ENDLIST")
    (in_dir / "out.m3u8").write_text("\n".join(playlist) + "\n")
    return wav_path, in_dir, names, seg_frames


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Two 5 s segments, prepared by the port and by the JAX package."""
    os.environ["AUDIOWMARK_TORCH_DEVICE"] = "cpu"
    d = tmp_path_factory.mktemp("hls")
    wav_path, in_dir, names, seg_frames = _make_hls(d, 5.0, 2)
    for cli, out in ((t_cli, "prep"), (j_cli, "prep_jax")):
        _cli(cli, "hls-prepare", str(in_dir), str(d / out), "out.m3u8",
             str(wav_path))
    del os.environ["AUDIOWMARK_TORCH_DEVICE"]
    return d, names, seg_frames


def test_hls_prepare_output_is_byte_equal_to_jax(prepared):
    d, names, _ = prepared
    for name in names + ["out.m3u8"]:
        with open(d / "prep" / name, "rb") as a, \
                open(d / "prep_jax" / name, "rb") as b:
            assert a.read() == b.read(), name


def test_hls_prepare_embeds_context_and_vars(prepared):
    d, names, seg_frames = prepared
    reader = TSReader()
    reader.load(str(d / "prep" / names[1]))
    assert reader.find("full.flac")
    vars_map = reader.parse_vars("vars")
    assert int(vars_map["size"]) == seg_frames
    assert int(vars_map["start_pos"]) == seg_frames
    assert int(vars_map["prev_size"]) == min(seg_frames, 3 * 44100)
    assert vars_map["channel_layout"] == "stereo"


def test_hls_prepare_and_add_structural(prepared, tmp_path):
    """add produces a TS whose decoded length is exactly the segment size
    and whose pts matches the timeline; the segment carries a watermark
    (it differs from the unmarked one)."""
    d, names, seg_frames = prepared
    for name in names:
        _cli(t_cli, "hls-add", str(d / "prep" / name), str(tmp_path / name),
             PAYLOAD)
    for k, name in enumerate(names):
        dec, ch, drate = ffshim.decode_file(str(tmp_path / name))
        assert (ch, drate) == (2, 44100)
        assert dec.size == seg_frames * 2, name
        p = ffshim.probe(str(tmp_path / name))
        assert abs(float(p["start_time"]) - k * seg_frames / 44100) < 0.05
        plain = ffshim.decode_file(str(d / "as0" / name))[0]
        assert float(np.abs(dec - plain).max()) > 1e-3


def test_hls_add_passes_the_segments_stream_position(prepared, tmp_path,
                                                     monkeypatch):
    """zero_frames = start_pos - prev_size and the device reach the
    streaming add (hls.py of the JAX package, lines 197-198)."""
    d, names, seg_frames = prepared
    from audiowmark_tpu_torch.models import embedder
    seen = []

    def spy(key, in_stream, out_stream, bits, zero_frames=0, device=None):
        seen.append((zero_frames, device, in_stream.n_frames()))
        return 0

    monkeypatch.setattr(embedder, "add_stream_watermark", spy)
    assert t_hls.hls_add(None, str(d / "prep" / names[1]),
                         str(tmp_path / "x.ts"), PAYLOAD, "cpu") == 0
    prev = min(seg_frames, 3 * 44100)
    assert seen == [(seg_frames - prev, "cpu", prev + seg_frames + 3 * 44100)]


def test_hls_add_pcm_matches_jax(tmp_path, monkeypatch):
    """hls-add of the second of two 5 s segments of a loud master (Gaussian
    noise of standard deviation 0.6, so the limiter works, as on the 200 s
    test-gen-noise file of chip_smoke.py's phase 18) through each package's
    command line: the marked PCM on its way to the AAC encoder (after the
    context the segment drops) is at most 1 LSB from the JAX package's.
    Against each package's whole-file add of the master followed by 13600
    more frames of that noise (phase 18 compares its 20 segments with the
    add of the 200 s file, which runs 13600 frames past them), the segment
    is further apart (its context ends in zeros where the file goes on), by
    the same amount in both packages: the gap is the reference's
    behaviour."""
    from audiowmark_tpu.crypto.keys import Key as JKey
    from audiowmark_tpu.hls import hls as j_hls
    from audiowmark_tpu.models.embedder import add_watermark as j_add
    from audiowmark_tpu_torch import add_watermark as t_add
    from audiowmark_tpu_torch.crypto.keys import Key as TKey
    wav_path, in_dir, names, seg_frames = _make_hls(tmp_path, 5.0, 2,
                                                    seed=4, scale=0.6)
    _cli(t_cli, "hls-prepare", str(in_dir), str(tmp_path / "prep"),
         "out.m3u8", str(wav_path))
    pcm = {}
    for side, cli, mod in (("jax", j_cli, j_hls), ("port", t_cli, t_hls)):
        parts = pcm.setdefault(side, [])
        write = mod.HLSOutputStream.write_frames

        def record(self, samples, parts=parts, write=write):
            n = min(self._delete_input_start * self._n_channels,
                    samples.size)
            parts.append(np.array(samples[n:], dtype=np.float64))
            return write(self, samples)

        monkeypatch.setattr(mod.HLSOutputStream, "write_frames", record)
        _cli(cli, "hls-add", str(tmp_path / "prep" / names[1]),
             str(tmp_path / ("%s.ts" % side)), PAYLOAD)
    got, want = (np.concatenate(pcm[s]) for s in ("port", "jax"))
    assert got.shape == want.shape and got.size > seg_frames * 2
    lsb = np.abs(np.round((got - want) * 32768))
    print("hls-add PCM: %d of %d samples 1 LSB from the JAX package's"
          % (np.count_nonzero(lsb), lsb.size))
    assert lsb.max() <= 1

    # each package's segment against its own whole-file add
    master = str(tmp_path / "longer.wav")
    tail = np.random.default_rng(5).standard_normal(13600 * 2) * 0.6
    WavData(np.concatenate([WavData.load(str(wav_path)).samples,
                            tail.astype(np.float32)]), 2, 44100,
            16).save(master)
    lead = min(3 * 1024, min(seg_frames, 3 * 44100)) * 2
    gaps = {}
    for side, add, key, kw in (("jax", j_add, JKey, {}),
                               ("port", t_add, TKey, dict(device="cpu"))):
        whole = str(tmp_path / ("whole_%s.wav" % side))
        JParams.reset()
        TParams.reset()
        assert add(key(), master, whole, PAYLOAD, **kw) == 0
        ref = WavData.load(whole).samples[seg_frames * 2:seg_frames * 4]
        seg = np.concatenate(pcm[side])[lead:lead + seg_frames * 2]
        gap = np.abs(seg - ref) * 32768     # the file is int16, truncated
        gaps[side] = (float(gap.max()), int(np.count_nonzero(gap > 1)))
    print("segment vs whole-file add (max LSB, samples > 1 LSB): %s" % gaps)
    assert abs(gaps["port"][0] - gaps["jax"][0]) <= 1
    assert abs(gaps["port"][1] - gaps["jax"][1]) <= 1e-3 * seg_frames * 2


def test_hls_errors_are_messages_not_tracebacks(prepared, tmp_path, capsys):
    d, names, _ = prepared
    capsys.readouterr()
    # an unprepared segment has no context
    assert t_cli.main(["hls-add", str(d / "as0" / names[0]),
                       str(tmp_path / "o.ts"), PAYLOAD]) == 1
    assert "no embedded context found" in capsys.readouterr().err
    # prepare refuses to overwrite its output
    assert t_cli.main(["hls-prepare", str(d / "as0"), str(d / "prep"),
                       "out.m3u8", str(d / "master.wav")]) == 1
    assert "output file already exists" in capsys.readouterr().err
    # and prepared segments as input
    assert t_cli.main(["hls-prepare", str(d / "prep"), str(tmp_path / "p2"),
                       "out.m3u8", str(d / "master.wav")]) == 1
    assert "must not contain context" in capsys.readouterr().err


@pytest.mark.slow
def test_hls_watermark_five_matches(tmp_path):
    """200 s master, 10 s segments, each segment watermarked on its own,
    the watermarked playlist decoded and joined: the 5 matches of a 200 s
    file."""
    wav_path, in_dir, names, seg_frames = _make_hls(tmp_path, 10.0, 20)
    prep_dir = tmp_path / "prep"
    _cli(t_cli, "hls-prepare", str(in_dir), str(prep_dir), "out.m3u8",
         str(wav_path))
    wm_dir = tmp_path / "wm"
    wm_dir.mkdir()
    for name in names:
        _cli(t_cli, "hls-add", str(prep_dir / name), str(wm_dir / name),
             PAYLOAD)
    chunks = [ffshim.decode_file(str(wm_dir / name))[0] for name in names]
    out_wav = tmp_path / "wm.wav"
    WavData(np.concatenate(chunks), 2, 44100, 16).save(str(out_wav))
    TParams.reset()
    assert t_cli.main(["cmp", str(out_wav), PAYLOAD, "--expect-matches",
                       "5"]) == 0

"""videowmark-torch on the native libav backend: the cases of
tests/test_videowmark.py on the port's helper (`python -m
audiowmark_tpu_torch.video`: probe / extract / remux) and its wrapper
script, which calls ./audiowmark-torch (on the CPU here:
AUDIOWMARK_TORCH_DEVICE=cpu); plus the helper against the JAX package's on
the same clip, and a short add -> get through the script at a reduced
geometry."""

import os
import subprocess
import sys

import numpy as np
import pytest

from audiowmark_tpu_torch.io import ffshim

pytestmark = pytest.mark.skipif(not ffshim.available(),
                                reason="libffshim.so not built")

PAYLOAD = "0123456789abcdef0011223344556677"


def _repo():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vhelper(*args):
    env = dict(os.environ, PYTHONPATH=_repo(),
               AUDIOWMARK_TORCH_DEVICE="cpu")
    return subprocess.run([sys.executable, "-m", "audiowmark_tpu_torch.video"]
                          + list(args), env=env, capture_output=True,
                          text=True, cwd=_repo())


def test_make_probe_extract(tmp_path):
    clip = str(tmp_path / "clip.mp4")
    ffshim.make_test_video(clip, 3.0)
    assert ffshim.stream_counts(clip) == (1, 1)

    r = _vhelper("probe", clip)
    assert r.returncode == 0
    assert "audio streams: 1, video streams: 1" in r.stdout

    wav = str(tmp_path / "a.wav")
    r = _vhelper("extract", clip, wav)
    assert r.returncode == 0, r.stderr
    from audiowmark_tpu_torch.io.wavdata import WavData
    w = WavData.load(wav)
    assert w.sample_rate == 44100
    assert w.n_channels == 2
    # ~3 s of audio (aac priming/padding tolerance)
    assert abs(w.n_frames - 3 * 44100) < 4096


def test_remux_replaces_audio_copies_video(tmp_path):
    clip = str(tmp_path / "clip.mp4")
    ffshim.make_test_video(clip, 3.0)
    wav = str(tmp_path / "a.wav")
    assert _vhelper("extract", clip, wav).returncode == 0

    # replace the audio with silence and verify the remux decodes silent
    from audiowmark_tpu_torch.io.wavdata import WavData
    w = WavData.load(wav)
    silent = str(tmp_path / "silent.wav")
    WavData(np.zeros_like(w.samples), w.n_channels, w.sample_rate,
            16).save(silent)
    out = str(tmp_path / "out.mp4")
    r = _vhelper("remux", clip, silent, out)
    assert r.returncode == 0, r.stderr

    assert ffshim.stream_counts(out) == (1, 1)
    dec, ch, rate = ffshim.decode_file(out)
    assert (ch, rate) == (2, 44100)
    assert abs(dec.size / ch - w.n_frames) < 8192
    assert float(np.max(np.abs(dec))) < 1e-3
    # video stream survived with the same codec
    p = ffshim.probe(clip)
    assert p  # probe still reads the original fine


def test_error_paths(tmp_path):
    missing = str(tmp_path / "nope.mp4")
    r = _vhelper("probe", missing)
    assert r.returncode == 1
    assert "videowmark: error:" in r.stderr

    # audio-only file rejected for extract (needs a video stream)
    wav_only = str(tmp_path / "a.m4a")
    ffshim.encode_file(wav_only, "ipod", "alac",
                       np.zeros(44100 * 2, np.float32), 2, 44100)
    r = _vhelper("extract", wav_only, str(tmp_path / "x.wav"))
    assert r.returncode == 1
    assert "no video stream" in r.stderr


def test_helper_extracts_what_the_jax_package_extracts(tmp_path):
    """The same clip through both helpers: byte-equal wav files."""
    clip = str(tmp_path / "clip.mp4")
    ffshim.make_test_video(clip, 2.0)
    a, b = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    assert _vhelper("extract", clip, a).returncode == 0
    env = dict(os.environ, PYTHONPATH=_repo(), AUDIOWMARK_JAX_PLATFORM="cpu")
    r = subprocess.run([sys.executable, "-m", "audiowmark_tpu.video",
                        "extract", clip, b], env=env, capture_output=True,
                       text=True, cwd=_repo())
    assert r.returncode == 0, r.stderr
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_helper_usage_and_script_usage(tmp_path):
    r = _vhelper("frobnicate")
    assert r.returncode == 1 and "audiowmark_tpu_torch.video" in r.stderr
    script = os.path.join(_repo(), "videowmark-torch")
    r = subprocess.run([script, "--help"], capture_output=True, text=True)
    assert r.returncode == 0 and "videowmark add" in r.stdout
    r = subprocess.run([script, "add", "only-one"], capture_output=True,
                       text=True)
    assert r.returncode == 1
    with open(script) as f:
        text = f.read()
    assert "audiowmark-torch" in text and "audiowmark_tpu.video" not in text \
        and "AUDIOWMARK_JAX_PLATFORM" not in text


def test_script_probe_and_get_on_an_unmarked_clip(tmp_path):
    """The wrapper end to end on the CPU: probe, and a get of a 3 s clip
    (extract, then ./audiowmark-torch get, which reports no block of the
    test message's kind: only the clip decoder's n-best guesses)."""
    env = dict(os.environ, AUDIOWMARK_TORCH_DEVICE="cpu")
    repo = _repo()
    clip = str(tmp_path / "clip.mp4")
    ffshim.make_test_video(clip, 3.0)
    script = os.path.join(repo, "videowmark-torch")
    r = subprocess.run([script, "probe", clip], env=env, capture_output=True,
                       text=True, cwd=repo)
    assert r.returncode == 0
    assert "audio streams: 1, video streams: 1" in r.stdout
    r = subprocess.run([script, "get", clip], env=env, capture_output=True,
                       text=True, cwd=repo)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("key") and PAYLOAD not in r.stdout
    r = subprocess.run([script, "get", str(tmp_path / "nope.mp4")], env=env,
                       capture_output=True, text=True, cwd=repo)
    assert r.returncode == 1 and "videowmark: error:" in r.stderr


@pytest.mark.slow
def test_videowmark_add_get(tmp_path):
    """Full wrapper flow: add embeds through extract+remux, get retrieves
    the payload from the AAC-recompressed audio track."""
    env = dict(os.environ, AUDIOWMARK_TORCH_DEVICE="cpu")
    repo = _repo()
    clip = str(tmp_path / "clip.mp4")
    ffshim.make_test_video(clip, 60.0)
    wm = str(tmp_path / "wm.mp4")

    r = subprocess.run([os.path.join(repo, "videowmark-torch"), "add", clip, wm,
                        PAYLOAD], env=env, capture_output=True, text=True,
                       cwd=repo)
    assert r.returncode == 0, r.stdout + r.stderr

    r = subprocess.run([os.path.join(repo, "videowmark-torch"), "probe", wm],
                       env=env, capture_output=True, text=True, cwd=repo)
    assert "audio streams: 1, video streams: 1" in r.stdout

    r = subprocess.run([os.path.join(repo, "videowmark-torch"), "get", wm],
                       env=env, capture_output=True, text=True, cwd=repo)
    assert r.returncode == 0, r.stdout + r.stderr
    assert PAYLOAD in r.stdout, r.stdout


def test_remux_keeps_av_sync_nonzero_start(tmp_path):
    """TS captures routinely start at nonzero dts; the remuxed replacement
    audio must start at the input audio stream's start time, not at zero,
    or playback desyncs by that offset (ffshim.cc ffr_remux_audio)."""
    clip = str(tmp_path / "clip.ts")
    ffshim.make_test_video(clip, 3.0, ts_offset=1.4)
    in_start = float(ffshim.probe(clip)["start_time"])
    assert in_start > 1.0          # the offset really applied

    wav = str(tmp_path / "a.wav")
    assert _vhelper("extract", clip, wav).returncode == 0
    out = str(tmp_path / "out.ts")
    r = _vhelper("remux", clip, wav, out)
    assert r.returncode == 0, r.stderr

    out_start = float(ffshim.probe(out)["start_time"])
    assert abs(out_start - in_start) < 0.1, (in_start, out_start)

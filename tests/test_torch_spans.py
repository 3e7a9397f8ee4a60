"""The tracer's spans and counters on the add, get and fleet paths
(utils/prof.py): a 44.1 kHz whole-file add, a 48 kHz streaming add, a
detect_batch on two logical CPU devices and the get's chunk fill, each
under a CPU torch.profiler trace.  Each names its stages; the spans that
one of the benchmark's per-layer metrics adds together never overlap on
one thread, so their share of the call's wall is at most 100 %; the build
counters count the builds, and a second call with the same key builds no
key tables.
"""

import json
from collections import defaultdict

import numpy as np
import pytest
import torch

from audiowmark_tpu_torch import cli, tables
from audiowmark_tpu_torch.crypto.keys import Key
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.ops.frames import FRAME
from audiowmark_tpu_torch.params import Format, Params
from audiowmark_tpu_torch.utils import prof

torch.set_num_threads(2)
MSG = "f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0"


@pytest.fixture(autouse=True)
def fresh():
    Params.reset()
    tables.clear_cache()
    prof.reset()
    yield
    prof.enabled = False
    prof.reset()
    Params.reset()
    tables.clear_cache()


def _traced(fn, path):
    """fn() inside a span `call`, under a CPU trace of every thread, with
    the tracer on; {name: [annotation events]}, and the counters."""
    from torch.profiler import ProfilerActivity, profile
    prof.reset()
    prof.enabled = True
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=cli._all_threads()) as p:
            with prof.phase("call"):
                fn()
    finally:
        prof.enabled = False
    p.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            by[e["name"]].append(e)
    return by, dict(prof.counters)


def _siblings(by, names):
    """The spans of `names` never overlap on one thread, and add up to at
    most the wall of `call`."""
    per_tid = defaultdict(list)
    for n in names:
        for e in by[n]:
            per_tid[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
    for spans in per_tid.values():
        spans.sort()
        for (_, end), (start, _) in zip(spans, spans[1:]):
            assert start >= end, names
    total = sum(e - s for spans in per_tid.values() for s, e in spans)
    assert 0 < total <= by["call"][0]["dur"]


def _noise(seconds, rate, seed=4):
    rng = np.random.RandomState(seed)
    return ((rng.rand(int(seconds * rate) * 2) * 2 - 1) * 0.5) \
        .astype(np.float32)


def _reduced():
    Params.sync_frames_per_bit = 30
    Params.frames_per_bit = 1


def test_whole_file_add_spans_and_counters(tmp_path):
    """44.1 kHz of known length: the whole-file add's five stages."""
    from audiowmark_tpu_torch.models import add_watermark
    _reduced()
    WavData(_noise(8, 44100), 2, 44100, 16).save(str(tmp_path / "in.wav"))

    def add():
        assert add_watermark(Key(), str(tmp_path / "in.wav"),
                             str(tmp_path / "out.wav"), MSG,
                             device="cpu") == 0

    by, counters = _traced(add, tmp_path / "t1.json")
    for name in ("add.read", "add.upload", "add.core", "add.readback",
                 "add.write"):
        assert len(by[name]) == 1, name
        _siblings(by, [name])
    assert "add.resample" not in by
    assert counters["build.key_tables"] == 1
    assert counters["build.tables_upload"] == 1
    _, counters = _traced(add, tmp_path / "t2.json")
    assert counters.get("build.key_tables", 0) == 0
    assert counters.get("build.tables_upload", 0) == 0


def test_streaming_48k_add_spans_and_counters(tmp_path):
    """48 kHz raw input of unknown length: the streaming add's tiles, each
    stage a span per call, one per resampler write and read."""
    from audiowmark_tpu_torch.models import add_watermark
    _reduced()
    pcm = (_noise(2, 48000) * 32767).astype("<i2")
    pcm.tofile(str(tmp_path / "in.raw"))
    Params.input_format = Format.RAW
    Params.raw_input_format.set_sample_rate(48000)

    def add():
        assert add_watermark(Key(), str(tmp_path / "in.raw"),
                             str(tmp_path / "out.wav"), MSG,
                             device="cpu") == 0

    by, counters = _traced(add, tmp_path / "t1.json")
    for name in ("add.setup", "add.read", "add.resample", "add.embed",
                 "add.readback", "add.limiter", "add.write"):
        assert by[name], name
    for name in ("add.read", "add.resample", "add.limiter", "add.write"):
        _siblings(by, [name])
    # per tile: the input resampler's write and read, the output's write
    # and read; never one span per filter tap
    tiles = len(by["add.limiter"])
    assert tiles >= 2
    assert 2 * tiles <= len(by["add.resample"]) <= 4 * tiles
    assert "add.core" not in by
    assert counters["build.key_tables"] == 1
    _, counters = _traced(add, tmp_path / "t2.json")
    assert counters.get("build.key_tables", 0) == 0


@pytest.fixture
def mini_fleet():
    Params.payload_short = 12
    Params.payload_size = 12
    Params.sync_frames_per_bit = 10


def test_detect_batch_spans_and_counters(tmp_path, mini_fleet):
    """detect_batch on a mesh of two logical shards of the CPU: one
    detector per distinct device, built and counted once a call; the
    per-stream stages inside each card's enqueue."""
    from audiowmark_tpu_torch.parallel import detect_batch, make_mesh
    rng = np.random.RandomState(7)
    audio = (rng.rand(4, 1200 * FRAME, 2).astype(np.float32) - 0.5) * 0.6
    mesh = make_mesh(2, dp=2, device="cpu")
    devices = mesh.flat().devices.reshape(-1)
    built = len(set(devices.tolist()))

    def detect():
        detect_batch(Key(), audio, mesh=mesh, top_k=4)

    by, counters = _traced(detect, tmp_path / "t1.json")
    for name in ("fleet.build", "fleet.upload", "fleet.enqueue",
                 "fleet.readback", "detect.spectrogram", "detect.select",
                 "detect.refine", "detect.extract", "viterbi.forward"):
        assert by[name], name
    assert len(by["fleet.upload"]) == len(by["fleet.enqueue"]) \
        == devices.size
    assert len(by["fleet.build"]) == built
    assert len(by["detect.refine"]) == audio.shape[0]
    for name in ("fleet.build", "fleet.enqueue"):
        _siblings(by, [name])
    assert counters["build.detector"] == built
    assert counters["build.key_tables"] == 1
    _, counters = _traced(detect, tmp_path / "t2.json")
    assert counters["build.detector"] == built
    assert counters.get("build.key_tables", 0) == 0


def test_chunk_fill_is_one_read_span_with_the_resampler_inside(tmp_path):
    """The get's chunk loader: one `load.read` per chunk fill, however
    many 4096-frame reads it makes; at 48 kHz the resampler's calls are
    `load.resample` spans inside it."""
    from audiowmark_tpu_torch.models.chunkloader import WavChunkLoader
    for rate in (44100, 48000):
        path = str(tmp_path / ("in%d.wav" % rate))
        WavData(_noise(3, rate), 2, rate, 16).save(path)
        loader = WavChunkLoader(path, "cpu")

        def fill():
            loader.load_next_chunk()

        by, _ = _traced(fill, tmp_path / ("t%d.json" % rate))
        loader.close()
        assert len(by["load.read"]) == 1
        inner = by.get("load.resample", [])
        assert bool(inner) == (rate != 44100)
        read = by["load.read"][0]
        assert all(e["tid"] == read["tid"] and e["ts"] >= read["ts"]
                   and e["ts"] + e["dur"] <= read["ts"] + read["dur"]
                   for e in inner)


def test_clip_windows_are_a_span_of_their_own(monkeypatch):
    """A stream under 3.1 blocks: the clip decoder's padded start and end
    windows are built inside `get.clip_windows`, before (and outside) the
    pair search's `get.search_clip`."""
    from audiowmark_tpu_torch.models import decoder, syncfinder
    _reduced()
    wav = WavData(_noise(30, 44100), 2, 44100, 16)
    monkeypatch.setattr(syncfinder, "search_clip_pair_launch",
                        lambda *a, **k: None)
    prof.enabled = True
    try:
        assert decoder.ClipDecoder(1, "cpu").launch([Key()], wav) \
            is not None
    finally:
        prof.enabled = False
    assert prof.counts["get.clip_windows"] == 1
    assert "get.search_clip" not in prof.counts


# ---- speed detection (get --detect-speed) -----------------------------------

# a 12-bit payload under the 128-bit code, 10 sync frames per bit (384
# frames per block), and scans cut to a few seconds
_SPEED_GEOMETRY = {"payload_size": 12, "sync_frames_per_bit": 10}
_SHORT_SCANS = {"SCAN1": (4, 1.003, 2, 1), "SCAN2": (4, 1.0015, 1, 0),
                "SCAN3": (4, 1.0001, 5, 0)}


@pytest.fixture
def short_speed(monkeypatch):
    from audiowmark_tpu_torch.models import speed
    for k, v in _SPEED_GEOMETRY.items():
        setattr(Params, k, v)
    for k, v in _SHORT_SCANS.items():
        monkeypatch.setattr(speed, k, v)


def _counted_scans(monkeypatch):
    """speed_scan wrapped to record the centres of each call."""
    from audiowmark_tpu_torch.ops import speed as ops
    seen = []
    scan0 = ops.speed_scan

    def scan(clip, n_channels, centers, *args, **kw):
        seen.append(len(centers))
        return scan0(clip, n_channels, centers, *args, **kw)

    monkeypatch.setattr(ops, "speed_scan", scan)
    return seen


def test_speed_detection_spans_and_counters(tmp_path, short_speed,
                                            monkeypatch):
    """detect_speed: the clip choice once, each scan's mag matrices and
    offset scans, the selections between the scans and the smoothing
    after them; `speed.scans` counts the scans and `speed.centres` the mag
    matrices built, one per centre."""
    from audiowmark_tpu_torch.models.speed import detect_speed
    seen = _counted_scans(monkeypatch)
    wav = WavData(_noise(10, 44100), 2, 44100, 16)
    by, counters = _traced(lambda: detect_speed([Key()], wav, False, "cpu"),
                           tmp_path / "t1.json")
    assert len(by["speed.clip"]) == 1
    assert len(by["speed.select"]) == 3
    assert by["speed.prepare"] and by["speed.compare"]
    for name in ("speed.clip", "speed.prepare", "speed.compare",
                 "speed.select"):
        _siblings(by, [name])
    _siblings(by, ["speed.clip", "speed.prepare", "speed.compare",
                   "speed.select"])
    assert len(seen) == counters["speed.scans"] == 3
    assert counters["speed.centres"] == sum(seen) == \
        len(by["speed.prepare"]) - 3


def test_speed_spans_are_absent_and_free_when_off(short_speed):
    from audiowmark_tpu_torch.models.speed import detect_speed
    assert not prof.enabled
    assert prof.phase("get.speed") is prof.phase("speed.clip")
    detect_speed([Key()], WavData(_noise(6, 44100), 2, 44100, 16), False,
                 "cpu")
    assert not prof.totals and not prof.counts and not prof.counters


def test_get_speed_spans_nest_the_decode_at_the_speed(tmp_path, short_speed,
                                                      monkeypatch):
    """get_watermark with --detect-speed (the detection's result replaced
    by a fixed speed, so that the decode at a speed runs): `get.speed`
    around the detection, `get.speed_decode` around the decode at the
    speed with `get.speed_resample` and the decode's own search and
    extraction spans inside it, all on the get's thread."""
    from audiowmark_tpu_torch.models import getter
    path = str(tmp_path / "in.wav")
    # over 3.1 blocks: no clip decoder, whose padded windows take the CPU
    # most of a minute
    WavData(_noise(30, 44100), 2, 44100, 16).save(path)
    Params.get_n_best = 1
    detect0 = getter.detect_speed
    monkeypatch.setattr(getter, "detect_speed", lambda keys, *a, **kw: [
        (k, 1.03) for k, _ in [(k, detect0(keys, *a, **kw)) for k in keys]])
    monkeypatch.setenv("AUDIOWMARK_PREFETCH", "0")
    Params.detect_speed = True

    def get():
        getter.get_watermark([Key()], path, "", device="cpu")

    by, counters = _traced(get, tmp_path / "t1.json")
    assert len(by["get.speed"]) == len(by["get.speed_decode"]) == 1
    assert len(by["get.speed_resample"]) == 1
    assert counters["speed.scans"] == 3
    outer = by["get.speed_decode"][0]

    def inside(e, o):
        return e["tid"] == o["tid"] and e["ts"] >= o["ts"] \
            and e["ts"] + e["dur"] <= o["ts"] + o["dur"]

    assert inside(by["get.speed_resample"][0], outer)
    assert all(inside(e, by["get.speed"][0]) for e in by["speed.compare"])
    for name in ("get.search_block", "get.extract"):
        assert len(by[name]) == 2, name       # at the speed, then at 1
        assert inside(by[name][0], outer) and not inside(by[name][1], outer)
    _siblings(by, ["get.speed", "get.speed_decode"])

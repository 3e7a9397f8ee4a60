"""The `get_speed` entry and its cell on the CPU: a run through the
harness's own run_cell at a small geometry with the scans cut to a few
seconds (the port's named constants and the configuration's `get` section
cut alike), judged correct, its speed scans held to one card; a
detected speed or a message altered where the program makes it, judged
not correct; the bfloat16 control against the cell's limits; the
configuration held to the port's constants; and the four readers of the
speed spans and counters."""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import tempfile

import pytest
import torch

from wmbench_fixtures import (HERE, params_restored,  # noqa: F401
                              small_bench, small_config)

from wmbench import run
from wmbench.lib import spec, trace
from wmbench.reference.prec import Prec

# the fixtures' reduced geometry (1038 frames, 24 s, per block) and scans
# of 8-9 s, scan 1 over 0.953-1.049: on 30 s of speech played at 0.97 the
# speed is found and the message decoded there
SHORT = {"scan1": (8, 1.003, 5, 1), "scan2": (9, 1.0015, 1, 0),
         "scan3": (9, 1.0001, 20, 0)}
KEYS = ("seconds", "step", "n_steps", "n_center_steps")


def _limits():
    with open(os.path.join(HERE, "traffic", "cd44-scan-speed.json")) as f:
        return json.load(f)["check"]["limits"]


SPEED = {"entry": "get_speed", "why": "test", "loop": "closed",
         "pool": {"files": 1, "seconds": [30, 30], "carriers": ["speech"],
                  "peaks": [1.0], "marked_share": 1.0, "speeds": [0.97],
                  "offset_seconds": [0, 3], "carrier_lead_seconds": 3},
         "check": {"sample": 1, "control": "bf16", "limits": _limits()}}


def _config():
    cfg = small_config("cd44-128-speed")
    for k, v in SHORT.items():
        cfg["get"]["scans"][k] = dict(zip(KEYS, v))
    return cfg


@pytest.fixture
def short_scans(monkeypatch, params_restored):  # noqa: F811
    from audiowmark_tpu_torch.models import speed
    for k, v in SHORT.items():
        monkeypatch.setattr(speed, k.upper(), v)


def _root(tmp_path):
    return small_bench(tmp_path, {"t-speed": (_config(), SPEED, 1,
                                              "cd44-scan-speed")})


def _run(root, trace_on=0, seed=2 ** 31 + 5):
    args = argparse.Namespace(workload="t-speed", seed=seed, seconds=0.1,
                              trace=trace_on)
    return run.run_cell(args, [torch.device("cpu")], root)


def test_speed_cell_runs_and_is_correct_on_one_card(tmp_path, short_scans,
                                                    monkeypatch):
    """Judged correct, and every speed scan of the one-device cell runs
    with AUDIOWMARK_MULTICHIP=0 (the centres then split over no other
    card), restored after each request."""
    from audiowmark_tpu_torch.ops import speed as ops
    seen = []
    scan0 = ops.speed_scan

    def scan(*args, **kw):
        seen.append(os.environ.get("AUDIOWMARK_MULTICHIP"))
        return scan0(*args, **kw)

    monkeypatch.setattr(ops, "speed_scan", scan)
    monkeypatch.setenv("AUDIOWMARK_MULTICHIP", "1")
    result, checks = _run(_root(tmp_path))
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"scan_audio_s_per_s", "setup_s"}
    assert set(checks) == set(_limits())
    assert seen and set(seen) == {"0"}
    assert os.environ["AUDIOWMARK_MULTICHIP"] == "1"


def _alter_speed(monkeypatch):
    """The detected speed moved by 1e-3 where detect_speed returns it."""
    from audiowmark_tpu_torch.models import getter
    detect0 = getter.detect_speed

    def detect(*args, **kw):
        return [(k, s + 1e-3) for k, s in detect0(*args, **kw)]

    monkeypatch.setattr(getter, "detect_speed", detect)


def _alter_message(monkeypatch):
    """Every pattern's first bit flipped where the result is made."""
    from audiowmark_tpu_torch.models import resultset
    add0 = resultset.ResultSet.add_pattern

    def add(self, key, time, q, bt, bits, err, ptype, speed):
        bits = list(bits)
        bits[0] ^= 1
        return add0(self, key, time, q, bt, bits, err, ptype, speed)

    monkeypatch.setattr(resultset.ResultSet, "add_pattern", add)


@pytest.mark.parametrize("brk,numbers", [
    (_alter_speed, ["speed_gap"]),
    (_alter_message, ["scan_mark_bit_errors", "scan_marks_missed"])])
def test_altered_answer_is_not_correct(tmp_path, short_scans, monkeypatch,
                                       brk, numbers):
    brk(monkeypatch)
    result, checks = _run(_root(tmp_path))
    assert not result["correct"]
    assert any(checks[n]["value"] > checks[n]["limit"] for n in numbers), \
        checks


def _session(root, seed=2 ** 31 + 5):
    bench = spec.benchmark(root)
    here = os.path.join(root, "wmbench")
    mix = spec.traffic("t-speed", here)
    ctx = run.Context(spec.workload(bench, "t-speed"),
                      spec.config(bench, "t-speed", root), mix, seed,
                      [torch.device("cpu")], tempfile.mkdtemp(), {})
    entry = spec.module("entries", "get_speed", here)
    with contextlib.redirect_stdout(io.StringIO()):
        session = entry.Session(ctx)
        r = run.Run("t-speed", 1, 0.1, 0.0)
        run._window(session, r, 0.1)
    return session


def test_bf16_control_fails_the_limits(tmp_path, short_scans):
    """The reference with bfloat16 stages in the program's place fails
    the cell's limits; the numbers it reads are printed beside them."""
    numbers = _session(_root(tmp_path)).control(Prec("bf16"))
    limits = _limits()
    print("bf16 control: %r" % numbers)
    assert any(numbers[k] > v for k, v in limits.items()), numbers


def test_configuration_is_held_to_the_port(monkeypatch):
    from audiowmark_tpu_torch.models import speed
    entry = spec.module("entries", "get_speed")
    with open(os.path.join(HERE, "configs", "cd44-128-speed.json")) as f:
        cfg = json.load(f)
    entry.check_speed(cfg)
    bad = json.loads(json.dumps(cfg))
    bad["get"]["scans"]["scan3"]["n_steps"] = 39
    with pytest.raises(ValueError, match="SCAN3"):
        entry.check_speed(bad)
    bad = json.loads(json.dumps(cfg))
    bad["get"]["accept_band"] = [0.999, 1.001]
    with pytest.raises(ValueError, match="ACCEPT_BAND"):
        entry.check_speed(bad)
    monkeypatch.delattr(speed, "N_BEST")      # a program without the names
    with pytest.raises(ValueError, match="N_BEST"):
        entry.check_speed(cfg)


# ---- the readers ------------------------------------------------------------

def _read(name, r):
    return spec.module("layer_metrics", name).read(r)


def _runrec(phases=None):
    r = run.Run("c", 1, 10.0, 1.0, phases=dict(phases or {}))
    r.records = [run.Request(0.0, 1.5, 10.0, True),
                 run.Request(1.5, 4.0, 20.0, True),
                 run.Request(4.0, 9.0, 0.0, False)]
    return r


@pytest.mark.parametrize("name,span", [("get_speed_share_pct", "get.speed"),
                                       ("speed_clip_share_pct",
                                        "speed.clip")])
def test_speed_shares_read_their_span(name, span):
    assert _read(name, _runrec({span: 1.0, "get.load": 2.0})) == \
        pytest.approx(25.0)
    assert _read(name, _runrec({"get.load": 2.0})) is None


def _events(span):
    """Two `span` spans on the launching thread; kernels inside (two
    overlapping, one more) and one outside."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": span, "ts": 100.0,
           "dur": 100.0, "pid": 1, "tid": 7},
          {"ph": "X", "cat": "user_annotation", "name": span, "ts": 400.0,
           "dur": 100.0, "pid": 1, "tid": 7}]
    for corr, (at, ts, dur) in enumerate(
            [(110, 150, 1000), (120, 500, 1000), (300, 2000, 500),
             (410, 3000, 250)], 1):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": float(at), "dur": 2.0,
                   "pid": 1, "tid": 7, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": "k%d" % corr,
                   "ts": float(ts), "dur": float(dur), "pid": 0, "tid": 9,
                   "args": {"correlation": corr, "device": 0}})
    return trace.from_events(ev)


def test_speed_device_time_is_the_union_of_its_kernels():
    r = _runrec()
    r.trace = _events("get.speed")
    # kernels 1, 2 (150-1500 us, once) and 4 (250 us): 1.6 ms / 30 audio-s
    assert _read("speed_device_ms_per_audio_s", r) == \
        pytest.approx(1.6 / 30.0)
    r.trace = _events("get.load")
    assert _read("speed_device_ms_per_audio_s", r) is None
    r.trace = None
    assert _read("speed_device_ms_per_audio_s", r) is None


def test_launches_per_centre_reads_the_counter(monkeypatch):
    from audiowmark_tpu_torch.utils import prof
    name = "speed_launches_per_centre"
    r = _runrec()
    r.trace = _events("get.speed")
    monkeypatch.setattr(prof, "enabled", True)
    prof.reset()
    try:
        assert _read(name, r) is None           # no counter
        prof.count("speed.centres", 2)
        assert _read(name, r) == pytest.approx(1.5)
        r.trace = _events("get.load")
        assert _read(name, r) is None           # no span
    finally:
        prof.reset()
    monkeypatch.delattr(prof, "counters")      # a program without counters
    assert _read(name, r) is None


def test_traced_speed_cell_reads_every_new_metric(tmp_path, short_scans):
    result, checks = _run(_root(tmp_path), trace_on=1)
    assert result["correct"], checks
    for name in ("get_speed_share_pct", "speed_clip_share_pct"):
        assert 0 < result["metrics"][name]["value"] <= 100.0, name
    # the CPU trace has no device kernels: the device_trace readers give
    # nothing, and the line leaves them out
    assert "speed_device_ms_per_audio_s" not in result["metrics"]

"""The per-layer metrics that read the program's own spans and counters
(utils/prof.py): each reader on a synthetic run and trace, None where the
spans or counters are absent (a program without them), and a traced CPU
run of a small add, get and fleet cell in which every such metric of the
cell reads a number."""

from __future__ import annotations

import argparse

import pytest
import torch

from wmbench_fixtures import (params_restored, small_bench,  # noqa: F401
                              small_config)
from test_wmbench_cells import FLEET, MARK, SCAN

from wmbench import run
from wmbench.lib import spec, trace

SHARES = {
    "mark_read_share_pct": ["add.read"],
    "mark_resample_share_pct": ["add.resample"],
    "mark_limiter_share_pct": ["add.limiter"],
    "mark_write_share_pct": ["add.write"],
    "get_decode_share_pct": ["get.extract", "viterbi.forward"],
    "fleet_build_share_pct": ["fleet.build"],
    "fleet_enqueue_share_pct": ["fleet.enqueue"],
}
NEW = list(SHARES) + ["resample_device_ms_per_audio_s.mark",
                      "builds_per_request"]


def _read(name, r):
    return spec.module("layer_metrics", name).read(r)


def _run(phases=None):
    """Two completed requests of 1.5 and 2.5 s (4 s of walls, 30 audio-s)
    and a failed one, which counts in no base."""
    r = run.Run("c", 1, 10.0, 1.0, phases=dict(phases or {}))
    r.records = [run.Request(0.0, 1.5, 10.0, True),
                 run.Request(1.5, 4.0, 20.0, True),
                 run.Request(4.0, 9.0, 0.0, False)]
    return r


@pytest.mark.parametrize("name", sorted(SHARES))
def test_share_reads_its_spans_over_the_walls(name):
    spans = SHARES[name]
    phases = {"get.load": 3.0, "add.embed": 3.0}
    phases.update({s: 0.5 * (i + 1) for i, s in enumerate(spans)})
    want = 100.0 * sum(0.5 * (i + 1) for i in range(len(spans))) / 4.0
    assert _read(name, _run(phases)) == pytest.approx(want)
    assert _read(name, _run({"get.load": 3.0})) is None
    assert _read(name, _run()) is None


def test_decode_share_without_a_trellis_span():
    assert _read("get_decode_share_pct",
                 _run({"get.extract": 1.0})) == pytest.approx(25.0)


def _events(span):
    """A request span, two `span` spans on the launching thread and one
    on another thread; kernels launched inside and outside them."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "wmbench.request",
           "ts": 0.0, "dur": 1000.0, "pid": 1, "tid": 7},
          {"ph": "X", "cat": "user_annotation", "name": span, "ts": 100.0,
           "dur": 100.0, "pid": 1, "tid": 7},
          {"ph": "X", "cat": "user_annotation", "name": span, "ts": 400.0,
           "dur": 100.0, "pid": 1, "tid": 7},
          {"ph": "X", "cat": "user_annotation", "name": span, "ts": 600.0,
           "dur": 100.0, "pid": 1, "tid": 8}]
    # (launch ts, launch tid, kernel ts, dur): the first two overlap on the
    # card and count once; the third is launched outside every span; the
    # fourth inside the second span; the fifth on a thread whose only span
    # is elsewhere in time
    for corr, (at, tid, ts, dur) in enumerate(
            [(110, 7, 150, 1000), (120, 7, 500, 1000), (300, 7, 2000, 500),
             (410, 7, 3000, 250), (450, 8, 4000, 700)], 1):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": float(at), "dur": 2.0,
                   "pid": 1, "tid": tid, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": "k%d" % corr,
                   "ts": float(ts), "dur": float(dur), "pid": 0, "tid": 9,
                   "args": {"correlation": corr, "device": 0}})
    return ev


def test_resample_device_time_is_the_union_of_its_kernels():
    name = "resample_device_ms_per_audio_s.mark"
    r = _run()
    r.trace = trace.from_events(_events("add.resample"))
    # kernels 1, 2 (150-1500 us, once) and 4 (250 us): 1.6 ms / 30 audio-s
    assert _read(name, r) == pytest.approx(1.6 / 30.0)
    r.trace = trace.from_events(_events("add.embed"))
    assert _read(name, r) is None
    r.trace = None
    assert _read(name, r) is None


def test_builds_per_request_reads_the_counters(monkeypatch):
    from audiowmark_tpu_torch.utils import prof
    monkeypatch.setattr(prof, "enabled", True)
    prof.reset()
    try:
        prof.count("build.detector", 4)
        prof.count("build.key_tables")
        prof.count("other", 7)
        assert _read("builds_per_request", _run()) == pytest.approx(2.5)
        prof.reset()
        assert _read("builds_per_request", _run()) == 0.0
    finally:
        prof.reset()
    monkeypatch.delattr(prof, "counters")     # a program without counters
    assert _read("builds_per_request", _run()) is None


def _cells():
    return {"t-scan": (small_config("cd44-128"), SCAN, 1, "cd44-scan"),
            "t-fleet": (small_config("cd44-128"), FLEET, 1,
                        "fleet44-x4-scan"),
            "t-mark48": (small_config("video48-128"), MARK, 1,
                         "video48-mark")}


@pytest.mark.parametrize("cell", ["t-scan", "t-mark48", "t-fleet"])
def test_traced_cpu_cell_reads_every_program_metric(tmp_path,
                                                    params_restored, cell):
    root = small_bench(tmp_path, _cells())
    bench = spec.benchmark(root)
    listed = [m["name"] for m in spec.per_layer(bench, cell)
              if m["name"] in NEW and m["source"] == "program_span"]
    assert listed
    args = argparse.Namespace(workload=cell, seed=2 ** 31 + 11,
                              seconds=0.1, trace=1)
    result, checks = run.run_cell(args, [torch.device("cpu")], root)
    assert result["correct"], checks
    for name in listed:
        value = result["metrics"][name]["value"]
        assert value >= 0, name
        if name.endswith("_pct"):
            assert value <= 100.0, name

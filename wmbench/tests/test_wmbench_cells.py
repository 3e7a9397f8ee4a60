"""A run of each entry on the CPU at the reduced geometry, through the
harness's own run_cell: its answers judged correct, and judged wrong with
the timed path broken underneath (an answer altered where it is made)."""

from __future__ import annotations

import argparse
import io

import numpy as np
import pytest
import torch

from wmbench_fixtures import (params_restored, small_bench,  # noqa: F401
                              small_config)

SCAN = {"entry": "get", "why": "test", "loop": "closed",
        "pool": {"files": 3, "seconds": [27, 33], "carriers": ["music",
                                                              "speech",
                                                              "chords"],
                 "peaks": [0.6, 1.0], "marked_share": 0.67,
                 "offset_seconds": [0, 20], "carrier_lead_seconds": 5},
        "check": {"sample": 1, "control": "tf32",
                  "limits": {"scan_quality_gap": 2e-3,
                             "scan_error_gap": 1e-3, "scan_unmatched": 0,
                             "scan_mark_bit_errors": 0,
                             "scan_marks_missed": 0}}}
MARK = {"entry": "add", "why": "test", "loop": "closed",
        "pool": {"files": 2, "seconds": [4, 6], "carriers": ["music",
                                                            "chords"],
                 "peaks": [0.6, 1.0], "carrier_lead_seconds": 2},
        "check": {"sample": 1, "control": "bf16",
                  "limits": {"mark_lsb_max": 1, "mark_lsb_share": 0.005}}}


FLEET = {"entry": "detect_batch", "why": "test", "loop": "closed",
         "pool": {"streams": 4, "seconds": 30, "carriers": ["music",
                                                           "chords"],
                  "peaks": [0.6, 1.0], "marked_share": 0.5,
                  "offset_seconds": [0, 5], "carrier_lead_seconds": 3},
         "batch": 4, "top_k": 8,
         "check": {"sample": 1, "streams_per_card": 2, "control": "tf32",
                   "limits": dict(SCAN["check"]["limits"],
                                  fleet_ineligible=0)}}


def _cells():
    return {"t-scan": (small_config("cd44-128"), SCAN, 1, "cd44-scan"),
            "t-fleet": (small_config("cd44-128"), FLEET, 1, "cd44-scan"),
            "t-mark44": (small_config("cd44-128"), MARK, 1, "video48-mark"),
            "t-mark48": (small_config("video48-128"), MARK, 1,
                         "video48-mark")}


def _run(root, cell, seed=2 ** 31 + 7, seconds=0.1):
    from wmbench import run
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=0)
    return run.run_cell(args, [torch.device("cpu")], root)


@pytest.mark.parametrize("cell", ["t-scan", "t-mark44", "t-mark48",
                                  "t-fleet"])
def test_cell_runs_and_is_correct(tmp_path, params_restored, cell):
    root = small_bench(tmp_path, _cells())
    result, checks = _run(root, cell)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert "setup_s" in result["metrics"]
    assert list(result)[-1] == "checks"


def _break_mark(monkeypatch):
    """A sample altered where the writer encodes it."""
    from audiowmark_tpu_torch.io import wavfile
    write0 = wavfile.WavFileWriter.write_frames

    def write(self, samples):
        s = np.array(samples, copy=True)
        if s.size:
            s[s.size // 2] = s[s.size // 2] + (2000 if s.dtype == np.int16
                                               else 0.06)
        return write0(self, s)

    monkeypatch.setattr(wavfile.WavFileWriter, "write_frames", write)


def _break_scan(monkeypatch):
    """Every pattern's decode error altered where the result is made."""
    from audiowmark_tpu_torch.models import resultset
    add0 = resultset.ResultSet.add_pattern

    def add(self, key, time, q, bt, bits, err, ptype, speed):
        return add0(self, key, time, q, bt, bits, err + 0.01, ptype, speed)

    monkeypatch.setattr(resultset.ResultSet, "add_pattern", add)


def _break_fleet(monkeypatch):
    """Half of each batch left out: its second half's answers are the
    first half's."""
    from audiowmark_tpu_torch import parallel
    detect0 = parallel.detect_batch

    def detect(key, audio, **kw):
        half = audio.shape[0] // 2
        out = detect0(key, audio[:half], **kw)
        return {k: np.concatenate([v, v]) for k, v in out.items()}

    monkeypatch.setattr(parallel, "detect_batch", detect)


@pytest.mark.parametrize("cell,brk", [("t-scan", _break_scan),
                                      ("t-fleet", _break_fleet),
                                      ("t-mark44", _break_mark),
                                      ("t-mark48", _break_mark)])
def test_broken_answer_is_not_correct(tmp_path, params_restored,
                                      monkeypatch, cell, brk):
    root = small_bench(tmp_path, _cells())
    brk(monkeypatch)
    result, checks = _run(root, cell)
    assert not result["correct"], checks


def test_a_cell_added_as_files_alone_runs(tmp_path, params_restored):
    """A new traffic file and a BENCHMARK.json entry, no code."""
    mix = dict(MARK, pool=dict(MARK["pool"], seconds=[3, 3.5], files=1))
    root = small_bench(tmp_path, {"t-new": (small_config("cd44-128"), mix,
                                            1, "video48-mark")})
    result, _ = _run(root, "t-new")
    assert result["correct"]
    assert set(result["metrics"]) == {"mark_audio_s_per_s", "setup_s"}

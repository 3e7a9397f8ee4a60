"""The port's profile hooks: AUDIOWMARK_PROFILE=<dir> around a whole
command (a torch.profiler Chrome trace in the directory, the program's
spans in it) and the tracer of utils/prof.py: its spans, as wall time and
as annotations of a recording trace, and its counters.  On the CPU the
trace holds host events only; tests/test_torch_cuda.py and chip_smoke.py
look for the kernel's event on the card.
"""

import glob
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from audiowmark_tpu.utils import prof as j_prof
from audiowmark_tpu_torch import cli as t_cli
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.params import Params as TParams
from audiowmark_tpu_torch.utils import prof

torch.set_num_threads(2)
MSG = "f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0"


@pytest.fixture(autouse=True)
def cpu_port(monkeypatch):
    monkeypatch.setenv("AUDIOWMARK_TORCH_DEVICE", "cpu")
    TParams.reset()
    prof.reset()
    yield
    TParams.reset()
    prof.reset()
    prof.enabled = False


@pytest.fixture(scope="module")
def marked(tmp_path_factory):
    """80 s of seeded noise marked at the reduced geometry (30 sync frames
    per bit, 1 frame per bit)."""
    os.environ["AUDIOWMARK_TORCH_DEVICE"] = "cpu"
    d = tmp_path_factory.mktemp("profile")
    rng = np.random.RandomState(3)
    WavData(((rng.rand(80 * 44100 * 2) * 2 - 1) * 0.5).astype(np.float32), 2,
            44100, 16).save(str(d / "n.wav"))
    _geometry()
    assert t_cli.main(["add", str(d / "n.wav"), str(d / "wm.wav"), MSG]) == 0
    TParams.reset()
    del os.environ["AUDIOWMARK_TORCH_DEVICE"]
    return str(d / "wm.wav")


def _geometry():
    TParams.reset()
    TParams.sync_frames_per_bit = 30
    TParams.frames_per_bit = 1


def test_profile_env_writes_a_trace_that_parses(marked, tmp_path,
                                                monkeypatch, capsys):
    out = tmp_path / "trace"
    monkeypatch.setenv("AUDIOWMARK_PROFILE", str(out))
    _geometry()
    assert t_cli.main(["cmp", marked, MSG, "--expect-matches", "5"]) == 0
    assert "match_count 5 " in capsys.readouterr().out
    files = glob.glob(str(out / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert len(trace["traceEvents"]) > 100
    assert any(n and "fft" in n for n in names)


def test_profile_keeps_the_commands_exit_code(marked, tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.setenv("AUDIOWMARK_PROFILE", str(tmp_path / "t"))
    _geometry()
    assert t_cli.main(["cmp", marked, MSG, "--expect-matches", "4"]) == 1
    assert glob.glob(str(tmp_path / "t" / "*.json"))
    assert t_cli.main(["--version"]) == 0
    capsys.readouterr()


def test_profile_dir_that_cannot_be_used(tmp_path, monkeypatch, capsys):
    """The JAX command line's two messages: the trace cannot start (the
    directory cannot be made), the trace cannot be written."""
    blocker = tmp_path / "file"
    blocker.write_text("x")
    monkeypatch.setenv("AUDIOWMARK_PROFILE", str(blocker / "sub"))
    capsys.readouterr()
    assert t_cli.main(["--version"]) == 1
    cap = capsys.readouterr()
    assert "cannot start profiler trace in '%s'" % (blocker / "sub") \
        in cap.err and "audiowmark " not in cap.out

    target = tmp_path / "gone"
    monkeypatch.setenv("AUDIOWMARK_PROFILE", str(target))
    real = t_cli._main

    def remove_dir_then_run(argv):
        os.rmdir(target)
        target.write_text("now a file")
        return real(argv)

    monkeypatch.setattr(t_cli, "_main", remove_dir_then_run)
    assert t_cli.main(["--version"]) == 1
    assert "failed to write profiler trace to '%s'" % target \
        in capsys.readouterr().err


def test_no_profile_env_no_profiler(monkeypatch, capsys):
    monkeypatch.delenv("AUDIOWMARK_PROFILE", raising=False)
    import torch.profiler
    monkeypatch.setattr(torch.profiler, "profile", None)
    assert t_cli.main(["--version"]) == 0
    capsys.readouterr()


def test_prof_phase_totals_and_copy_parity():
    """prof.phase adds up wall time and counts per name when enabled and
    does nothing when not; the copy reports as the JAX package's does."""
    for mod in (prof, j_prof):
        mod.reset()
        mod.enabled = False
        with mod.phase("idle"):
            pass
        assert mod.report() == {}
        mod.enabled = True
        for _ in range(2):
            with mod.phase("a"):
                time.sleep(0.02)
        with pytest.raises(KeyError):
            with mod.phase("b"):
                raise KeyError("x")
        mod.enabled = False
        rep = mod.report()
        assert list(rep) == ["a", "b"] and rep["a"]["n"] == 2 \
            and rep["b"]["n"] == 1
        assert 0.04 <= rep["a"]["s"] < 0.5
        mod.reset()
        assert mod.report() == {}


def test_get_path_phases(marked, capsys, monkeypatch):
    """A two-chunk get with the prefetch thread: load, load_join, the
    block and clip searches."""
    _geometry()
    TParams.get_chunk_size = 1.25
    monkeypatch.setenv("AUDIOWMARK_PREFETCH", "1")
    prof.enabled = True
    from audiowmark_tpu_torch import get_watermark
    from audiowmark_tpu_torch.crypto.keys import Key
    assert get_watermark([Key()], marked, MSG, device="cpu") == 0
    capsys.readouterr()
    rep = prof.report()
    assert rep["get.load"]["n"] == 1            # chunk 1, on the main thread
    assert rep["get.load_join"]["n"] == 2       # chunk 2 and the stream's end
    assert rep["get.search_block"]["n"] == 2
    assert "get.search_group" not in rep        # one device: no groups


def test_disabled_phase_is_one_shared_object_and_records_nothing():
    prof.enabled = False
    spans = {id(prof.phase(n)) for n in ("a", "b", "get.load")}
    assert len(spans) == 1
    with prof.phase("a"):
        with prof.phase("b"):
            pass
    prof.count("build.x")
    assert prof.report() == {} and not prof.totals and not prof.counters


def test_count_and_reset():
    prof.enabled = True
    prof.count("build.a")
    prof.count("build.a", 2)
    prof.count("build.b")
    with prof.phase("s"):
        pass
    assert dict(prof.counters) == {"build.a": 3, "build.b": 1}
    prof.enabled = False
    prof.count("build.a", 5)                 # disabled: not counted
    assert prof.counters["build.a"] == 3
    prof.reset()
    assert not prof.counters and not prof.totals and not prof.counts


def _annotations(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def _inside(inner, outer):
    return (inner["tid"] == outer["tid"] and inner["ts"] >= outer["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _trace(fn, path):
    """fn() under a CPU torch.profiler trace of every thread (the command
    line's setting) with the spans on; the trace's annotations."""
    from torch.profiler import ProfilerActivity, profile
    prof.enabled = True
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=t_cli._all_threads()) as p:
            fn()
    finally:
        prof.enabled = False
    p.export_chrome_trace(str(path))
    return _annotations(str(path))


def test_enabled_spans_are_annotations_that_nest(tmp_path):
    """Spans are user_annotation events of a recording trace, the inner
    inside the outer on the thread that ran them, also on a thread of
    their own; their wall time is also in totals."""
    def spans():
        with prof.phase("outer"):
            with prof.phase("inner"):
                torch.ones(8).sum()
            t = threading.Thread(target=thread_spans)
            t.start()
            t.join()

    def thread_spans():
        with prof.phase("thread.outer"):
            with prof.phase("thread.inner"):
                torch.ones(8).sum()

    ann = {e["name"]: e for e in _trace(spans, tmp_path / "t.json")}
    assert {"outer", "inner", "thread.outer", "thread.inner"} <= set(ann)
    assert _inside(ann["inner"], ann["outer"])
    assert _inside(ann["thread.inner"], ann["thread.outer"])
    assert ann["thread.outer"]["tid"] != ann["outer"]["tid"]
    assert prof.counts["outer"] == prof.counts["thread.inner"] == 1
    assert prof.totals["outer"] >= prof.totals["inner"] > 0


def test_get_spans_nest_on_the_prefetch_thread(marked, tmp_path, capsys,
                                               monkeypatch):
    """A two-chunk get with the prefetch thread under a trace: the first
    chunk's reads inside get.load on the main thread, the second chunk's on
    the prefetch thread, outside any get.* span there; get.extract and
    viterbi.forward siblings on the main thread."""
    _geometry()
    TParams.get_chunk_size = 1.25
    monkeypatch.setenv("AUDIOWMARK_PREFETCH", "1")
    from audiowmark_tpu_torch import get_watermark
    from audiowmark_tpu_torch.crypto.keys import Key
    ann = _trace(lambda: get_watermark([Key()], marked, MSG, device="cpu"),
                 tmp_path / "t.json")
    capsys.readouterr()
    by = {}
    for e in ann:
        by.setdefault(e["name"], []).append(e)
    main = by["get.load"][0]["tid"]
    reads = by["load.read"]
    on_main = [r for r in reads if r["tid"] == main]
    on_thread = [r for r in reads if r["tid"] != main]
    assert on_main and on_thread
    assert all(_inside(r, by["get.load"][0]) for r in on_main)
    assert not any(_inside(r, g) for r in on_thread
                   for n, es in by.items() if n.startswith("get.")
                   for g in es)
    for name in ("get.extract", "viterbi.forward", "get.report",
                 "get.search_block", "get.load_join", "get.upload"):
        assert name in by, name
    decode = by["get.extract"] + by["viterbi.forward"]
    assert not any(_inside(a, b) for a in decode for b in decode
                   if a is not b)


def test_profile_env_trace_holds_the_program_spans(marked, tmp_path,
                                                   monkeypatch, capsys):
    """AUDIOWMARK_PROFILE on a cmp: the trace holds the get's spans as
    annotations, and the spans are off again after the command."""
    out = tmp_path / "trace"
    monkeypatch.setenv("AUDIOWMARK_PROFILE", str(out))
    _geometry()
    assert t_cli.main(["cmp", marked, MSG, "--expect-matches", "5"]) == 0
    capsys.readouterr()
    assert prof.enabled is False
    names = {e["name"] for e in _annotations(glob.glob(str(out /
                                                            "*.json"))[0])}
    assert {"get.load", "get.extract", "viterbi.forward"} <= names


def test_spans_and_counters_from_many_threads_lose_nothing():
    """Spans end and counters count on several threads at once (the get's
    prefetch thread beside the main one): no update is lost."""
    import sys
    prof.enabled = True
    n_threads, n = 16, 400

    def work():
        for _ in range(n):
            with prof.phase("load.read"):
                pass
            prof.count("build.x")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        prof.enabled = False
    assert prof.counts["load.read"] == n_threads * n
    assert prof.counters["build.x"] == n_threads * n

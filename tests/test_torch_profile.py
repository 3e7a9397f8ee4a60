"""The port's profile hooks: AUDIOWMARK_PROFILE=<dir> around a whole
command (a torch.profiler Chrome trace in the directory) and the
wall-clock phases of utils/prof.py in the get path.  On the CPU the trace
holds host events only; tests/test_torch_cuda.py and chip_smoke.py look
for the kernel's event on the card.
"""

import glob
import json
import os
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

"""Fixtures of the benchmark's own tests, imported by name so that no
file here shares a name with the repository's tests/: a copy of the
benchmark's files with a BENCHMARK.json of small CPU cells (the reduced
geometry of the port's mode tests: 30 sync frames per bit, 1 frame per
bit, so a block is 24 s), and the card's presence decided inside a
fixture."""

from __future__ import annotations

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

SMALL = {"sync_frames_per_bit": 30, "frames_per_bit": 1}


def small_bench(tmp_path, cells):
    """A checkout-like directory: wmbench/ copied, configs and traffic of
    `cells` ({name: (config, traffic, chips, like)}) added, BENCHMARK.json
    made from the real one with these cells, each reporting the metrics
    of the real cell `like`."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "wmbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"] = []
    for name, (cfg, mix, chips, like) in cells.items():
        (root / "wmbench" / "configs" / (name + ".json")).write_text(
            json.dumps(cfg))
        (root / "wmbench" / "traffic" / (name + ".json")).write_text(
            json.dumps(mix))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": "wmbench/configs/%s.json" % name,
                                 "reduced": list(SMALL), "why": "test"})
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": name, "chips": chips,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def small_config(base: str, **audio):
    with open(os.path.join(HERE, "configs", base + ".json")) as f:
        cfg = json.load(f)
    cfg["watermark"].update(SMALL)
    cfg["audio"].update(audio)
    return cfg


@pytest.fixture
def cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def params_restored():
    from audiowmark_tpu_torch.params import Params
    from audiowmark_tpu_torch.utils.log import Log, set_log_level
    yield
    Params.reset()
    set_log_level(Log.INFO)

"""The harness's contract with BENCHMARK.json, its imports, and its
arithmetic on synthetic inputs."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from wmbench_fixtures import HERE, ROOT

from wmbench.lib import spec, stats, trace, vitwork

E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _bench():
    return spec.benchmark(ROOT)


def test_names_units_and_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]] \
        + [w["name"] for w in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert spec.NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        keys = E2E_KEYS if m in b["end_to_end"] else LAYER_KEYS
        assert set(m) - {"workloads"} == keys, m["name"]
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(spec.NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for text in [c["why"] for c in b["configs"]] \
            + [w["why"] for w in b["workloads"]] \
            + [c["source"] for c in b["configs"]] \
            + [m["layer"] for m in b["per_layer"]] + b["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text
    assert sum(w["chips"] == 4 for w in b["workloads"]) \
        <= max(1, len(b["workloads"]) // 4)
    assert len(json.dumps(b)) < 64 * 1024


def test_everything_is_found_by_name():
    b = _bench()
    for w in b["workloads"]:
        cfg = spec.config(b, w["config"])
        mix = spec.traffic(w["traffic"])
        assert os.path.exists(os.path.join(HERE, "entries",
                                           mix["entry"] + ".py"))
        assert cfg["watermark"] and mix["check"]["limits"]
        e2e = spec.end_to_end(b, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert spec.per_layer(b, w["name"])
    for m in b["end_to_end"]:
        assert hasattr(spec.module("end_to_end", m["name"]), "read")
    for m in b["per_layer"]:
        assert hasattr(spec.module("layer_metrics", m["name"]), "read")
        for w in m.get("workloads", ()):
            assert m["moves"] in {e["name"] for e in spec.end_to_end(b, w)}


def _imports(path: str):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                top = mod.split(".")[0]
                assert top not in ("audiowmark_tpu_torch", "audiowmark_tpu",
                                   "jax", "wmbench"), (f, mod)
    code = ("import sys, wmbench.reference.scan, wmbench.reference.mark, "
            "wmbench.reference.judge; print(sorted({m.split('.')[0] for m "
            "in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip()))
    assert not loaded & {"audiowmark_tpu_torch", "audiowmark_tpu", "jax"}


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    """A whole CPU run of a small cell in a fresh process: no loaded module
    has the top-level name jax, jaxlib, flax or audiowmark_tpu (compared
    whole: audiowmark_tpu_torch is the port)."""
    code = r'''
import argparse, pathlib, sys, torch
sys.path.insert(0, "wmbench/tests")
from wmbench_fixtures import small_bench, small_config
from test_wmbench_cells import MARK
from wmbench import run
root = small_bench(pathlib.Path(sys.argv[1]), {"t": (
    small_config("cd44-128"), MARK, 1, "video48-mark")})
args = argparse.Namespace(workload="t", seed=5, seconds=0.1, trace=0)
result, _ = run.run_cell(args, [torch.device("cpu")], root)
assert result["correct"]
print(sorted({m.split(".")[0] for m in sys.modules}))
'''
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                       capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(ast.literal_eval(p.stdout.strip().splitlines()[-1]))
    assert "audiowmark_tpu_torch" in loaded
    assert not loaded & set(("jax", "jaxlib", "flax", "audiowmark_tpu"))


def test_no_old_benchmark_file_is_read():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py") and "tests" not in dirpath:
                text = open(os.path.join(dirpath, f)).read()
                assert not re.search(r"BENCH_r0|MULTICHIP_r0|bench\.py|"
                                     r"BASELINE\.", text), f


def test_interval_union_per_card():
    ev = [{"cat": "kernel", "name": "k1", "ts": 0.0, "dur": 10.0,
           "args": {"device": 0}},
          {"cat": "kernel", "name": "k2", "ts": 5.0, "dur": 10.0,
           "args": {"device": 0}},
          {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 30.0,
           "dur": 5.0, "args": {"device": 0}},
          {"cat": "kernel", "name": "k1", "ts": 0.0, "dur": 4.0,
           "args": {"device": 1}}]
    busy, per_name = trace.busy_intervals(ev)
    assert busy == {0: 20e-6, 1: 4e-6}
    assert per_name["k1"] == pytest.approx(14e-6)


def test_all_request_percentile():
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == pytest.approx(np.percentile(v, 95))
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1.0, 2.0], 50) == 1.5


def test_viterbi_work_count():
    # 24 rows of a rate-6 code, 143 steps: (3 * 6 + 2) ops per state-step
    assert vitwork.ops(24, 143, 6) == 24 * 143 * 32768 * 20
    assert vitwork.bytes_moved(1, 143, 12) == 143 * 12 * 4 + 143 * 4 + 4
    least = vitwork.least_seconds(vitwork.ops(24, 143, 6),
                                  vitwork.bytes_moved(24, 143, 6),
                                  67e12, 3.35e12)
    assert least == pytest.approx(24 * 143 * 32768 * 20 / 67e12)


def test_kernels_inside_spans_and_idle_gaps():
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "wmbench.viterbi",
         "ts": 100.0, "dur": 50.0, "pid": 1, "tid": 7},
        {"ph": "X", "cat": "user_annotation", "name": "wmbench.request",
         "ts": 0.0, "dur": 400.0, "pid": 1, "tid": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 110.0, "dur": 2.0, "pid": 1, "tid": 7,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 200.0, "dur": 2.0, "pid": 1, "tid": 7,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "viterbi_acs", "ts": 120.0,
         "dur": 30.0, "pid": 0, "tid": 9,
         "args": {"correlation": 1, "device": 0}},
        {"ph": "X", "cat": "kernel", "name": "fft", "ts": 210.0,
         "dur": 10.0, "pid": 0, "tid": 9,
         "args": {"correlation": 2, "device": 0}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 160.0,
         "dur": 30.0, "pid": 1, "tid": 7},
    ]
    t = trace.from_events(events)
    ks = trace.kernels_in_spans(t, "wmbench.viterbi")
    assert [k["name"] for k in ks] == ["viterbi_acs"]
    gaps = trace.idle_gaps(t)
    assert gaps == [["wmbench.request / aten::copy_", 60e-6]]

"""BENCHMARK.json and the files it names, found by name.

A cell (`workloads` entry) names its configuration, whose file the
`configs` entry gives, and its traffic mix, `wmbench/traffic/<traffic>.json`;
the mix names its entry point, `wmbench/entries/<entry>.py`; a per-layer
metric is read by `wmbench/layer_metrics/<metric>.py`.  Modules are loaded
from their paths, so a name may hold dots and dashes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "wmbench")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def benchmark(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _one(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError("BENCHMARK.json has no %s named %r" % (what, name))


def workload(bench: Dict, name: str) -> Dict:
    return _one(bench["workloads"], name, "workload")


def config(bench: Dict, name: str, root: str = ROOT) -> Dict:
    with open(os.path.join(root, _one(bench["configs"], name,
                                      "config")["file"])) as f:
        return json.load(f)


def traffic(name: str, here: str = HERE) -> Dict:
    with open(os.path.join(here, "traffic", name + ".json")) as f:
        return json.load(f)


_modules: Dict[str, object] = {}


def module(kind: str, name: str, here: str = HERE):
    """wmbench/<kind>/<name>.py, loaded once."""
    path = os.path.join(here, kind, name + ".py")
    mod = _modules.get(path)
    if mod is None:
        if not NAME.match(name):
            raise ValueError("not a name: %r" % name)
        spec = importlib.util.spec_from_file_location(
            "wmbench_%s_%s" % (kind, re.sub(r"\W", "_", name)), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return mod


def reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: Dict, cell: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if reports(m, cell)]


def per_layer(bench: Dict, cell: str) -> List[Dict]:
    """The cell's per-layer metrics: those that list it, and those with no
    list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]

"""The control: the plain reference in the precision below the
configuration's float32, put in the program's place, fails each cell's
limits: bfloat16 stages, on the CPU at the reduced geometry and on the
card (marker `cuda`).  TF32 matrix products do not fail them: the port's
only float32 products take 0/1 matrices, and TF32 moves their results by
less than float32's own spectra do (PERF.md, "What decides correct").  The
card's runs at the cells' own sizes are
`python3 -m wmbench.readings --control tf32,bf16`."""

from __future__ import annotations

import contextlib
import io
import json
import os
import tempfile

import pytest
import torch

from wmbench_fixtures import (HERE, cuda, params_restored,  # noqa: F401
                              small_bench, small_config)
from test_wmbench_cells import FLEET, MARK, SCAN

from wmbench import run
from wmbench.lib import spec
from wmbench.reference.prec import Prec

REAL = {"t-scan": "cd44-scan", "t-fleet": "fleet44-x4-scan",
        "t-mark44": "video48-mark", "t-mark48": "video48-mark"}


def _limits(real: str):
    with open(os.path.join(HERE, "traffic", real + ".json")) as f:
        return json.load(f)["check"]["limits"]


def _control(tmp_path, cell, prec, device):
    cells = {"t-scan": (small_config("cd44-128"), SCAN, 1, "cd44-scan"),
             "t-fleet": (small_config("cd44-128"), FLEET, 1, "cd44-scan"),
             "t-mark44": (small_config("cd44-128"), MARK, 1, "video48-mark"),
             "t-mark48": (small_config("video48-128"), MARK, 1,
                          "video48-mark")}
    root = small_bench(tmp_path, {cell: cells[cell]})
    bench = spec.benchmark(root)
    w = spec.workload(bench, cell)
    mix = spec.traffic(cell, os.path.join(root, "wmbench"))
    ctx = run.Context(w, spec.config(bench, cell, root), mix, 2 ** 31 + 99,
                      [device], tempfile.mkdtemp(), {})
    entry = spec.module("entries", mix["entry"], os.path.join(root,
                                                              "wmbench"))
    with contextlib.redirect_stdout(io.StringIO()):
        session = entry.Session(ctx)
        r = run.Run(cell, 1, 0.1, 0.0)
        run._window(session, r, 0.1)
    return session.control(Prec(prec))


@pytest.mark.parametrize("cell", ["t-scan", "t-mark44", "t-mark48",
                                  "t-fleet"])
def test_bf16_control_fails(tmp_path, params_restored, cell):
    numbers = _control(tmp_path, cell, "bf16", torch.device("cpu"))
    limits = _limits(REAL[cell])
    assert any(numbers[k] > v for k, v in limits.items()), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["t-scan", "t-mark44", "t-mark48",
                                  "t-fleet"])
def test_bf16_control_fails_on_the_card(tmp_path, params_restored, cuda,
                                        cell):
    numbers = _control(tmp_path, cell, "bf16", cuda)
    limits = _limits(REAL[cell])
    assert any(numbers[k] > v for k, v in limits.items()), numbers

"""Run one cell of BENCHMARK.json once.

    python3 -m wmbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (process start, torch and the card, the entry's inputs made from
the seed, warm-up) is `setup_s`; then one client sends the entry's
requests back to back for `--seconds` (a request started before the end
runs to its end, and the window closes with it); then the peak memory is
read, the program's state freed, and a sample of the window's answers is
judged against the plain reference (wmbench/reference/).  With --trace 1
the window runs under torch.profiler and the per-layer metrics are read
from its trace; with --trace 0 the end-to-end metrics are printed.

The last line of standard output is one JSON object; the last lines of
standard error give each compared number beside its limit.  Exit codes:
0 a result was printed (a request that failed counts in `failed` and
makes `correct` false); 3 no CUDA card, or fewer than the cell needs; 4 a
module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


def _process_start() -> float:
    """Wall time at which this process started (/proc), to 10 ms."""
    try:
        with open("/proc/self/stat") as f:
            after = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - int(after[19])
                              / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


_STARTED = _process_start()

from .lib import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "audiowmark_tpu")


@dataclass
class Request:
    start: float
    end: float
    audio_s: float
    ok: bool


@dataclass
class Run:
    """What a run measured, for the metric readers."""

    cell: str
    chips: int
    seconds: float
    setup_s: float
    records: List[Request] = field(default_factory=list)
    window_s: float = 0.0
    trace: Optional[object] = None
    phases: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, list] = field(default_factory=dict)
    untraced: List[Request] = field(default_factory=list)

    def done(self) -> List[Request]:
        return [r for r in self.records if r.ok]

    def audio_s(self) -> float:
        return sum(r.audio_s for r in self.done())


@dataclass
class Context:
    """What an entry's session is given."""

    cell: Dict
    config: Dict
    traffic: Dict
    seed: int
    devices: list
    tmpdir: str
    counters: Dict[str, list]


class _Sink(io.TextIOBase):
    """Standard output during a request: the program's report lines are
    its output to the caller, kept nowhere."""

    def write(self, s):
        return len(s)


def _cache_dirs() -> None:
    """Build and kernel caches inside the checkout, at fixed paths."""
    base = os.path.join(spec.ROOT, ".wmbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def _power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
        return "; ".join(ln.strip() for ln in out.splitlines() if ln.strip())
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _window(session, run: Run, seconds: float) -> None:
    """Requests back to back; the window closes with the first request
    that ends after `seconds`."""
    from torch.profiler import record_function
    sink = _Sink()
    t0 = time.perf_counter()
    i = 0
    real_stdout = sys.stdout
    while time.perf_counter() - t0 < seconds:
        s = time.perf_counter()
        sys.stdout = sink
        try:
            with record_function("wmbench.request"):
                audio_s, ok = session.request(i)
        except Exception as e:            # counted, reported, not timed
            sys.stdout = real_stdout
            print("request %d failed: %r" % (i, e), file=sys.stderr)
            audio_s, ok = 0.0, False
        finally:
            sys.stdout = real_stdout
        run.records.append(Request(s, time.perf_counter(), audio_s, ok))
        i += 1
    run.window_s = time.perf_counter() - t0


def _traced_window(session, run: Run, seconds: float, traced: float,
                   tmpdir: str) -> None:
    """The window's first `traced` seconds under torch.profiler (a cell
    whose trace would be too large to read within a run's time traces
    only that part); the rest of the window runs untraced, so the run
    lasts as long as any other.  `run` gets the traced part."""
    from torch.profiler import ProfilerActivity, profile
    from .lib import trace as tr
    from audiowmark_tpu_torch.utils import prof as phases
    phases.reset()
    phases.enabled = True
    t0 = time.perf_counter()
    with session.spans():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            _window(session, run, min(seconds, traced))
    phases.enabled = False
    run.phases = dict(phases.totals)
    rest = Run(run.cell, run.chips, seconds, run.setup_s)
    if seconds > time.perf_counter() - t0:
        _window(session, rest, seconds - (time.perf_counter() - t0))
    run.untraced = rest.records
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    t1 = time.perf_counter()
    try:
        p.export_chrome_trace(path)
        size = os.path.getsize(path)
        run.trace = tr.load(path)
    finally:
        tr.remove(path)
    print("wmbench: trace of %d bytes, %d device events, read in %.1f s"
          % (size, len(run.trace.device), time.perf_counter() - t1),
          file=sys.stderr)


def _metrics(names: List[Dict], run: Run, kind: str, here: str) -> Dict:
    out = {}
    for m in names:
        value = spec.module(kind, m["name"], here).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    _cache_dirs()
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print("wmbench: the cell needs %d CUDA card(s); this machine has %d"
              % (cell["chips"], have), file=sys.stderr)
        return 3
    result, checks = run_cell(args, [torch.device("cuda", i)
                                     for i in range(cell["chips"])])
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if loaded:
        print("wmbench: the run loaded %s" % ", ".join(loaded),
              file=sys.stderr)
        return 4
    for k, c in checks.items():
        print("check %s %r limit %r" % (k, c["value"], c["limit"]),
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def run_cell(args, devices, root: str = spec.ROOT):
    """Set-up, window and check of one cell on `devices`; returns (the
    result's object, the checks).  The tests call it on the CPU with a
    BENCHMARK.json of their own under `root`."""
    import torch
    here = os.path.join(root, "wmbench")
    bench = spec.benchmark(root)
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(bench, cell["config"], root)
    mix = spec.traffic(cell["traffic"], here)
    cuda = devices[0].type == "cuda"
    entry = spec.module("entries", mix["entry"], here)
    tmpdir = tempfile.mkdtemp(prefix="wmbench-")
    counters: Dict[str, list] = {}
    try:
        ctx = Context(cell, cfg, mix, args.seed, devices, tmpdir, counters)
        with contextlib.redirect_stdout(_Sink()):
            session = entry.Session(ctx)
        gc.collect()
        gc.freeze()         # the set-up's objects leave the collector's scans
        run = Run(args.workload, len(devices), args.seconds,
                  time.time() - _STARTED, counters=counters)
        if args.trace:
            _traced_window(session, run, args.seconds,
                           mix.get("trace_seconds", args.seconds), tmpdir)
        else:
            _window(session, run, args.seconds)
        peak = 0
        if cuda:
            for d in devices:
                torch.cuda.synchronize(d)
            peak = max(torch.cuda.max_memory_allocated(d) for d in devices)
        session.release()
        from .reference.prec import Prec
        numbers = session.check(Prec("f64"))
    finally:
        import shutil
        shutil.rmtree(tmpdir, ignore_errors=True)

    lat = sorted(r.end - r.start for r in run.done())
    if lat:
        print("wmbench: %d requests, latency min %.4f median %.4f max %.4f s,"
              " window %.3f s" % (len(lat), lat[0], lat[len(lat) // 2],
                                   lat[-1], run.window_s), file=sys.stderr)
    every = run.records + run.untraced
    failed = sum(1 for r in every if not r.ok)
    checks = {k: {"value": float(numbers.get(k, float("inf"))), "limit": v}
              for k, v in mix["check"]["limits"].items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    if args.trace:
        metrics = _metrics(spec.per_layer(bench, args.workload), run,
                           "layer_metrics", here)
    else:
        metrics = _metrics(spec.end_to_end(bench, args.workload), run,
                           "end_to_end", here)
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(devices[0]) if cuda
              else "cpu", "count": len(devices), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(every),
              "failed": failed, "metrics": metrics, "device": device}
    if args.trace:
        from .lib import trace as tr
        busy, _ = tr.busy_intervals(run.trace.device)
        idx = [d.index for d in devices]
        device["busy_s"] = sum(busy.get(i, 0.0) for i in idx) / len(idx)
        device["window_s"] = run.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(run.trace),
                               "idle_gaps": tr.idle_gaps(run.trace)}
    if cuda:
        result["power"] = _power_limit()
    result["checks"] = checks
    return result, checks


if __name__ == "__main__":
    sys.exit(main())

"""The traced run: torch.profiler over the measured window, read back from
its Chrome trace.

`busy_intervals` is audiowmark_tpu_torch/profile_cells.py's
`_busy_intervals`, copied: the device's busy time is the union of the
intervals of every kernel and copy, not their sum.  Here it reads the
Chrome trace's events (microseconds) and keeps one union per card.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    """The events of one traced window, by kind."""

    device: List[dict] = field(default_factory=list)      # kernels, copies
    launches: Dict[int, dict] = field(default_factory=dict)  # corr -> api
    annotations: List[dict] = field(default_factory=list)
    cpu_ops: List[dict] = field(default_factory=list)

    def kernels(self) -> List[dict]:
        return [e for e in self.device if e["cat"] == "kernel"]


def load(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return from_events(events)


def from_events(events: List[dict]) -> Trace:
    t = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            t.device.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                t.launches[corr] = e
        elif cat == "user_annotation":
            t.annotations.append(e)
        elif cat == "cpu_op":
            t.cpu_ops.append(e)
    return t


def _device_of(e: dict) -> int:
    args = e.get("args", {})
    return int(args.get("device", e.get("pid", 0)))


def busy_intervals(device_events: List[dict]
                   ) -> Tuple[Dict[int, float], Dict[str, float]]:
    """(union of the device intervals in s per card, s per device op
    name)."""
    spans = defaultdict(list)
    per_name: Dict[str, float] = defaultdict(float)
    for ev in device_events:
        start, end = ev["ts"], ev["ts"] + ev["dur"]
        spans[_device_of(ev)].append((start, end))
        per_name[ev["name"]] += ev["dur"] / 1e6
    busy = {}
    for dev, sp in spans.items():
        sp.sort()
        total, cur_s, cur_e = 0.0, None, None
        for s, e in sp:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        busy[dev] = total / 1e6
    return busy, per_name


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def kernels_in_spans(trace: Trace, name: str) -> List[dict]:
    """Kernels whose launch call lies inside an annotation `name` on the
    annotation's thread."""
    spans = defaultdict(list)
    for a in trace.annotations:
        if a["name"] == name:
            spans[(a.get("pid"), a.get("tid"))].append(
                (a["ts"], a["ts"] + a["dur"]))
    starts = {}
    for k, v in spans.items():
        v.sort()
        starts[k] = [s for s, _ in v]
    out = []
    for k in trace.kernels():
        api = trace.launches.get(k.get("args", {}).get("correlation"))
        if api is None:
            continue
        key = (api.get("pid"), api.get("tid"))
        i = bisect.bisect_right(starts.get(key, ()), api["ts"]) - 1
        if i >= 0 and api["ts"] <= spans[key][i][1]:
            out.append(k)
    return out


def idle_gaps(trace: Trace, top: int = 10) -> List[List]:
    """The idle gaps of the busiest card, summed by what the host was
    doing at each gap's middle: the innermost annotation and the innermost
    torch op there."""
    by_dev = defaultdict(list)
    for e in trace.device:
        by_dev[_device_of(e)].append((e["ts"], e["ts"] + e["dur"]))
    if not by_dev:
        return []
    dev = max(by_dev, key=lambda d: len(by_dev[d]))
    busy = union(by_dev[dev])
    labels: Dict[str, float] = defaultdict(float)
    anns = _Nest(trace.annotations)
    ops = _Nest(trace.cpu_ops)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        a, o = anns.at(mid), ops.at(mid)
        label = "%s / %s" % (a["name"] if a else "outside the requests",
                             o["name"] if o else "host python")
        labels[label] += (s1 - e0) / 1e6
    return [[k, v] for k, v in sorted(labels.items(),
                                       key=lambda kv: -kv[1])[:top]]


class _Nest:
    """Host events by start time; `at(t)` is the latest-starting one that
    still covers t, which for nested events is the innermost."""

    def __init__(self, events: List[dict]):
        self.events = sorted(events, key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in self.events]

    def at(self, t: float, look: int = 256):
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - look, -1), -1):
            e = self.events[j]
            if e["ts"] + e["dur"] >= t:
                return e
        return None


def device_ops(trace: Trace, top: int = 10) -> List[List]:
    _, per_name = busy_intervals(trace.device)
    return [[k, v] for k, v in sorted(per_name.items(),
                                       key=lambda kv: -kv[1])[:top]]


def remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass

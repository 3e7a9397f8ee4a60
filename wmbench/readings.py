"""Readings that set a cell's limits: the program's compared numbers over
many seeds, and the control's (the plain reference in a lower precision,
put in the program's place) on the same inputs, in one process.

    python3 -m wmbench.readings --workload <cell> --seeds 11,12,13 \\
        --seconds 10 [--control tf32,bf16]

For each seed: the cell's set-up, a window of --seconds, then the numbers
of the program's sampled answers against the f64 reference and, for each
control precision, the control's numbers; one JSON line per seed.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time

from .lib import spec
from . import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", default="")
    ap.add_argument("--detail", type=int, default=0,
                    help="also print this many worst-matched patterns")
    args = ap.parse_args(argv)
    import torch
    from .reference.prec import Prec

    bench = spec.benchmark()
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    entry = spec.module("entries", mix["entry"])
    devices = [torch.device("cuda", i) for i in range(cell["chips"])]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        tmp = tempfile.mkdtemp(prefix="wmbench-")
        ctx = run.Context(cell, cfg, mix, seed, devices, tmp, {})
        with contextlib.redirect_stdout(run._Sink()):
            session = entry.Session(ctx)
        r = run.Run(args.workload, len(devices), args.seconds, 0.0)
        run._window(session, r, args.seconds)
        session.release()
        detail = [] if args.detail else None
        kw = {"detail": detail} if args.detail else {}
        out = {"seed": seed, "requests": len(r.records),
               "failed": sum(not x.ok for x in r.records),
               "program": session.check(Prec("f64"), **kw)}
        if detail:
            out["worst"] = sorted(detail, reverse=True)[:args.detail]
        for p in filter(None, args.control.split(",")):
            out["control_" + p] = session.control(Prec(p))
        out["s"] = time.time() - t0
        print(json.dumps(out), flush=True)
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

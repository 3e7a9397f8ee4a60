"""Kernel K1 (csrc/viterbi_acs.cu) on one CUDA card, at every cluster size.

    python3 -m audiowmark_tpu_torch.k1_bench [--steps N]

For B = 1, 3, 8, 16, 24, 52 and 140 rows and every cluster size C (CTAs
per row), K1 runs on `fixtures.acs_check_metrics` rows, is held bit for
bit against its plain version (`fixtures.acs_equal`), and is timed with
CUDA events: the mean of 20 launches into outputs allocated beforehand,
after one warm-up, without flushing L2 (the main path launches K1 right
after it computed bm).  `wrapper_ms` times the wrapper `viterbi_acs` as
the main path calls it (its C, its host work), once per B.  Each line
gives the times, the bound (bytes that must move at 3.35 TB/s: bm read
once, the packed decisions, metrics and bits written once), the share of
the bound and the clusters the card holds at once; the wrapper's C is
marked `default`.  Any mismatch exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet
BATCHES = (1, 3, 8, 16, 24, 52, 140)


def bound_ms(batch: int, steps: int) -> float:
    """The least time K1's bytes take on the card (bytes-bound)."""
    from .ops.viterbi import STATE_COUNT, WORDS
    per_row = (steps * STATE_COUNT * 4 + steps * WORDS * 4
               + STATE_COUNT * 4 + steps * 4)
    return batch * per_row / HBM_BYTES_PER_S * 1e3


def cuda_ms(fn, n: int = 20) -> float:
    """Mean milliseconds of fn() over n calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=143)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_bench: no CUDA device", file=sys.stderr)
        return 1
    from . import cuda_build
    from .fixtures import acs_check_metrics, acs_equal
    from .ops import viterbi

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    viterbi._library()
    for line in cuda_build.ptxas_report("viterbi_acs").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    failed = 0
    for batch in BATCHES:
        bm = acs_check_metrics(batch, batch, args.steps, "cuda")
        want = viterbi.viterbi_acs_plain(bm)
        failed += not acs_equal(viterbi.viterbi_acs(bm), want)
        wrapper_ms = cuda_ms(lambda: viterbi.viterbi_acs(bm))
        outs = viterbi.outputs(bm)
        for cluster in viterbi.CLUSTER_SIZES:
            active = viterbi.launch(bm, *outs, cluster)
            ok = acs_equal(outs, want)
            failed += not ok
            ms = cuda_ms(lambda: viterbi.launch(bm, *outs, cluster))
            b_ms = bound_ms(batch, args.steps)
            print(json.dumps(dict(
                batch=batch, steps=args.steps, cluster=cluster,
                default=cluster == viterbi.cluster_size(batch, sms),
                equal=ok, ms=ms, wrapper_ms=wrapper_ms, bound_ms=b_ms,
                share=b_ms / ms, us_per_step=ms * 1e3 / args.steps,
                active_clusters=active, card=card)), flush=True)
    if failed:
        print("k1_bench: %d launches differ from the plain version"
              % failed, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

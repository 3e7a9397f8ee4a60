#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (audiowmark_tpu_torch) on one card.

    python3 chip_smoke.py

Drives the port's main path as a user calls it — add_watermark, then
get_watermark as `cmp` — on deterministic 16-bit stereo noise at 44.1 kHz
(the CLI's test-gen-noise), at the full production geometry:

  1. environment: card, power limit, torch/CUDA versions, matmul precision;
  2. build kernel K1 (csrc/viterbi_acs.cu) with nvcc and time the build;
  3. K1 vs its plain PyTorch version on the card at B=16, 143 steps, on
     clean codewords (exact ties), an all-NaN row and random rows:
     decisions, metrics (NaN equal to NaN) and bits exact; both timed
     with CUDA events;
  4. the add core on the card vs on the CPU on 40 frames (<= 1 LSB, on
     at most 3e-3 of the samples);
  5. 200 s: add, then cmp -> match_count 5 (run twice: cold and warm);
  6. 200 s with the limiter off: SNR >= 32.4 dB, cmp -> match_count 5;
  7. 60 s -> match_count 3 and 30 s -> match_count 1 (the clip decoder);
  8. K1 was launched by the main path (its launch count, reset before
     phase 5, is above 0).

Any failed check raises: the script exits non-zero and prints no result.
Without a CUDA device it exits 1 before any work.  On success the line
before the last is the kernels' JSON and the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
MSG = "0123456789abcdef0011223344556677"
SNR_FLOOR_DB = 32.4        # tests/block-decoder-test.sh:18 of the reference
K1_BATCH, K1_STEPS = 16, 143


def phase(name, **fields):
    print("phase %-10s %s" % (name, json.dumps(fields, sort_keys=True)),
          flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit("chip_smoke: FAILED: %s" % what)


def cuda_ms(fn, n):
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


def add_and_cmp(port, key, src, dst, expect, **params):
    """port add then port cmp; returns (add s, get s, cmp stdout)."""
    from audiowmark_tpu.params import Params
    Params.reset()
    for name, value in params.items():
        setattr(Params, name, value)
    t0 = time.perf_counter()
    check(port.add_watermark(key, src, dst, MSG) == 0, "add of " + src)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = port.get_watermark([key], dst, MSG)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    text = out.getvalue()
    check(rc == 0 and ("\nmatch_count %d " % expect) in "\n" + text,
          "cmp of %s: expected match_count %d, got:\n%s" % (dst, expect, text))
    Params.reset()
    return t1 - t0, t2 - t1, text


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on a CUDA card",
              file=sys.stderr)
        return 1
    import audiowmark_tpu_torch as port
    from audiowmark_tpu.crypto.keys import Key
    from audiowmark_tpu.io.wavdata import WavData
    from audiowmark_tpu_torch import cuda_build
    from audiowmark_tpu_torch.fixtures import acs_check_metrics, gen_noise
    from audiowmark_tpu_torch.ops import frames, viterbi

    # ---- 1. environment ----
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase("env", device=name, count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda,
          matmul_precision=torch.get_float32_matmul_precision(),
          matmul_tf32=torch.backends.cuda.matmul.allow_tf32)
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")

    # ---- 2. build K1 ----
    t0 = time.perf_counter()
    lib_path = cuda_build.build("viterbi_acs")
    viterbi._library()
    phase("build", kernel="viterbi_acs", seconds=time.perf_counter() - t0,
          library=os.path.relpath(lib_path, REPO))

    # ---- 3. K1 vs plain on the card ----
    bm = acs_check_metrics(0, K1_BATCH, K1_STEPS, "cuda")
    dec, met, bits = viterbi.viterbi_acs(bm)
    pdec, pmet, pbits = viterbi.viterbi_acs_plain(bm)
    torch.cuda.synchronize()
    n_dec_diff = int((dec != pdec).sum())
    both_nan = torch.isnan(met) & torch.isnan(pmet)
    n_nan = int(both_nan.sum())
    err = torch.where(both_nan, torch.zeros_like(met), (met - pmet).abs())
    max_abs_err = float(err.max())
    check(n_dec_diff == 0 and max_abs_err == 0.0
          and torch.equal(bits, pbits), "K1 differs from the plain version")
    check(n_nan == viterbi.STATE_COUNT, "the NaN row's metrics are not NaN")
    k1_ms = cuda_ms(lambda: viterbi.viterbi_acs(bm), 20)
    plain_ms = cuda_ms(lambda: viterbi.viterbi_acs_plain(bm), 5)
    phase("k1_check", batch=K1_BATCH, steps=K1_STEPS, decisions_differ=0,
          max_abs_err=max_abs_err, nan_metrics=n_nan, k1_ms=k1_ms, plain_ms=plain_ms, card=smi)

    # ---- 4. add core: card vs CPU on a small input ----
    rng = np.random.RandomState(0)
    n_frames, C = 40, 2
    x = rng.randint(-30000, 30000, n_frames * frames.FRAME * C) \
        .astype(np.float32) / np.float32(32768.0)
    mods = rng.randint(-1, 2, (n_frames, frames.N_BINS)).astype(np.int8)
    outs = [frames.add_file_core(
        torch.from_numpy(x).to(dev), torch.from_numpy(mods).to(dev), 0.01,
        torch.from_numpy(frames.analysis_window()).to(dev),
        torch.from_numpy(frames.synthesis_window()).to(dev), C, x.size,
        False, True, 4096).cpu().numpy().astype(np.int32)
        for dev in ("cuda", "cpu")]
    lsb = np.abs(outs[0] - outs[1])
    check(lsb.max() <= 1 and np.count_nonzero(lsb) <= 3e-3 * lsb.size,
          "add core on the card is more than 1 LSB from the CPU")
    phase("add_core", samples=int(lsb.size), lsb_apart=int(np.count_nonzero(
        lsb)))

    key = Key()
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as d:
        t0 = time.perf_counter()
        for secs in (200, 60, 30):
            gen_noise(key, os.path.join(d, "n%d.wav" % secs), secs, 44100)
        phase("fixtures", seconds=time.perf_counter() - t0)

        # ---- 5.-7. the main path; K1's launch count starts at 0 here ----
        viterbi.LAUNCHES = 0
        n200, wm200 = os.path.join(d, "n200.wav"), os.path.join(d, "wm.wav")
        for run in ("cold", "warm"):
            add_s, get_s, _ = add_and_cmp(port, key, n200, wm200, 5)
            phase("200s_" + run, add_s=add_s, get_s=get_s,
                  add_realtime=200 / add_s, get_realtime=200 / get_s,
                  card=smi)

        nolim = os.path.join(d, "wm_nolim.wav")
        add_and_cmp(port, key, n200, nolim, 5, test_no_limiter=True)
        o = WavData.load(n200).samples.astype(np.float64)
        w = WavData.load(nolim).samples.astype(np.float64)
        check(o.shape == w.shape and np.isfinite(w).all(),
              "marked file has another length or non-finite samples")
        snr = 10 * np.log10(np.sum(o * o) / np.sum((o - w) ** 2))
        check(snr >= SNR_FLOOR_DB, "SNR %.3f dB < %.1f dB" % (snr,
                                                              SNR_FLOOR_DB))
        phase("snr", snr_db=snr, floor_db=SNR_FLOOR_DB)

        for secs, expect in ((60, 3), (30, 1)):
            add_s, get_s, _ = add_and_cmp(
                port, key, os.path.join(d, "n%d.wav" % secs),
                os.path.join(d, "wm%d.wav" % secs), expect)
            phase("%ds" % secs, match_count=expect, add_s=add_s, get_s=get_s)
        launches = viterbi.LAUNCHES

    # ---- 8. the main path went through K1 ----
    check(launches > 0, "the main path never launched K1")
    phase("launches", viterbi_acs=launches)

    print(json.dumps({"kernels": [{
        "name": "viterbi_acs",
        "route": "cuda",
        "source": "audiowmark_tpu_torch/csrc/viterbi_acs.cu",
        "replaces": "audiowmark_tpu/ops/viterbi_pallas.py:128",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

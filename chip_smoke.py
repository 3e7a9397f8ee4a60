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
     with CUDA events (phase 13 repeats this at the largest batch of the
     32-min get);
  4. the add core on the card vs on the CPU on 40 frames (<= 1 LSB, on
     at most 3e-3 of the samples);
  5. 200 s: add, then cmp -> match_count 5 (run twice: cold and warm);
  6. 200 s with the limiter off: SNR >= 32.4 dB, cmp -> match_count 5;
  7. 60 s -> match_count 3 and 30 s -> match_count 1 (the clip decoder);
  8. K1 was launched by the main path (its launch count, reset before
     phase 5 and read after phase 7, is above 0);
  9. resample: 200 s at 32 kHz, add (the streaming add through the
     resampler pair) then cmp -> 5; the marked file resampled to 48 kHz
     on the card, cmp -> 5;
 10. stream_add: the 200 s file through the streaming add (Params.snr
     sends it there) vs the whole-file add: bit-exact with the limiter off,
     <= 1 LSB on < 1e-3 of the samples with it on, Data Blocks equal;
     cmp -> 5;
 11. no_sync: --test-no-sync cmp of the 200 s marked file -> 5;
 12. staged: the staged search vs the fused one on the card, BLOCK on the
     200 s marked file and CLIP on the 60 s one's start window: indices
     and block types equal, qualities within rtol 2e-4;
 13. long: 32 min of seeded noise, add (the streaming path) then cmp over
     2 chunks with the tiled search: every pattern above the sync
     threshold is the message, there are at least as many of the message
     as data blocks, and the others (the best candidates below the
     threshold, which decode to noise) are below it, at most
     Params.get_n_best per chunk; on the first 30-min chunk the tiled
     search equals the staged one; K1 equals its plain version at the
     largest batch that get gave it.

Every phase 9-13 prints one line.  Each path (the main path of phases
5-7; the 32 kHz add and get, the 48 kHz get, the streaming add and its
get, the --test-no-sync get, the 32-min add and get) has K1's launch
count reset to 0 just before it and read just after: each must be above
0.  The kernels line gives their sum as `launches` and each of them in
`launches_by_path`.

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
LONG_MINUTES = 32          # the JAX package's chunked get (bench.py:367)
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


def launches_of(path, fn):
    """(fn(), K1 launches while it ran); the count is reset just before
    and must be above 0 just after."""
    from audiowmark_tpu_torch.ops import viterbi
    viterbi.LAUNCHES = 0
    result = fn()
    launches = viterbi.LAUNCHES
    check(launches > 0, "%s never launched K1" % path)
    return result, launches


def k1_check(seed, batch, steps):
    """K1 vs its plain version on acs_check_metrics rows: decisions,
    metrics and bits exact.  Returns (max abs metric error, NaN metrics,
    K1 ms, plain ms)."""
    from audiowmark_tpu_torch.fixtures import acs_check_metrics
    from audiowmark_tpu_torch.ops import viterbi
    bm = acs_check_metrics(seed, batch, steps, "cuda")
    dec, met, bits = viterbi.viterbi_acs(bm)
    pdec, pmet, pbits = viterbi.viterbi_acs_plain(bm)
    torch.cuda.synchronize()
    n_dec_diff = int((dec != pdec).sum())
    both_nan = torch.isnan(met) & torch.isnan(pmet)
    n_nan = int(both_nan.sum())
    err = torch.where(both_nan, torch.zeros_like(met), (met - pmet).abs())
    max_abs_err = float(err.max())
    check(n_dec_diff == 0 and max_abs_err == 0.0
          and torch.equal(bits, pbits),
          "K1 differs from the plain version at B=%d" % batch)
    check(n_nan == viterbi.STATE_COUNT, "the NaN row's metrics are not NaN")
    return (max_abs_err, n_nan, cuda_ms(lambda: viterbi.viterbi_acs(bm), 20),
            cuda_ms(lambda: viterbi.viterbi_acs_plain(bm), 5))


def set_params(**params):
    from audiowmark_tpu.params import Params
    Params.reset()
    for name, value in params.items():
        setattr(Params, name, value)


def add(port, key, src, dst, **params):
    """port add; returns (wall s, its informational output)."""
    set_params(**params)
    info = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(info):
        rc = port.add_watermark(key, src, dst, MSG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, "add of " + src)
    set_params()
    return wall, info.getvalue()


def cmp(port, key, path, expect, **params):
    """port cmp; returns (rc, wall s, stdout); expect: the match count
    required, or None for any."""
    set_params(**params)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = port.get_watermark([key], path, MSG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = out.getvalue()
    if expect is not None:
        check(rc == 0 and ("\nmatch_count %d " % expect) in "\n" + text,
              "cmp of %s: expected match_count %d, got:\n%s"
              % (path, expect, text))
    set_params()
    return rc, wall, text


def add_and_cmp(port, key, src, dst, expect, **params):
    """port add then port cmp; returns (add s, get s, cmp stdout)."""
    add_s = add(port, key, src, dst, **params)[0]
    _, get_s, text = cmp(port, key, dst, expect, **params)
    return add_s, get_s, text


def info_line(info, name):
    lines = [line.split(":", 1)[1].strip() for line in info.splitlines()
             if line.startswith(name + ":")]
    check(len(lines) == 1, "no %s line in:\n%s" % (name, info))
    return lines[0]


def lsb_apart(a_path, b_path):
    """(largest difference in 16-bit LSBs, samples that differ)."""
    from audiowmark_tpu.io.wavdata import WavData
    a = WavData.load(a_path).samples.astype(np.float64)
    b = WavData.load(b_path).samples.astype(np.float64)
    check(a.shape == b.shape and np.isfinite(a).all(),
          "%s and %s differ in length or are not finite" % (a_path, b_path))
    lsb = np.abs(np.round((a - b) * 32768))
    return float(lsb.max()), int(np.count_nonzero(lsb)), int(lsb.size)


def phase_resample(port, key, d, smi):
    """9. 200 s at 32 kHz: add, cmp; resample to 48 kHz on the card, cmp.
    Returns K1's launches on each of the two paths."""
    from audiowmark_tpu.io.wavdata import WavData
    from audiowmark_tpu_torch.fixtures import gen_noise
    from audiowmark_tpu_torch.ops.resample import resample
    n32, wm32 = os.path.join(d, "n32.wav"), os.path.join(d, "wm32.wav")
    wm48 = os.path.join(d, "wm48.wav")
    t0 = time.perf_counter()
    gen_noise(key, n32, 200, 32000)
    fixture_s = time.perf_counter() - t0
    (add_s, get32_s, _), n32k = launches_of(
        "the 32 kHz path", lambda: add_and_cmp(port, key, n32, wm32, 5))
    t0 = time.perf_counter()
    resample(WavData.load(wm32), 48000).save(wm48)
    resample_s = time.perf_counter() - t0
    (_, get48_s, _), n48k = launches_of(
        "the 48 kHz get", lambda: cmp(port, key, wm48, 5))
    phase("resample", match_count_32k=5, match_count_48k=5,
          fixture_s=fixture_s, add_32k_s=add_s, get_32k_s=get32_s,
          resample_to_48k_s=resample_s, get_48k_s=get48_s,
          k1_launches_32k=n32k, k1_launches_48k=n48k, card=smi)
    return {"resample_32k": n32k, "resample_48k": n48k}


def phase_stream_add(port, key, d, smi):
    """10. the 200 s file through the streaming add vs the whole-file add;
    returns K1's launches over the phase."""
    fields, launches = launches_of("the streaming add path",
                                   lambda: _stream_add(port, key, d))
    phase("stream_add", k1_launches=launches, card=smi, **fields)
    return launches


def _stream_add(port, key, d):
    n200 = os.path.join(d, "n200.wav")
    walls, infos, paths = {}, {}, {}
    for lim in ("lim", "nolim"):
        for path in ("fast", "stream"):
            name = path + "_" + lim
            paths[name] = os.path.join(d, name + ".wav")
            walls[name], infos[name] = add(
                port, key, n200, paths[name], snr=path == "stream",
                test_no_limiter=lim == "nolim")
    for lim in ("lim", "nolim"):
        check(info_line(infos["fast_" + lim], "Data Blocks")
              == info_line(infos["stream_" + lim], "Data Blocks"),
              "Data Blocks differ between the streaming and whole-file add")
    nolim = lsb_apart(paths["fast_nolim"], paths["stream_nolim"])
    check(nolim[1] == 0, "streaming add without the limiter is not "
          "bit-exact with the whole-file add: %d samples differ" % nolim[1])
    lim = lsb_apart(paths["fast_lim"], paths["stream_lim"])
    check(lim[0] <= 1 and lim[1] < 1e-3 * lim[2], "streaming add with the "
          "limiter: %d of %d samples up to %g LSB from the whole-file add"
          % (lim[1], lim[2], lim[0]))
    _, get_s, _ = cmp(port, key, paths["stream_lim"], 5)
    return dict(snr=info_line(infos["stream_lim"], "SNR"),
                data_blocks=info_line(infos["stream_lim"], "Data Blocks"),
                lsb_apart_limiter=lim[1], lsb_apart_no_limiter=nolim[1],
                samples=lim[2], stream_add_s=walls["stream_lim"],
                fast_add_s=walls["fast_lim"], get_s=get_s, match_count=5)


def same_scores(got, want, what):
    gi = [(s.index, s.block_type.name) for s in got[0].sync_scores]
    wi = [(s.index, s.block_type.name) for s in want[0].sync_scores]
    check(gi == wi and gi, "%s: %s != %s" % (what, gi, wi))
    gq = np.array([s.quality for s in got[0].sync_scores])
    wq = np.array([s.quality for s in want[0].sync_scores])
    check(np.allclose(gq, wq, rtol=2e-4, atol=2e-5),
          "%s: qualities %s != %s" % (what, gq, wq))
    return len(gi)


def timed(fn):
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def phase_staged(key, d, smi):
    """12. the staged search vs the fused one on the card."""
    from audiowmark_tpu.io.wavdata import WavData
    from audiowmark_tpu_torch.models import syncfinder as sf
    from audiowmark_tpu_torch.models.decoder import ClipDecoder
    set_params()
    block = WavData.load(os.path.join(d, "wm.wav"))
    clip = ClipDecoder(1)._build_window(
        [key], WavData.load(os.path.join(d, "wm60.wav")), "start")[0]
    fields = {}
    for name, wav, mode in (("block", block, sf.SyncMode.BLOCK),
                            ("clip", clip, sf.SyncMode.CLIP)):
        for run in range(2):        # the second run is warm
            fused, fused_s = timed(lambda: sf.search([key], wav, mode))
            staged, staged_s = timed(
                lambda: sf.search_staged([key], wav, mode))
        fields[name + "_scores"] = same_scores(staged, fused, name)
        fields[name + "_fused_s"] = fused_s
        fields[name + "_staged_s"] = staged_s
    phase("staged", card=smi, **fields)


def batches_of(fn):
    """(fn(), the (B, steps) shapes the decoders gave K1 while it ran)."""
    from audiowmark_tpu_torch.codec import convcode
    shapes, acs = [], convcode.viterbi_acs

    def recording(bm):
        shapes.append(tuple(bm.shape[:2]))
        return acs(bm)

    convcode.viterbi_acs = recording
    try:
        return fn(), shapes
    finally:
        convcode.viterbi_acs = acs


def phase_long(port, key, d, smi):
    """13. 32 min: add (streaming), cmp over 2 chunks (tiled search);
    returns K1's launches over the add and cmp, and its check at the
    largest batch of that cmp."""
    from audiowmark_tpu.params import Params
    from audiowmark_tpu_torch.fixtures import long_noise
    from audiowmark_tpu_torch.models import embedder
    from audiowmark_tpu_torch.models import syncfinder as sf
    from audiowmark_tpu_torch.models.chunkloader import WavChunkLoader
    from audiowmark_tpu_torch.ops import search_fused
    n, wm = os.path.join(d, "nlong.wav"), os.path.join(d, "wmlong.wav")
    seconds = LONG_MINUTES * 60
    t0 = time.perf_counter()
    long_noise(1, n, seconds, 44100)
    fixture_s = time.perf_counter() - t0
    check(seconds * 44100 > embedder._FAST_PATH_MAX_FRAMES * 1024,
          "the long file would take the whole-file add")

    def add_and_get():
        add_s, info = add(port, key, n, wm)
        os.remove(n)
        return (add_s, info) + batches_of(lambda: cmp(port, key, wm, None))

    (add_s, info, (rc, get_s, text), shapes), launches = launches_of(
        "the 32-min path", add_and_get)

    set_params()
    loader = WavChunkLoader(wm)
    loader.load_next_chunk()
    wav = loader.wav_data()
    check(wav.n_frames > search_fused.MAX_FUSED_FRAMES * 1024,
          "the first chunk is not searched in tiles")
    tiled, tiled_s = timed(lambda: sf.search([key], wav, sf.SyncMode.BLOCK))
    staged, staged_s = timed(
        lambda: sf.search_staged([key], wav, sf.SyncMode.BLOCK))
    n_scores = same_scores(tiled, staged, "first chunk, tiled vs staged")
    chunks = 1
    while True:
        loader.load_next_chunk()
        if loader.done():
            break
        chunks += 1
    check(chunks == 2, "the long file gave %d chunks, not 2" % chunks)

    # "pattern <time> <bits> <quality> <error> [type]".  Everything above
    # the sync threshold must be the message.  Where a chunk has fewer
    # candidates above it than Params.get_n_best (chunk 2 holds ~5 blocks),
    # the search keeps the best ones below it too: those decode to noise,
    # so at most get_n_best per chunk may be something else
    patterns = [line.split() for line in text.splitlines()
                if line.startswith("pattern")]
    above = [f for f in patterns if float(f[3]) > Params.sync_threshold2]
    others = [f for f in patterns if f[2] != MSG]
    n_msg = len(patterns) - len(others)
    blocks = int(info_line(info, "Data Blocks"))
    check(rc == 0 and above and all(f[2] == MSG for f in above)
          and n_msg >= blocks and len(others) <= Params.get_n_best * chunks,
          "long cmp: rc %d, %d data blocks, %d chunks, patterns:\n%s"
          % (rc, blocks, chunks, text))

    batch, steps = max(shapes)
    k1 = k1_check(1, batch, steps)
    phase("long", minutes=LONG_MINUTES, chunks=chunks, data_blocks=blocks,
          match_count=n_msg, patterns=len(patterns),
          patterns_above_threshold=len(above), other_patterns=len(others),
          fixture_s=fixture_s, add_s=add_s, get_s=get_s,
          first_chunk_scores=n_scores, tiled_search_s=tiled_s,
          staged_search_s=staged_s, chunk_size_min=Params.get_chunk_size,
          k1_launches=launches, k1_batches=sorted(set(shapes)),
          k1_check_batch=batch, k1_check_steps=steps, k1_max_abs_err=k1[0],
          k1_ms=k1[2], plain_ms=k1[3], card=smi)
    return launches, dict(batch=batch, steps=steps, max_abs_err=k1[0],
                          ms=k1[2], plain_ms=k1[3])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on a CUDA card",
              file=sys.stderr)
        return 1
    t_script = time.perf_counter()
    import audiowmark_tpu_torch as port
    from audiowmark_tpu.crypto.keys import Key
    from audiowmark_tpu.io.wavdata import WavData
    from audiowmark_tpu_torch import cuda_build
    from audiowmark_tpu_torch.fixtures import gen_noise
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
    max_abs_err, n_nan, k1_ms, plain_ms = k1_check(0, K1_BATCH, K1_STEPS)
    phase("k1_check", batch=K1_BATCH, steps=K1_STEPS, decisions_differ=0,
          max_abs_err=max_abs_err, nan_metrics=n_nan, k1_ms=k1_ms,
          plain_ms=plain_ms, card=smi)

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

        # ---- 8. the main path went through K1 ----
        paths = {"main": viterbi.LAUNCHES}
        check(paths["main"] > 0, "the main path never launched K1")
        phase("launches", viterbi_acs=paths["main"])

        # ---- 9.-13. any rate, the streaming add, --test-no-sync, the
        # staged and the tiled search; each path counts K1 on its own ----
        paths.update(phase_resample(port, key, d, smi))
        paths["stream_add"] = phase_stream_add(port, key, d, smi)
        (_, get_s, _), paths["no_sync"] = launches_of(
            "the --test-no-sync get",
            lambda: cmp(port, key, wm200, 5, test_no_sync=True))
        phase("no_sync", match_count=5, get_s=get_s,
              k1_launches=paths["no_sync"], card=smi)
        phase_staged(key, d, smi)
        paths["long_32min"], long_check = phase_long(port, key, d, smi)

    phase("total", seconds=time.perf_counter() - t_script, card=smi)

    print(json.dumps({"kernels": [{
        "name": "viterbi_acs",
        "route": "cuda",
        "source": "audiowmark_tpu_torch/csrc/viterbi_acs.cu",
        "replaces": "audiowmark_tpu/ops/viterbi_pallas.py:128",
        "launches": sum(paths.values()),
        "launches_by_path": paths,
        "max_abs_err": max(max_abs_err, long_check["max_abs_err"]),
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "checks": [dict(batch=K1_BATCH, steps=K1_STEPS,
                        max_abs_err=max_abs_err, ms=k1_ms,
                        plain_ms=plain_ms), long_check],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

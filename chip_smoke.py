#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (audiowmark_tpu_torch) on one card.

    python3 chip_smoke.py              # phases 1-25, 27 and 28, one card
    python3 chip_smoke.py --new-only   # phases 1, 2, 27 and 28, one card
    python3 chip_smoke.py --cards 4    # phases 1, 2 and 26, four cards

Drives the port's main path as a user calls it — add_watermark, then
get_watermark as `cmp` — on deterministic 16-bit stereo noise at 44.1 kHz
(the CLI's test-gen-noise), at the full production geometry:

  1. environment: card, power limit, torch/CUDA versions, matmul precision;
  2. build kernels K1 (csrc/viterbi_acs.cu) and K2 (csrc/resample_k2.cu)
     with nvcc, time each build and print ptxas's registers and spills;
  3. K1 vs its plain PyTorch version on the card at 143 steps and B = 1,
     16 and 52, on clean codewords (exact ties), an all-NaN row and random
     rows (random rows only at B = 1): packed decisions, the decisions
     unpacked to one int8 per state, metrics (NaN equal to NaN) and bits
     exact; both timed with CUDA events, beside the bound (bytes at
     3.35 TB/s), the share of it and the cluster size (phase 8 repeats
     this at the main path's largest batch, phase 13 at the 32-min
     get's);
  4. the add core on the card vs on the CPU on 40 frames (<= 1 LSB, on
     at most 3e-3 of the samples);
  5. 200 s: add, then cmp -> match_count 5 (run twice: cold and warm);
  6. 200 s with the limiter off: SNR >= 32.4 dB, cmp -> match_count 5;
  7. 60 s -> match_count 3 and 30 s -> match_count 1 (the clip decoder);
  8. K1 was launched by the main path (its launch count, reset before
     phase 5 and read after phase 7, is above 0); the (B, steps) shapes
     the main path gave K1; K1 checked and timed at the largest of them,
     and the branch metrics' preparation (batch_branch_metrics and
     torch.cat, codec/convcode.py:121-126) timed at that B;
  9. resample: 200 s at 32 kHz, add (the streaming add through the
     resampler pair) then cmp -> 5; the marked file resampled to 48 kHz
     on the card, cmp -> 5;
 10. stream_add: the 200, 60 and 30 s files (whole-file passes of 8614,
     2584 and 1292 frames) through the streaming add (`add --snr` sends it
     there; 4096-frame tiles) vs the whole-file add: 0 samples apart with
     the limiter off, <= 1 LSB on < 1e-3 of the samples with it on, Data
     Blocks equal; cmp of the 200 s one -> 5;
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
     largest batch that get gave it;
 14. speed: the 30 s marked file played at speeds 0.9764, 1.0 and 1.01
     (the port's resample_ratio by 1/speed); cmp --detect-speed on all
     three and --detect-speed-patient on 0.9764: exit 0, the detect_speed
     line within 0.05 % of the true speed with quality > 0.4 and within
     5e-6 and 1e-3 of what the JAX package prints for the same fixtures on
     the CPU (JAX_DETECT below), -SPEED patterns with the message at
     0.9764 and 1.01, no speed result at 1.0; cmp --try-speed 1.01 ->
     `speed 1.010000`; speed_scan vs the staged pair prepare_mag_matrix +
     compare_speed_batch on the card (abs 1e-4); K1 equals its plain
     version at the largest batch these gets gave it; detect_speed timed
     alone, synchronised, normal and patient, first call and warm, and the
     resampler's share of a third, instrumented call;
 15. cli: `python3 -m audiowmark_tpu_torch` as a subprocess with no device
     setting (so on the card): test-gen-noise (bytes equal to the 200 s
     fixture) -> add -> cmp --expect-matches 5 -> exit 0, --expect-matches
     4 -> exit 1, get --json -> the message in the JSON matches, a missing
     file -> exit 1 with `audiowmark: error loading`;
 16. fleet: 16 stereo streams of 60 s of seeded noise through
     parallel.batch.watermark_batch, then detect_batch(top_k=8): in every
     stream the best eligible slot lies within half a frame of the first
     block's start (sample 256000) and its 128 bits are the message; in
     stream 0 every eligible slot above the sync threshold is one of the
     CLI search's candidates (same sample, same block type) and both have
     the same best one; each detect_batch launches K1 once, with 256 rows,
     and on those very branch metrics K1 equals its plain version bit for
     bit; first and warm seconds of both calls, seconds of audio per
     second, and the refine's, the extraction's and the Viterbi's share of
     a third, instrumented detect_batch;
 17. group: with logical devices on the one card, batch_embed_sharded on a
     (2, 2) mesh equals the (1, 1) one, 0 samples apart; search_block_group
     on two 6-min chunks of the 32-min file equals the per-chunk search and
     search_clip_pair the per-window search (indices, block types and
     qualities exact); cmp of the 32-min file prints the same with
     AUDIOWMARK_PREFETCH=0 and 1, and with 6-min chunks searched in groups
     of two the same as one by one; walls of each;
 18. hls: the 200 s fixture cut into 20 AAC segments of ~10 s with a
     playlist (the recipe of tests/test_hls_e2e.py), hls-prepare, hls-add
     of every segment through the command line's main on the card, the
     segments decoded and joined, cmp finds the message.  The phase's line
     says ffshim.available(); where the codec shim does not load it names
     the libraries that are missing and runs hls-add's work apart from AAC
     and MPEG-TS (hls_without_codec below);
 19. profile: AUDIOWMARK_PROFILE=<dir> python3 -m audiowmark_tpu_torch cmp
     of the 200 s marked file as a subprocess: exit 0, one Chrome trace in
     <dir> that parses as JSON and holds a viterbi_acs kernel event;
 20. modes: the command line's modes at production geometry on the 200 s
     fixture (MODES below): --hard, --linear (and its file decoded with mix
     on), --short 12/16/20, --frames-per-bit 4, two keys in one get, a
     double watermark, a wrong key, 24-bit input and cut-start, each with
     the reference's match counts (200 s -> 5, --frames-per-bit 4 -> 6,
     cut-start of 882300 frames -> 3, wrong key and mix-decoded linear ->
     0, every --short pattern the payload, both messages under their keys)
     and its get's first and warm wall seconds; K1 against its plain
     version, bit for bit, on the very branch metrics each mode gave it, at
     each (B, steps) shape (71 / 76 / 80 steps for the short payloads, the
     hard decisions' ties, 4 frames per bit); then at the reduced geometry
     of tests/test_torch_modes.py (80 s of RandomState(7) noise) the card's
     report of every mode against the port's CPU report of the same file:
     exit codes, pattern times, bits, types and match counts equal,
     qualities and errors within 0.002;
 21. ber: the ten codec-free rows of docs/BER.md's matrix (ber_row.py, 2
     seeds): noise with none, resample:48000, trunc:15 and clip:10, the
     five other carriers with none, noise@200s with none; every FLOOR row
     BER 0 and FER 0, each row beside docs/BER.md's numbers; the codec rows
     are listed with why they do not run here;
 22. streams: the shell's streams.  As processes of their own
     (`python3 -m audiowmark_tpu_torch`, no device setting): `add n200.wav
     - | cmp -` through a pipe -> match_count 5, the marked bytes piped
     into `get -` -> 5 patterns with the message, raw PCM of the 60 s
     fixture piped into `add --input-format raw --output-format wav-pipe -
     -` with and without the limiter (header sizes 0xFFFFFFFF), and
     `add --output-format wav-pipe` to stdout.  In this process, through
     the port's cli.main: the unknown-length add of the raw file with its
     tiles recorded (they ramp 16 -> 512 frames) against the known-length
     streaming add of the WAV (`add --snr`), and the same at 32 kHz (raw
     PCM of 60 s of test-gen-noise at 32000 against its WAV, both through
     the resampler pair): 0 samples apart without the limiter, <= 1 LSB on
     < 1e-3 of the samples with it (the rule of phase 10); the stdin adds
     within 1 LSB of the in-process one; the probe of tile_probe.py: the
     delta's stages (window + rfft, the exp/log factor, irfft) and the
     whole _delta_iffts on consecutive slices of T = 1 ... 4096 frames of
     the 200 s fixture against one call on 4096 frames, rows apart per
     stage, the stages that differ, the T from which they agree, and
     DELTA_FRAMES; _delta_iffts must agree at every T;
     `cmp --input-format wav-pipe`; and every
     sample format through add and cmp (raw signed 16 little and big, 24,
     32, unsigned 8 and 16, float, double big-endian; WAV input of 8-bit
     unsigned, 24 and 32-bit int and 32-bit float; --output-format rf64),
     each -> match_count 3, all with --strict;
 23. quality: the strength sweep of docs/QUALITY.md (quality_report.py):
     the noise and tonal carriers of 30 s, `add --strength S --snr` at
     strengths 30, 20, 15, 10, 5, 3, 2, 1 on the card and on the CPU: SNR
     and NMR within 1e-3 dB of the CPU's, the marked files <= 1 LSB apart,
     the tool's checks pass on the card's rows; the mp3 anchors run where
     libmp3lame and libmpg123 load, else are listed as not run;
 24. ttfb: the reference's latency harness (ttfb.py, a process of its own
     reading stdin, wav-pipe out) on the 200 s fixture as a WAV (known
     length) and as raw PCM (the unknown-length ramp): ttfb, total s and
     MB/s beside phase 15's process walls, every byte counted, each output
     decoded by cmp -> 5; and in this process the time from the call of
     add_stream_watermark on phase 22's 60 s raw file to its first write of
     samples, with the limiter and without it, first and warm;
 25. channels: other channel counts and rates (CHANNEL_FILES: mono 200 s
     at 44.1 kHz, 6 channels 60 s at 48 kHz, stereo 60 s at 22.05 and at
     96 kHz, seeded noise).  For each file: without the limiter the
     known-length add (whole-file at 44.1 kHz, 4096-frame tiles
     otherwise), at 44.1 kHz also the streaming known-length add (--snr),
     and the unknown-length add of its raw PCM (tiles 16 -> 512 frames),
     0 samples apart (on mono, cuFFT's rows at 1024 per call); with the
     limiter the card's add <= 1 LSB from the CPU's on < 3e-3 of the
     samples (phase 4's rule), cmp of it on the card and on the CPU with
     the same match count (at least 1); and on the file's first 30 s at
     the reduced geometry of phase 20 the card's report against the CPU's
     (phase 20's rule).  Then watermark_batch and detect_batch on 4 mono
     and 4 six-channel streams of 60 s: the message in every stream's best
     eligible slot; and the JAX package's API functions of the port on the
     card against the CPU: conv_decode_hard and code_decode_soft (128 bits
     and --short 12) bits and errors exact, candidate_eligibility on
     exact-tie plateaus equal to the CPU's and to the host's
     _select_local_maxima.

Phase 16 also runs detect_batch with the branch metrics in one buffer
(ViterbiDecoder.forward) and in their former list and torch.cat: the
metrics equal bit for bit, and the peak memory of each.

Every phase 9-25 prints one line (20, 21 and 25 one more per mode, row and
file).  Each path (the main path of phases 5-7; the 32 kHz add and get,
the 48 kHz get, the streaming add and its get, the --test-no-sync get, the
32-min add and get, the speed gets, the fleet calls, the gets of phase 17,
the HLS get, the modes' adds and gets at production geometry, the BER
rows, the in-process gets of phase 22, the gets of phase 24, everything
phase 25 runs on the card) has
K1's launch count reset to 0 just before it and read just after: each must
be above 0.  The kernels line gives their sum as `launches` and each of
them in `launches_by_path`.  So does K2's count on each path that
resamples (the 32 kHz add and get, the resample to 48 kHz, the 48 kHz
get, the speed gets, and the card's add and get of each file of phase 25
at another rate than 44.1 kHz, the 48 kHz streaming add among them): reset
just before, above 0 just after, and in K2's entry of the kernels line as
`launches` and `launches_by_path`.

Phase 27 (k2): kernel K2 against its plain version on the card
(`ops/resample._resample_rows_k2` / `_resample_rows_plain`, same
arguments) at the ratios 48 -> 44.1 kHz (48 taps), 44.1 -> 48 kHz (32) and
a speed scan's centre 0.49 (80), each with float64
coefficients (rows an hour into a stream) and float32 (rows from 0), at 1,
3, 1001, 65613 and 4096 x 1024 input frames: the largest difference (at
most 1e-6, the card test's tolerance) and the rows that differ (each check
a line); both writes of a 4096-frame tile of the 48 kHz add timed with
CUDA events, K2 against the plain version and against K2's bound, the
larger of its bytes (at 3.35 TB/s) and its FP64 instructions (counted in
the SASS of its float64 kernel by cuobjdump, at 64 per SM and clock at the
card's largest SM clock), and their sum per second of audio; the
streaming resampler
on the card over 20 s of noise at 48 -> 44.1 and 44.1 -> 48 kHz in one
write and in seeded writes of 1 frame up, bit for bit, and against the
CPU's.  The kernels line gives K2 after K1, with its launches on the other
phases' paths (`launches`) and in phase 27's checks (`check_launches`).

Phase 28 (finish): the streaming add finishes each tile on the card (the
mix, ops/limiter.DeviceStreamingLimiter and, for a 16-bit signed PCM
writer, the trunc-clip to int16): DeviceStreamingLimiter on the card
against the numpy StreamingLimiter, bit for bit, on stereo noise at peak
1.2 at 44.1 and 48 kHz (fixtures.limiter_signal: a first piece of several
blocks, 12 uneven ones, a zero lead-in's skip, flush); the 48 kHz
streaming add of 174 s of known length into 16-bit WAV (two 4096-frame
tiles and the drain) and of 30 s of unknown length into float WAV, each
byte for byte the host finish of its own tiles (fixtures.host_finish:
numpy mix, StreamingLimiter, the writer's encode of float32), counter
`add.finish_i16` (16-bit) or `add.finish_f32` (float) one per tile
written and the other 0.

`python3 chip_smoke.py --new-only` runs phases 1, 2, 27 and 28 alone; it
prints no kernels line.

`python3 chip_smoke.py --cards 4` runs phases 1, 2 and 26 on exactly four
cards (an even N >= 2 cards in general; it fails on a machine with another
count) and prints every card's nvidia-smi line:

 26. cards: the paths that split work over the cards, each called on all
     cards and with AUDIOWMARK_MULTICHIP=0 (one card) in the order one,
     all, all, one, every result equal to the first one-card call's, with
     the walls of each call, K1's and K2's launches per card and the peak
     of allocated memory per card in the first call of each: K1 against
     its plain version on every card at 143 steps and B = 1, 8, 24 and
     256, bit for bit, timed with CUDA events on its card; K2 against its
     plain version on every card (phase 27's check at 48 -> 44.1 kHz with
     float64 coefficients and at a speed scan's centre with float32 ones),
     each launch counted on its card; cmp of the 32-min
     marked file in 6-min chunks (8 chunks: the chunk-group search, groups
     of four, a row per card) and in 30-min chunks, stdout byte-equal;
     cmp --detect-speed and --detect-speed-patient of the 30 s file played
     at 0.9764, stdout equal and the scans' centres split over the cards
     in contiguous shares, K2 launched on every card (on card 0 alone
     with one card), with the host's seconds inside each card's centres,
     beside the scans' walls; watermark_batch of phase 16's
     streams on the (4, 1) mesh and, padded by one frame to an even frame
     count, on the (2, 2) mesh, 0 samples apart from the (1, 1) call;
     detect_batch over the cards, every array equal, K1 launched once on
     each card (with the host's seconds in each card's detector call,
     which enqueues its share and reads nothing back); the command line
     in processes of its own (add of the 200 s fixture, cmp
     --expect-matches 5, get --json, cmp --detect-speed[-patient]) with
     and without AUDIOWMARK_MULTICHIP=0: the marked file's bytes, stdout
     and the JSON text equal.  The kernels line gives K1's launches on the
     paths by card and by path, and its time on every card; and K2's
     launches in the speed scans by card and by path.

Any failed check raises: the script exits non-zero and prints no result.
Without a CUDA device it exits 1 before any work.  On success the line
before the last is the kernels' JSON and the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
import os
import re
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
K1_BATCHES, K1_STEPS = (1, 16, 52), 143
# What the JAX package (jax 0.9.0 on the CPU) prints for phase 14's
# fixtures made by its own command line, {(speed, patient): (detected
# speed, quality)} of its "detect_speed <speed> <quality> <delta %>" line:
#   export AUDIOWMARK_JAX_PLATFORM=cpu M=0123456789abcdef0011223344556677
#   ./audiowmark test-gen-noise n30.wav 30 44100
#   ./audiowmark add n30.wav wm30.wav $M
#   ./audiowmark test-change-speed wm30.wav s.wav <speed>
#   ./audiowmark cmp s.wav $M --detect-speed[-patient] --test-speed <speed>
# A 30 s file is shorter than every scan's clip, so each scan reads all of
# it whatever clip the hash of the samples picks.
JAX_DETECT = {("0.9764", False): (0.976420, 1.267775),
              ("1.0", False): (1.000025, 1.408247),
              ("1.01", False): (1.010022, 1.280683),
              ("0.9764", True): (0.976421, 1.274315)}


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


# K2's launches on each path that resamples, by the path's name (the kernels
# line's `launches_by_path` of K2)
K2_PATHS = {}


def k2_launches_of(path, fn):
    """fn(), with K2's launch count reset just before it; the count must be
    above 0 just after and is kept as K2_PATHS[path].  Not nested: each
    path resets the one count."""
    from audiowmark_tpu_torch.ops import resample
    resample.LAUNCHES = 0
    result = fn()
    K2_PATHS[path] = resample.LAUNCHES
    check(K2_PATHS[path] > 0, "%s never launched K2" % path)
    return result


def k1_check(seed, batch, steps, device="cuda"):
    """K1 vs its plain version on fixtures.acs_check_metrics rows (clean
    codewords, a NaN row, random rows) on `device`; see k1_check_bm."""
    from audiowmark_tpu_torch.fixtures import acs_check_metrics
    return k1_check_bm(acs_check_metrics(seed, batch, steps, device),
                       nan_row=batch >= 4)


def k1_check_bm(bm, nan_row=False):
    """K1 vs its plain version on the branch metrics bm, on bm's card:
    packed and unpacked decisions, metrics (NaN = NaN) and bits exact.
    Returns the check's numbers: ms and plain ms by CUDA events, the bound
    (bytes at 3.35 TB/s) and its share, the cluster size."""
    from audiowmark_tpu_torch.fixtures import acs_equal
    from audiowmark_tpu_torch.ops import viterbi
    batch, steps = bm.shape[:2]
    got = viterbi.viterbi_acs(bm)
    want = viterbi.viterbi_acs_plain(bm)
    check(acs_equal(got, want) and torch.equal(
        viterbi.unpack_decisions(got[0]), viterbi.unpack_decisions(want[0])),
        "K1 differs from the plain version at B=%d" % batch)
    n_nan = int(torch.isnan(got[1]).sum())
    check(not nan_row or n_nan == viterbi.STATE_COUNT,
          "the NaN row's metrics are not NaN")
    # the NaNs sit at the same places (checked above) and count as 0 apart
    max_abs_err = float(torch.nan_to_num(got[1] - want[1]).abs().max())
    del got, want
    with torch.cuda.device(bm.device):       # the events on bm's card
        ms = cuda_ms(lambda: viterbi.viterbi_acs(bm), 20)
        plain_ms = cuda_ms(lambda: viterbi.viterbi_acs_plain(bm), 3)
    bound = viterbi.bound_ms(batch, steps)
    return dict(batch=batch, steps=steps, max_abs_err=max_abs_err,
                nan_metrics=n_nan, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                share=bound / ms, cluster=viterbi.cluster_size(
                    batch, torch.cuda.get_device_properties(bm.device)
                    .multi_processor_count))


def bm_prep_ms(batch, steps):
    """CUDA-event ms of preparing K1's input at (batch, steps) as
    ViterbiDecoder.forward does (codec/convcode.py): one preallocated
    (batch, steps, STATE_COUNT) buffer, and batch_branch_metrics of each
    block type's rows (a, b and ab rows of seeded soft bits) written into
    its slice."""
    from audiowmark_tpu_torch.codec import convcode
    from audiowmark_tpu_torch.ops import viterbi
    dec = convcode.viterbi_decoder("cuda")
    rng = np.random.RandomState(batch)
    groups = []
    for bt, n in zip(convcode.ConvBlockType,
                     (batch - 2 * (batch // 3), batch // 3, batch // 3)):
        if n:
            rate = dec.table(bt).shape[1]
            groups.append((bt, torch.from_numpy(
                rng.rand(n, steps * rate).astype(np.float32)).cuda()))

    def prep():
        bm = torch.empty((batch, steps, viterbi.STATE_COUNT), device="cuda")
        k = 0
        for bt, c in groups:
            convcode.batch_branch_metrics(c, dec.table(bt),
                                          out=bm[k:k + c.shape[0]])
            k += c.shape[0]
        return bm

    check(prep().shape == (batch, steps, viterbi.STATE_COUNT),
          "branch metrics of the wrong shape")
    return cuda_ms(prep, 20)


def set_params(**params):
    from audiowmark_tpu_torch.params import Params
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


def samples_apart(a, b, what):
    """(largest difference in 16-bit LSBs, samples that differ) of two
    sample arrays."""
    check(a.shape == b.shape and np.isfinite(a).all(),
          "%s: lengths differ or samples are not finite" % what)
    lsb = np.abs(np.round((a.astype(np.float64) - b) * 32768))
    return float(lsb.max()), int(np.count_nonzero(lsb))


def phase_resample(port, key, d, smi):
    """9. 200 s at 32 kHz: add, cmp; resample to 48 kHz on the card, cmp.
    Returns K1's launches on each of the two paths; K2's on each of the
    four go to K2_PATHS."""
    from audiowmark_tpu_torch.io.wavdata import WavData
    from audiowmark_tpu_torch.fixtures import gen_noise
    from audiowmark_tpu_torch.ops.resample import resample
    n32, wm32 = os.path.join(d, "n32.wav"), os.path.join(d, "wm32.wav")
    wm48 = os.path.join(d, "wm48.wav")
    t0 = time.perf_counter()
    gen_noise(key, n32, 200, 32000)
    fixture_s = time.perf_counter() - t0

    def path_32k():
        add_s = k2_launches_of("add_32k",
                               lambda: add(port, key, n32, wm32))[0]
        _, get_s, _ = k2_launches_of("get_32k",
                                     lambda: cmp(port, key, wm32, 5))
        return add_s, get_s

    (add_s, get32_s), n32k = launches_of("the 32 kHz path", path_32k)
    t0 = time.perf_counter()
    k2_launches_of("resample_to_48k", lambda: resample(WavData.load(wm32),
                                                       48000).save(wm48))
    resample_s = time.perf_counter() - t0
    (_, get48_s, _), n48k = launches_of(
        "the 48 kHz get",
        lambda: k2_launches_of("get_48k", lambda: cmp(port, key, wm48, 5)))
    phase("resample", match_count_32k=5, match_count_48k=5,
          fixture_s=fixture_s, add_32k_s=add_s, get_32k_s=get32_s,
          resample_to_48k_s=resample_s, get_48k_s=get48_s,
          k1_launches_32k=n32k, k1_launches_48k=n48k, card=smi)
    return {"resample_32k": n32k, "resample_48k": n48k}


def phase_stream_add(port, key, d, smi):
    """10. the 200, 60 and 30 s files through the streaming add vs the
    whole-file add; returns K1's launches over the phase."""
    fields, launches = launches_of("the streaming add path",
                                   lambda: _stream_add(port, key, d))
    phase("stream_add", k1_launches=launches, card=smi, **fields)
    return launches


def _stream_add(port, key, d):
    from audiowmark_tpu_torch import tile_probe
    fields = {}
    for secs in (200, 60, 30):
        wav = os.path.join(d, "n%d.wav" % secs)
        for lim in (True, False):
            r = tile_probe.whole_vs_stream(wav, lim)
            what = "%d s, %s the limiter" % (secs, "with" if lim else
                                            "without")
            check(info_line(r["info_whole"], "Data Blocks")
                  == info_line(r["info_stream"], "Data Blocks"),
                  "%s: Data Blocks differ between the streaming and "
                  "whole-file add" % what)
            if lim:
                check(r["largest_lsb"] <= 1
                      and r["lsb_apart"] < 1e-3 * r["samples"],
                      "streaming add, %s: %d of %d samples up to %g LSB "
                      "from the whole-file add" % (
                          what, r["lsb_apart"], r["samples"],
                          r["largest_lsb"]))
            else:
                check(r["lsb_apart"] == 0, "streaming add, %s: %d samples "
                      "differ from the whole-file add" % (what,
                                                          r["lsb_apart"]))
            fields["%ds_%s" % (secs, "limiter" if lim else "no_limiter")] = {
                k: r[k] for k in ("lsb_apart", "largest_lsb", "samples",
                                  "whole_s", "stream_s")}
            if secs == 200 and lim:
                marked = r
    _, get_s, _ = cmp(port, key, marked["stream"], 5)
    return dict(snr=info_line(marked["info_stream"], "SNR"),
                data_blocks=info_line(marked["info_stream"], "Data Blocks"),
                get_s=get_s, match_count=5, **fields)


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
    from audiowmark_tpu_torch.io.wavdata import WavData
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


def batches_of(fn, keep=None):
    """(fn(), the (B, steps) shapes the decoders gave K1 while it ran);
    keep: a list that receives the last of those branch-metric tensors."""
    from audiowmark_tpu_torch.codec import convcode
    shapes, acs = [], convcode.viterbi_acs

    def recording(bm):
        shapes.append(tuple(bm.shape[:2]))
        if keep is not None:
            keep[:] = [bm]
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
    from audiowmark_tpu_torch.params import Params
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
          k1_check=k1, card=smi)
    return launches, k1


def phase_speed(port, key, d, smi):
    """14. replay-speed detection on the 30 s marked file at three speeds;
    returns K1's launches over its gets and K1's check at their largest
    batch."""
    from audiowmark_tpu_torch.io.wavdata import WavData
    from audiowmark_tpu_torch.models import speed as speed_model
    from audiowmark_tpu_torch.ops import speed as speed_ops
    from audiowmark_tpu_torch.ops.resample import resample_ratio
    from audiowmark_tpu_torch.tables import get_key_tables
    marked = WavData.load(os.path.join(d, "wm30.wav"))
    files = {}
    for speed in ("0.9764", "1.0", "1.01"):
        files[speed] = os.path.join(d, "speed_%s.wav" % speed)
        resample_ratio(marked, 1 / float(speed), 44100).save(files[speed])

    # detect_speed alone, synchronised: the first call of its kind in the
    # process, a warm one, and one with the resampler timed apart
    set_params()
    slow = WavData.load(files["0.9764"])
    times = {}
    for name, patient in (("normal", False), ("patient", True)):
        set_params(detect_speed_patient=patient)
        for run in ("first", "warm"):
            found, times["%s_%s_s" % (name, run)] = timed(
                lambda: speed_model.detect_speed([key], slow, False))
            check(len(found) == 1 and abs(found[0][1] / 0.9764 - 1) < 5e-4,
                  "detect_speed (%s) found %s" % (name, found))
        in_resampler, resample = [0.0], speed_ops.resample_frames

        def timed_resample(x, ratio):
            out, s = timed(lambda: resample(x, ratio))
            in_resampler[0] += s
            return out

        torch.cuda.synchronize()
        speed_ops.resample_frames = timed_resample
        try:
            _, whole = timed(
                lambda: speed_model.detect_speed([key], slow, False))
        finally:
            speed_ops.resample_frames = resample
        times["%s_resampler_share" % name] = in_resampler[0] / whole
    set_params()

    # the whole scan vs the staged pair, on the card
    bits = speed_ops.build_speed_sync_bits(get_key_tables(key))
    clip = slow.samples[:2 * 12 * 44100]
    centers = [0.9764 * 1.0007 ** c for c in (-11, 0, 11)]
    rels = [1.0007 ** p for p in range(-2, 3)]
    scan = speed_ops.speed_scan(clip, 2, centers, 10.0, rels, bits)
    staged = [speed_ops.compare_speed_batch(
        speed_ops.prepare_mag_matrix(clip, 2, c, 10.0, bits), bits, rels, c)
        for c in centers]
    scan_err = max(abs(q - sq) for row, srow in zip(scan, staged)
                   for (q, _), (sq, _) in zip(row, srow))
    check(scan_err <= 1e-4 and max(q for row in scan for q, _ in row) > 0
          and [[sp for _, sp in row] for row in scan]
          == [[sp for _, sp in row] for row in staged],
          "speed_scan is %g from the staged pair" % scan_err)

    def gets():
        fields = {}
        for speed, patient in JAX_DETECT:
            option = "detect_speed_patient" if patient else "detect_speed"
            _, get_s, text = cmp(port, key, files[speed], 1,
                                 test_speed=float(speed), **{option: True})
            lines = text.splitlines()
            found = [line.split() for line in lines
                     if line.startswith("detect_speed ")]
            check(len(found) == 1, "no detect_speed line in:\n" + text)
            got, quality = float(found[0][1]), float(found[0][2])
            want, want_quality = JAX_DETECT[(speed, patient)]
            check(abs(got / float(speed) - 1) < 5e-4 and quality > 0.4,
                  "detect_speed %s at speed %s" % (found[0], speed))
            check(abs(got - want) <= 5e-6 and abs(quality - want_quality)
                  <= 1e-3, "detect_speed %s, the JAX package %s"
                  % (found[0], JAX_DETECT[(speed, patient)]))
            speed_lines = [line for line in lines
                           if line.startswith("speed ")]
            with_speed = [line.split() for line in lines
                          if line.startswith("pattern") and "SPEED" in line]
            if speed == "1.0":
                check(not speed_lines and not with_speed,
                      "a speed result at speed 1.0:\n" + text)
            else:
                check(len(speed_lines) == 1 and with_speed
                      and any(f[2] == MSG for f in with_speed),
                      "no speed result at speed %s:\n%s" % (speed, text))
            name = option + "_" + speed
            fields[name] = dict(speed=got, quality=quality, get_s=get_s,
                                jax_speed=want, jax_quality=want_quality)
        _, get_s, text = cmp(port, key, files["1.01"], 1, try_speed=1.01)
        check("\nspeed 1.010000\n" in text and "detect_speed" not in text
              and "-SPEED" in text, "--try-speed 1.01:\n" + text)
        fields["try_speed_1.01"] = dict(get_s=get_s)
        return fields

    (fields, shapes), launches = launches_of(
        "the speed gets",
        lambda: k2_launches_of("speed_gets", lambda: batches_of(gets)))
    # every get launches K1 twice: the decodes at its speed, then at speed 1
    # (once where no speed was found)
    check(launches == len(shapes) == 2 * len(JAX_DETECT) + 1,
          "the speed gets launched K1 %d times" % launches)
    batch, steps = max(shapes)
    k1 = k1_check(3, batch, steps)
    phase("speed", scan_vs_staged=scan_err, k1_launches=launches,
          k1_batches=sorted(set(shapes)), k1_check=k1, card=smi,
          **times, **fields)
    return launches, k1


def card_env():
    """The environment without a device setting: the port's command line
    runs on the card."""
    return {k: v for k, v in os.environ.items()
            if k != "AUDIOWMARK_TORCH_DEVICE"}


def phase_cli(d, smi):
    """15. the port's command line in processes of its own, on the card;
    returns each process's wall s."""
    env = card_env()
    noise, wm = os.path.join(d, "cli_n.wav"), os.path.join(d, "cli_wm.wav")
    out_json = os.path.join(d, "cli.json")
    seconds = {}

    def run(name, args, rc):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "audiowmark_tpu_torch"] + args, cwd=REPO,
            env=env, capture_output=True, text=True, timeout=600)
        seconds[name + "_s"] = time.perf_counter() - t0
        check(proc.returncode == rc, "%s: exit %d, not %d:\n%s\n%s" % (
            " ".join(args), proc.returncode, rc, proc.stdout, proc.stderr))
        return proc

    run("gen_noise", ["test-gen-noise", noise, "200", "44100"], 0)
    with open(noise, "rb") as a, open(os.path.join(d, "n200.wav"), "rb") as b:
        check(a.read() == b.read(), "test-gen-noise differs from gen_noise")
    proc = run("add", ["add", noise, wm, MSG], 0)
    check("Data Blocks:" in proc.stderr, "add printed:\n" + proc.stderr)
    proc = run("cmp", ["cmp", wm, MSG, "--expect-matches", "5"], 0)
    check("\nmatch_count 5 " in proc.stdout
          and "expect_matches 5" in proc.stdout, "cmp printed:\n" + proc.stdout)
    run("cmp_4", ["cmp", wm, MSG, "--expect-matches", "4"], 1)
    run("get_json", ["get", wm, "--json", out_json], 0)
    with open(out_json) as f:
        matches = json.load(f)["matches"]
    check(sum(m["bits"] == MSG for m in matches) == 5,
          "get --json gave %s" % matches)
    proc = run("missing", ["get", os.path.join(d, "missing.wav")], 1)
    check(proc.stderr.startswith("audiowmark: error loading ")
          and "Traceback" not in proc.stderr, "get of a missing file:\n"
          + proc.stderr)
    phase("cli", match_count=5, json_matches=len(matches), card=smi,
          **seconds)
    return seconds


FLEET_STREAMS, FLEET_SECONDS, FLEET_TOP_K = 16, 60, 8


def forward_cat(self, groups):
    """ViterbiDecoder.forward as it was before its branch metrics went into
    one buffer: each group's metrics in a list, then their torch.cat
    (phase 16 compares the two)."""
    from audiowmark_tpu_torch.codec import convcode
    bms = [convcode.batch_branch_metrics(c, self.table(bt))
           for bt, c in groups]
    n_coded = torch.cat([
        torch.full((c.shape[0],), float(c.shape[1]), dtype=torch.float32,
                   device=c.device) for _, c in groups])
    _, metrics, bits = convcode.viterbi_acs(torch.cat(bms, dim=0)
                                            .contiguous())
    return bits, metrics[:, 0] / n_coded


def phase_fleet(key, smi):
    """16. watermark_batch then detect_batch on 16 x 60 s.  Returns K1's
    launches over the fleet calls, K1's check on the branch metrics that
    detect_batch gave it, and the marked batch."""
    from audiowmark_tpu_torch.io.wavdata import WavData
    from audiowmark_tpu_torch.models import syncfinder as sf
    from audiowmark_tpu_torch.models.common import parse_payload
    from audiowmark_tpu_torch.ops import detect_fused
    from audiowmark_tpu_torch.codec import convcode
    from audiowmark_tpu_torch.parallel import batch as fleet
    from audiowmark_tpu_torch.params import Params
    set_params()
    B, K = FLEET_STREAMS, FLEET_TOP_K
    n = FLEET_SECONDS * 44100
    rng = np.random.default_rng(16)
    audio = (rng.random((B, n, 2), dtype=np.float32) - np.float32(0.5)) \
        * np.float32(0.6)
    audio_s = float(B * FLEET_SECONDS)
    kept = []

    def calls():
        t = {}
        marked, t["watermark_first_s"] = timed(
            lambda: fleet.watermark_batch(key, audio, MSG))
        marked, t["watermark_warm_s"] = timed(
            lambda: fleet.watermark_batch(key, audio, MSG))
        out, t["detect_first_s"] = timed(
            lambda: fleet.detect_batch(key, marked, top_k=K))
        out, t["detect_warm_s"] = timed(
            lambda: fleet.detect_batch(key, marked, top_k=K))
        return marked, out, t

    ((marked, out, times), shapes), launches = launches_of(
        "the fleet path", lambda: batches_of(calls, kept))
    steps = (Params.payload_size + 15)
    check(launches == 2 and shapes == [(B * 2 * K, steps)] * 2,
          "detect_batch gave K1 %s in %d launches" % (shapes, launches))
    check(marked.shape == audio.shape and np.isfinite(marked).all()
          and float(np.abs(marked - audio).max()) > 1e-4,
          "watermark_batch returned something else than marked audio")

    want = parse_payload(MSG).tolist()
    expect0 = Params.frames_pad_start * 1024
    for b in range(B):
        q = np.where(out["eligible"][b], out["qualities"][b], -1.0)
        best = int(np.argmax(q))
        check(q[best] > Params.sync_threshold2
              and abs(int(out["positions"][b][best]) - expect0) < 512
              and bool(out["block_is_a"][b][best])
              and out["bits"][b][best].tolist() == want,
              "stream %d: best slot %d at %d, quality %g, errors %g" % (
                  b, best, out["positions"][b][best], q[best],
                  out["errors"][b][best]))
    check(out["bits"].shape == (B, K, Params.payload_size)
          and np.isfinite(out["qualities"]).all(), "detect_batch's shapes")

    # stream 0 against the CLI search on the same samples: the detector
    # keeps the top K of the approximate scores and the CLI the n best of
    # the refined ones, so the sets differ below the threshold; what is
    # above it must be the same candidates
    wav = WavData(marked[0].reshape(-1).copy(), 2, 44100, 16)
    cli = {(s.index, s.block_type.name): s.quality
           for s in sf.search([key], wav, sf.SyncMode.BLOCK)[0].sync_scores}
    det = {(int(p), "a" if a else "b"): float(q) for p, a, q, e in zip(
        out["positions"][0], out["block_is_a"][0], out["qualities"][0],
        out["eligible"][0]) if e}
    above = {k: q for k, q in det.items() if q > Params.sync_threshold2}
    common = set(cli) & set(det)
    check(above and set(above) <= set(cli)
          and max(cli, key=cli.get) == max(det, key=det.get)
          and all(abs(cli[k] - det[k]) <= 2e-4 * det[k] + 2e-5
                  for k in common),
          "stream 0: detector %s, CLI search %s" % (det, cli))

    # K1 on the very branch metrics detect_batch gave it
    k1 = k1_check_bm(kept.pop())

    # the branch metrics in one buffer (ViterbiDecoder.forward) vs the
    # former list and torch.cat: the same metrics bit for bit, and the
    # peak memory of a detect_batch above what was allocated before it
    one_buffer, peak, metrics = convcode.ViterbiDecoder.forward, {}, {}
    for name, forward in (("cat", forward_cat), ("one_buffer", one_buffer)):
        convcode.ViterbiDecoder.forward = forward
        try:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            batches_of(lambda: fleet.detect_batch(key, marked, top_k=K),
                       kept)
            torch.cuda.synchronize()
            peak[name] = torch.cuda.max_memory_allocated() - base
        finally:
            convcode.ViterbiDecoder.forward = one_buffer
        metrics[name] = kept.pop()
    check(torch.equal(metrics["cat"], metrics["one_buffer"]),
          "the branch metrics in one buffer differ from their torch.cat")
    del metrics

    # where a third detect_batch spends its time: each stage synchronised
    spent = {"refine": 0.0, "extract": 0.0, "viterbi": 0.0}
    refine, extract = detect_fused.refine_grid_scores, detect_fused.block_raw
    forward = convcode.ViterbiDecoder.forward

    def clocked(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            r, s = timed(lambda: fn(*a, **kw))
            spent[name] += s
            return r
        return run

    detect_fused.refine_grid_scores = clocked("refine", refine)
    detect_fused.block_raw = clocked("extract", extract)
    convcode.ViterbiDecoder.forward = clocked("viterbi", forward)
    try:
        _, whole = timed(lambda: fleet.detect_batch(key, marked, top_k=K))
    finally:
        detect_fused.refine_grid_scores = refine
        detect_fused.block_raw = extract
        convcode.ViterbiDecoder.forward = forward
    phase("fleet", streams=B, seconds_each=FLEET_SECONDS, top_k=K,
          frames=n // 1024, k1_launches=launches, k1_batches=shapes,
          k1_check=k1, eligible_stream0=len(det),
          above_threshold_stream0=len(above), cli_scores_stream0=len(cli),
          common_stream0=len(common),
          watermark_audio_s_per_s=audio_s / times["watermark_warm_s"],
          detect_audio_s_per_s=audio_s / times["detect_warm_s"],
          instrumented_detect_s=whole,
          refine_share=spent["refine"] / whole,
          extract_share=spent["extract"] / whole,
          viterbi_share=spent["viterbi"] / whole,
          peak_bytes_cat=peak["cat"], peak_bytes_one_buffer=peak["one_buffer"],
          card=smi, **times)
    return launches, k1, marked


def score_tuples(key_results):
    return [[(s.index, s.block_type.name, s.quality) for s in kr.sync_scores]
            for kr in key_results]


def phase_group(port, key, d, marked, smi):
    """17. the sharded embed, the group and pair searches and the prefetch
    thread against their serial forms, with logical devices on the one
    card.  Returns K1's launches over the phase's gets."""
    from audiowmark_tpu_torch.io.wavdata import WavData
    from audiowmark_tpu_torch.models import syncfinder as sf
    from audiowmark_tpu_torch.models.chunkloader import WavChunkLoader
    from audiowmark_tpu_torch.models.decoder import ClipDecoder
    from audiowmark_tpu_torch.ops import search_fused
    from audiowmark_tpu_torch.parallel.mesh import (batch_embed_sharded,
                                                    make_mesh)
    fields = {}

    # ---- the sharded embed: (2, 2) logical shards vs one ----
    T = marked.shape[1] // 1024 // 2 * 2
    frames = torch.from_numpy(marked[:4, :T * 1024]).reshape(
        4, T, 1024, 2).transpose(2, 3)
    mods = torch.from_numpy(np.random.default_rng(17).integers(
        -1, 2, size=(4, T, 513)).astype(np.int8))
    one, fields["embed_1x1_s"] = timed(lambda: batch_embed_sharded(
        make_mesh(1), frames, mods, 0.01))
    mesh = make_mesh(4, dp=2)
    check(mesh.shape == (2, 2) and make_mesh(4).shape == (4, 1),
          "make_mesh(4, dp=2) is %s" % (mesh.shape,))
    four, fields["embed_2x2_s"] = timed(lambda: batch_embed_sharded(
        mesh, frames, mods, 0.01))
    apart = int(torch.count_nonzero(one != four))
    check(apart == 0 and float((one - frames.cuda()).abs().max()) > 1e-4,
          "the (2, 2) embed is %d samples from the (1, 1) one" % apart)
    fields["embed_samples_apart"] = apart
    del one, four, frames, mods

    # ---- group search on two 6-min chunks of the 32-min file ----
    wm = os.path.join(d, "wmlong.wav")
    set_params(get_chunk_size=6.0)
    loader = WavChunkLoader(wm)
    chunks = []
    for _ in range(2):
        loader.load_next_chunk()
        wav = loader.wav_data()
        chunks.append(wav.with_samples(wav.samples))
    loader.close()
    check(all(search_fused.bucket_frames(c.n_frames // 1024 + 1)
              <= search_fused.MAX_FUSED_FRAMES for c in chunks),
          "a 6-min chunk is past the whole-stream search")
    count = sf.group_device_count
    check(count() == 1, "group_device_count() is %d on one card" % count())
    sf.group_device_count = lambda device=None: 2
    try:
        group, fields["group_search_s"] = timed(
            lambda: sf.search_block_group([key], chunks))
    finally:
        sf.group_device_count = count
    check(group is not None, "search_block_group declined")
    singles, fields["per_chunk_search_s"] = timed(
        lambda: [sf.search([key], c, sf.SyncMode.BLOCK) for c in chunks])
    for got, want in zip(group, singles):
        check(score_tuples(got) == score_tuples(want) and got[0].sync_scores,
              "group search %s, per chunk %s"
              % (score_tuples(got), score_tuples(want)))
    fields["group_scores"] = [len(g[0].sync_scores) for g in group]

    # ---- clip pair on the 60 s file's windows ----
    set_params()
    wav60 = WavData.load(os.path.join(d, "wm60.wav"))
    windows = [ClipDecoder(1)._build_window([key], wav60, pos)[0]
               for pos in ("start", "end")]
    pair, fields["clip_pair_s"] = timed(
        lambda: sf.search_clip_pair([key], windows))
    check(pair is not None, "search_clip_pair declined")
    per_window, fields["per_window_s"] = timed(
        lambda: [sf.search([key], w, sf.SyncMode.CLIP) for w in windows])
    for got, want in zip(pair, per_window):
        check(score_tuples(got) == score_tuples(want),
              "clip pair %s, per window %s"
              % (score_tuples(got), score_tuples(want)))
    fields["clip_scores"] = [len(p[0].sync_scores) for p in pair]

    # ---- the 32-min cmp: prefetch off, on, on, off; then in groups ----
    def gets():
        texts, walls = {}, {}
        for i, flag in enumerate("0110"):
            os.environ["AUDIOWMARK_PREFETCH"] = flag
            _, walls["cmp_prefetch%s_run%d_s" % (flag, i)], text = cmp(
                port, key, wm, None)
            texts.setdefault(flag, text)
            check(text == texts[flag], "two runs of one get differ")
        check(texts["0"] == texts["1"] and "pattern" in texts["0"],
              "cmp prints another report with the prefetch thread:\n%s\n%s"
              % (texts["0"], texts["1"]))
        _, walls["cmp_6min_serial_s"], serial = cmp(
            port, key, wm, None, get_chunk_size=6.0)
        sf.group_device_count = lambda device=None: 2
        try:
            _, walls["cmp_6min_groups_s"], grouped = cmp(
                port, key, wm, None, get_chunk_size=6.0)
        finally:
            sf.group_device_count = count
        check(grouped == serial and "pattern" in serial,
              "cmp in groups of two prints another report:\n%s\n%s"
              % (serial, grouped))
        return walls

    try:
        walls, launches = launches_of("the gets of phase 17", gets)
    finally:
        os.environ.pop("AUDIOWMARK_PREFETCH", None)
    phase("group", k1_launches=launches, card=smi, **fields, **walls)
    return launches


HLS_SEGMENTS = 20


def hls_without_codec(port, key, d, smi):
    """18. where the codec shim does not load: hls-add's work apart from
    AAC and MPEG-TS.  Every ~10 s segment of the 200 s fixture, with the
    context hls-prepare gives it (up to 3 s before, 3 s after, through
    the FLAC round trip), goes through add_stream_watermark on the card
    at zero_frames = start_pos - prev_size; the context is cut as
    HLSOutputStream cuts it, the segments are joined as PCM and cmp finds
    the message (a block spans five segments, so it decodes only if every
    segment took its place in the stream's timeline).  Returns K1's
    launches of the get."""
    from audiowmark_tpu_torch.hls import hls
    from audiowmark_tpu_torch.io.streams import AudioOutputStream
    from audiowmark_tpu_torch.io.wavdata import WavData
    from audiowmark_tpu_torch.models.embedder import add_stream_watermark
    ldd = subprocess.run(
        ["ldd", os.path.join(REPO, "native", "libffshim.so")],
        capture_output=True, text=True).stdout
    not_found = sorted(line.split()[0] for line in ldd.splitlines()
                       if "not found" in line)

    class Collect(AudioOutputStream):
        def __init__(self):
            self.parts = []

        def sample_rate(self):
            return rate

        def n_channels(self):
            return ch

        def write_frames(self, samples):
            self.parts.append(np.array(samples, dtype=np.float32))

        def close(self):
            pass

    rate, ch = 44100, 2
    seg = (10 * rate // 1024) * 1024
    total, ctx = seg * HLS_SEGMENTS, 3 * rate
    master = WavData.load(os.path.join(d, "n200.wav")).samples[:total * ch]
    check(master.size == total * ch, "the 200 s fixture is too short")
    flac_s, add_s, kept = 0.0, [], []
    for k in range(HLS_SEGMENTS):
        start = k * seg
        prev = min(start, ctx)
        signal = np.zeros((prev + seg + ctx) * ch, dtype=np.float32)
        src = master[(start - prev) * ch:(start + seg + ctx) * ch]
        signal[:src.size] = src
        wav, s = timed(lambda: hls._flac_decode(
            hls._flac_encode(signal, ch, rate)))
        flac_s += s
        out = Collect()
        set_params()
        with contextlib.redirect_stderr(io.StringIO()):
            rc, s = timed(lambda: add_stream_watermark(
                key, hls.MemoryInputStream(wav), out, MSG, start - prev))
        add_s.append(s)
        marked = np.concatenate(out.parts)
        check(rc == 0 and marked.size >= (prev + seg) * ch
              and np.isfinite(marked).all(),
              "segment %d: exit %d, %d values" % (k, rc, marked.size))
        kept.append(marked[prev * ch:(prev + seg) * ch])
    joined = os.path.join(d, "hls_pcm.wav")
    WavData(np.concatenate(kept), ch, rate, 16).save(joined)
    (rc, get_s, text), launches = launches_of(
        "the HLS get", lambda: cmp(port, key, joined, None))
    counts = [line.split() for line in text.splitlines()
              if line.startswith("match_count")]
    check(rc == 0 and len(counts) == 1 and int(counts[0][1]) >= 1,
          "cmp of the joined segments:\n" + text)
    # the whole-file add of the same audio marks the same timeline
    whole = WavData.load(os.path.join(d, "wm.wav")).samples[:total * ch]
    lsb = np.abs(np.round((WavData.load(joined).samples.astype(np.float64)
                           - whole) * 32768))
    phase("hls", ffshim_available=False, not_found=not_found,
          segments=HLS_SEGMENTS, segment_frames=seg, flac_round_trip_s=flac_s,
          add_first_s=add_s[0], add_mean_s=float(np.mean(add_s[1:])),
          add_total_s=float(sum(add_s)), get_s=get_s,
          match_count=int(counts[0][1]), patterns=int(counts[0][2]),
          lsb_from_whole_file_add_max=float(lsb.max()),
          lsb_from_whole_file_add_samples=int(np.count_nonzero(lsb)),
          samples=int(lsb.size), k1_launches=launches, card=smi)
    return launches


def phase_hls(port, key, d, smi):
    """18. HLS: segments, hls-prepare, hls-add on the card, cmp.  Returns
    K1's launches of the get."""
    from audiowmark_tpu_torch import cli
    from audiowmark_tpu_torch.io import ffshim
    from audiowmark_tpu_torch.io.wavdata import WavData
    available = bool(ffshim.available())
    if not available:
        return hls_without_codec(port, key, d, smi)
    rate, ch, n_segments = 44100, 2, 20
    seg_frames = (10 * rate // 1024) * 1024
    master = WavData.load(os.path.join(d, "n200.wav"))
    total = seg_frames * n_segments
    check(master.n_frames >= total, "the 200 s fixture is too short")
    samples = master.samples[: total * ch]
    hls = os.path.join(d, "hls")
    in_dir, prep, out = (os.path.join(hls, n) for n in ("in", "prep", "wm"))
    os.makedirs(in_dir)
    os.makedirs(out)
    master_path = os.path.join(hls, "master.wav")
    WavData(samples, ch, rate, 16).save(master_path)
    t0 = time.perf_counter()
    names = ["out%d.ts" % k for k in range(n_segments)]
    for k, name in enumerate(names):
        w = ffshim.HLSSegmentWriter(
            os.path.join(in_dir, name), rate, ch, 192000, 0,
            seg_frames // 1024, pts_start=k * seg_frames / rate)
        w.write(samples[k * seg_frames * ch:(k + 1) * seg_frames * ch])
        w.close()
    lines = ["#EXTM3U", "#EXT-X-VERSION:3", "#EXT-X-TARGETDURATION:11",
             "#EXT-X-MEDIA-SEQUENCE:0"]
    for name in names:
        lines += ["#EXTINF:%.6f," % (seg_frames / rate), name]
    with open(os.path.join(in_dir, "out.m3u8"), "w") as f:
        f.write("\n".join(lines + ["#EXT-X-ENDLIST"]) + "\n")
    segment_s = time.perf_counter() - t0

    def command(*argv):
        set_params()
        info = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(info):
            rc = cli.main(list(argv))
        torch.cuda.synchronize()
        check(rc == 0, "%s: exit %d\n%s" % (" ".join(argv), rc,
                                            info.getvalue()))
        set_params()
        return time.perf_counter() - t0

    check("AUDIOWMARK_TORCH_DEVICE" not in os.environ,
          "the hls commands would not run on the card")
    prepare_s = command("hls-prepare", in_dir, prep, "out.m3u8", master_path)
    add_s = [command("hls-add", os.path.join(prep, name),
                     os.path.join(out, name), MSG) for name in names]
    decoded = []
    for k, name in enumerate(names):
        dec, dch, drate = ffshim.decode_file(os.path.join(out, name))
        check((dch, drate) == (ch, rate) and dec.size == seg_frames * ch,
              "%s decodes to %d values" % (name, dec.size))
        decoded.append(dec)
    joined = os.path.join(hls, "wm.wav")
    WavData(np.concatenate(decoded), ch, rate, 16).save(joined)
    (rc, get_s, text), launches = launches_of(
        "the HLS get", lambda: cmp(port, key, joined, None))
    counts = [line.split() for line in text.splitlines()
              if line.startswith("match_count")]
    check(rc == 0 and len(counts) == 1 and int(counts[0][1]) >= 1,
          "cmp of the joined HLS segments:\n" + text)
    phase("hls", ffshim_available=True, segments=n_segments,
          segment_frames=seg_frames, make_segments_s=segment_s,
          prepare_s=prepare_s, add_first_s=add_s[0],
          add_mean_s=float(np.mean(add_s[1:])), add_total_s=float(sum(add_s)),
          get_s=get_s, match_count=int(counts[0][1]),
          patterns=int(counts[0][2]), k1_launches=launches, card=smi)
    return launches


def phase_profile(d, smi):
    """19. AUDIOWMARK_PROFILE around a cmp in a process of its own."""
    env = {k: v for k, v in os.environ.items()
           if k != "AUDIOWMARK_TORCH_DEVICE"}
    trace_dir = os.path.join(d, "trace")
    env["AUDIOWMARK_PROFILE"] = trace_dir
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "audiowmark_tpu_torch", "cmp",
         os.path.join(d, "wm.wav"), MSG, "--expect-matches", "5"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=600)
    process_s = time.perf_counter() - t0
    check(proc.returncode == 0 and "\nmatch_count 5 " in proc.stdout,
          "the traced cmp: exit %d\n%s\n%s" % (proc.returncode, proc.stdout,
                                               proc.stderr[-2000:]))
    traces = [n for n in os.listdir(trace_dir) if n.endswith(".json")]
    check(len(traces) == 1, "traces written: %s" % traces)
    path = os.path.join(trace_dir, traces[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "viterbi_acs" in e.get("name", "")]
    check(k1, "no viterbi_acs kernel event among %d kernel events"
          % len(kernels))
    phase("profile", process_s=process_s, trace_bytes=os.path.getsize(path),
          events=len(events), kernel_events=len(kernels),
          viterbi_acs_events=len(k1),
          viterbi_acs_us=[e.get("dur") for e in k1], card=smi)


MSG2 = "0123456789abcdef0123456789abcdef"
SHORT = {12: "abc", 16: "abcd", 20: "abcde"}
# marked files of phase 20: name -> (input, [(test key or None, message,
# settings)] of its adds, in turn)
MODE_ADDS = {
    "default": ("n", [(None, MSG, {})]),
    "linear": ("n", [(None, MSG, dict(mix=False))]),
    "fpb4": ("n", [(None, MSG, dict(frames_per_bit=4))]),
    "24bit": ("n24", [(None, MSG, {})]),
    "double": ("n", [(None, MSG, {}), (9, MSG2, {})]),
}
MODE_ADDS.update({"short%d" % k: ("n", [(None, m, dict(
    payload_size=k, payload_short=True))]) for k, m in SHORT.items()})
# phase 20's modes: name -> (marked file, cut-start frames, [(test keys,
# message ("" for a get), settings, match count on 200 s at production
# geometry: the reference's)] of its gets).  The counts are those of
# tests/test_modes.py (--linear 5 and 0 with mix, --frames-per-bit 4 6),
# tests/test_end_to_end.py (cut-start 882300 frames 3) and the 200 s file's
# 5; None: no count (a get, or --short, where every pattern must be the
# payload, tests/test_short_payload_e2e.py:33-40)
MODES = {
    "hard": ("default", 0, [([None], MSG, dict(hard=True), 5)]),
    "linear": ("linear", 0, [([None], MSG, dict(mix=False), 5),
                             ([None], MSG, {}, 0)]),
    "frames_per_bit_4": ("fpb4", 0, [([None], MSG, dict(frames_per_bit=4),
                                      6)]),
    "two_keys_one_get": ("double", 0, [([None, 9], "", {}, None)]),
    "double_watermark": ("double", 0, [([None], MSG, {}, 5),
                                       ([9], MSG2, {}, 5)]),
    "wrong_key": ("default", 0, [([5], MSG, {}, 0)]),
    "24bit": ("24bit", 0, [([None], MSG, {}, 5)]),
    "cut_start": ("default", 882300, [([None], MSG, {}, 3)]),
}
MODES.update({"short_%d" % k: ("short%d" % k, 0, [([None], m, dict(
    payload_size=k, payload_short=True), None)]) for k, m in SHORT.items()})
REDUCED = dict(sync_frames_per_bit=30, frames_per_bit=1)


def mode_key(test_key):
    from audiowmark_tpu_torch.crypto.keys import Key
    key = Key()
    if test_key is not None:
        key.set_test_key(test_key)
    return key


def make_mode_files(port, d, inputs, tag, base):
    """Every marked file of MODE_ADDS from `inputs` ({"n": 16-bit, "n24":
    24-bit}) under `base` settings on the card; {name: path}, and the add
    walls."""
    paths, walls = {}, {}
    for name, (src, adds) in MODE_ADDS.items():
        path = inputs[src]
        t0 = time.perf_counter()
        for i, (test_key, msg, settings) in enumerate(adds):
            out = os.path.join(d, "%s_%s_%d.wav" % (tag, name, i))
            set_params(**{**base, **settings})
            with contextlib.redirect_stderr(io.StringIO()):
                rc = port.add_watermark(mode_key(test_key), path, out, msg)
            check(rc == 0, "%s add of %s" % (tag, name))
            path = out
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        paths[name] = path
    set_params()
    return paths, walls


def mode_gets(port, path, gets, base, device=None):
    """[(rc, stdout)] of the mode's gets of `path` under `base` settings."""
    reports = []
    for test_keys, msg, settings, _ in gets:
        set_params(**{**base, **settings})
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = port.get_watermark([mode_key(k) for k in test_keys], path,
                                    msg, device)
        if device is None:
            torch.cuda.synchronize()
        reports.append((rc, out.getvalue()))
    set_params()
    return reports


def cut_file(path, frames, d, tag):
    from audiowmark_tpu_torch.cli import cut_start
    if not frames:
        return path
    out = os.path.join(d, "%s_cut.wav" % tag)
    check(cut_start(path, out, str(frames)) == 0, "cut-start of " + path)
    return out


def report_fields(text):
    """(exact fields, (quality, error)) of each pattern line, and the
    match_count and key lines."""
    exact, floats = [], []
    for line in text.splitlines():
        f = line.split()
        if f and f[0] == "pattern":
            exact.append((f[1], f[2]) + tuple(f[5:]))
            floats.append((float(f[3]), float(f[4])))
    return exact, floats, [line for line in text.splitlines()
                           if line.startswith(("match_count", "key "))]


def same_report(got, want):
    """The slice test's rule: exit codes, pattern times, bits and types,
    match_count and key lines equal; qualities and errors within 0.002.
    Returns the largest float difference, or None where the reports
    differ."""
    worst = 0.0
    for (g_rc, g), (w_rc, w) in zip(got, want):
        ge, gf, gc = report_fields(g)
        we, wf, wc = report_fields(w)
        if g_rc != w_rc or ge != we or gc != wc:
            return None
        worst = max([worst] + [abs(a - b) for x, y in zip(gf, wf)
                               for a, b in zip(x, y)])
    return worst if worst <= 0.002 else None


def check_mode(name, reports, gets):
    """What the reference's tests hold of the mode, on production
    geometry; returns the match counts."""
    counts = []
    for (rc, text), (test_keys, msg, settings, expect) in zip(reports, gets):
        lines = [line.split() for line in text.splitlines()
                 if line.startswith("match_count")]
        counts.append(int(lines[0][1]) if lines else None)
        if expect is not None:
            check(counts[-1] == expect and rc == (0 if expect else 1),
                  "%s: expected match_count %d, got exit %d:\n%s"
                  % (name, expect, rc, text))
        if "payload_short" in settings:
            patterns = [line for line in text.splitlines()
                        if line.startswith("pattern")]
            check(rc == 0 and patterns and counts[-1] >= 1
                  and all(msg in p for p in patterns),
                  "%s: a pattern that is not %s:\n%s" % (name, msg, text))
        if not msg:
            check(rc == 0 and "key test-key-9" in text and MSG in text
                  and MSG2 in text, "%s: both messages under their keys "
                  "not found:\n%s" % (name, text))
    return counts


def phase_modes(port, d, smi, checks):
    """20. the command line's modes on the card: production geometry on
    the 200 s file with the reference's match counts, K1 at the shapes
    they give it, and at the reduced geometry the card's reports against
    the port's CPU reports of the same files.  Returns K1's launches over
    the card's adds and gets."""
    from audiowmark_tpu_torch.io.wavdata import WavData
    t_phase = time.perf_counter()
    n200 = os.path.join(d, "n200.wav")
    n24 = os.path.join(d, "mode_n24.wav")
    WavData(WavData.load(n200).samples, 2, 44100, 24).save(n24)
    from audiowmark_tpu_torch.codec import convcode
    seen = {}       # mode -> {(B, steps): branch metrics K1 got on the card}
    current = [None]
    acs = convcode.viterbi_acs

    def recording(bm):
        seen.setdefault(current[0], {}).setdefault(tuple(bm.shape[:2]), bm)
        return acs(bm)

    def production():
        files, add_s = make_mode_files(port, d, {"n": n200, "n24": n24},
                                       "prod", {})
        check(WavData.load(files["24bit"]).bit_depth == 24,
              "the 24-bit add wrote another bit depth")
        fields = {}
        for name, (marked, cut, gets) in MODES.items():
            current[0] = name
            path = cut_file(files[marked], cut, d, name)
            first, first_s = timed(lambda: mode_gets(port, path, gets, {}))
            warm, warm_s = timed(lambda: mode_gets(port, path, gets, {}))
            check(warm == first, "%s: the warm get printed another report"
                  % name)
            fields[name] = dict(match_counts=check_mode(name, first, gets),
                                add_s=add_s[marked], first_s=first_s,
                                warm_s=warm_s)
        return fields

    convcode.viterbi_acs = recording
    try:
        fields, launches = launches_of("the modes", production)
    finally:
        convcode.viterbi_acs = acs

    # K1 against its plain version on the very metrics each mode gave it,
    # once per mode and shape
    shapes = {}
    for name in MODES:
        bms = seen.pop(name, {})
        check(bms, "%s never reached K1 on the card" % name)
        shapes[name] = sorted(bms)
        k1 = [dict(k1_check_bm(bms[shape]), path="modes/" + name)
              for shape in shapes[name]]
        checks.extend(k1)
        del bms
        phase("mode", mode=name, k1_shapes=shapes[name], k1=[{
            k: c[k] for k in ("batch", "steps", "ms", "plain_ms", "bound_ms",
                              "share", "cluster")} for c in k1],
            card=smi, **fields[name])
    short_steps = [sorted({s[1] for s in shapes["short_%d" % k]})
                   for k in SHORT]
    check(short_steps == [[71], [76], [80]],
          "the short payloads gave K1 %s steps" % short_steps)

    # the reduced geometry: the card's report vs the port's CPU report of
    # the same (card-marked) file
    rng = np.random.RandomState(7)
    x = ((rng.rand(80 * 44100 * 2) * 2 - 1) * 0.5).astype(np.float32)
    inputs = {"n": os.path.join(d, "mode_r.wav"),
              "n24": os.path.join(d, "mode_r24.wav")}
    WavData(x, 2, 44100, 16).save(inputs["n"])
    WavData(x, 2, 44100, 24).save(inputs["n24"])
    files, _ = make_mode_files(port, d, inputs, "reduced", REDUCED)
    apart, cpu_s = {}, 0.0
    for name, (marked, cut, gets) in MODES.items():
        path = cut_file(files[marked], cut, d, "reduced_" + name)
        card = mode_gets(port, path, gets, REDUCED)
        cpu, s = timed(lambda: mode_gets(port, path, gets, REDUCED, "cpu"))
        cpu_s += s
        apart[name] = same_report(card, cpu)
        check(apart[name] is not None, "%s: the card's report differs from "
              "the CPU's:\n%s\n%s" % (name, card, cpu))
    phase("modes", modes=len(MODES), k1_launches=launches,
          k1_shapes=sorted({s for v in shapes.values() for s in v}),
          reduced_card_vs_cpu_max_float=apart, reduced_cpu_get_s=cpu_s,
          seconds=time.perf_counter() - t_phase, card=smi)
    return launches


def phase_ber(d, smi):
    """21. the codec-free rows of docs/BER.md's matrix on the card (2
    seeds): every FLOOR row BER 0 and FER 0, the others beside
    docs/BER.md's numbers; the rows that need a codec are listed with why
    they do not run here.  Returns K1's launches over the rows."""
    from audiowmark_tpu_torch import ber_row
    t_phase = time.perf_counter()
    rows = [r for r in ber_row.ROWS if not ber_row.codec_of(r[2])]
    skipped = {}
    for r in ber_row.ROWS:
        if ber_row.codec_of(r[2]):
            lib = ber_row.codec_of(r[2])
            skipped.setdefault(
                "%s %s" % (lib, "does not load here"
                           if ber_row.missing_codec(r[2])
                           else "loads, codec rows run on the CPU "
                           "(docs/BER_torch.md)"),
                []).append(ber_row.label(r[0], r[1]) + " " + r[2])
    ref = ber_row.reference_rows()
    carriers = {("noise", 60): os.path.join(d, "n60.wav"),
                ("noise", 200): os.path.join(d, "n200.wav")}

    def row(r):
        e, n, fe, fn = r["counts"]
        print("phase %-10s %s" % ("ber_row", json.dumps(dict(
            carrier=r["label"], transform=r["transform"], kind=r["kind"],
            ber="%d/%d" % (e, n), fer="%d/%d" % (fe, fn),
            docs_ber_md=ref.get((r["label"], r["transform"],
                                 r["strength"])),
            seconds=r["seconds"]), sort_keys=True)), flush=True)

    results, launches = launches_of("the BER rows", lambda: ber_row.run_rows(
        rows, seeds=2, carriers=carriers, on_row=row))
    bad, _ = ber_row.verdict(results)
    check(not bad, "FLOOR rows with errors on the card: %s" % bad)
    phase("ber", rows=len(results), floor_rows=sum(
        r["kind"] == "floor" for r in results), floor_errors=0,
        skipped=skipped, k1_launches=launches,
        seconds=time.perf_counter() - t_phase, card=smi)
    return launches


def run_cli(argv):
    """The port's cli.main(argv) in this process, on the card: (exit code,
    stdout, stderr, wall s); Params and the log level reset around it."""
    from audiowmark_tpu_torch.cli import main as cli_main
    from audiowmark_tpu_torch.utils import log
    set_params()
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    set_params()
    log.set_log_level(log.Log.INFO)
    return rc, out.getvalue(), err.getvalue(), wall


def port_process(args, **kwargs):
    """`python3 -m audiowmark_tpu_torch <args>` with no device setting (so
    on the card), as subprocess.Popen(**kwargs)."""
    return subprocess.Popen([sys.executable, "-m", "audiowmark_tpu_torch"]
                            + args, cwd=REPO, env=card_env(), **kwargs)


def finished(proc, what, stdin=None, timeout=600):
    """(stdout, stderr) of a port_process that must exit 0; `stdin`: bytes
    for its standard input."""
    out, err = proc.communicate(stdin, timeout=timeout)
    check(proc.returncode == 0, "%s: exit %d:\n%s" % (
        what, proc.returncode, err.decode(errors="replace")))
    return out, err


def wav_pipe_samples(path):
    from audiowmark_tpu_torch.io.wavdata import WavData
    from audiowmark_tpu_torch.params import Format
    set_params(input_format=Format.WAV_PIPE)
    samples = WavData.load(path).samples
    set_params()
    return samples


def matches(text):
    for line in text.splitlines():
        if line.startswith("match_count "):
            return int(line.split()[1])
    return None


# phase 22's sample formats, each marked and read back by cmp on the 60 s
# fixture (3 matches): raw PCM as (name, its --raw-* options), WAV input as
# (name, bits, encoding, further add options)
STREAM_RAW = [
    ("raw_s16", ["--raw-encoding", "signed", "--raw-bits", "16"]),
    ("raw_s16_big", ["--raw-encoding", "signed", "--raw-bits", "16",
                     "--raw-endian", "big"]),
    ("raw_s24", ["--raw-encoding", "signed", "--raw-bits", "24"]),
    ("raw_s32", ["--raw-encoding", "signed", "--raw-bits", "32"]),
    ("raw_u8", ["--raw-encoding", "unsigned", "--raw-bits", "8"]),
    ("raw_u16", ["--raw-encoding", "unsigned", "--raw-bits", "16"]),
    ("raw_f32", ["--raw-encoding", "float"]),
    ("raw_f64_big", ["--raw-encoding", "double", "--raw-endian", "big"]),
]
STREAM_WAV = [("wav_u8", 8, "UNSIGNED", []), ("wav_s24", 24, "SIGNED", []),
              ("wav_s32", 32, "SIGNED", []), ("wav_f32", 32, "FLOAT", []),
              ("rf64_out", 16, "SIGNED", ["--output-format", "rf64"])]


def raw_options_format(options):
    """The RawFormat that --raw-* `options` name."""
    from audiowmark_tpu_torch.fixtures import raw_format
    opts = dict(zip(options[::2], options[1::2]))
    enc = opts["--raw-encoding"]
    if enc in ("float", "double"):
        return raw_format("float", 64 if enc == "double" else 32,
                          opts.get("--raw-endian", "little"))
    return raw_format(enc, int(opts["--raw-bits"]),
                      opts.get("--raw-endian", "little"))


def unknown_length_adds(d, n200, n60, piped):
    """Phase 22's adds in this process: the unknown-length add of n60.raw
    against the known-length add of n60.wav, and the same at 32 kHz, with
    the limiter and without it; `piped` (limiter on / off -> the stdin
    add's wav-pipe output) against the in-process add; and the probe.
    Returns the phase's fields."""
    from audiowmark_tpu_torch import tile_probe
    from audiowmark_tpu_torch.io.wavdata import WavData
    from audiowmark_tpu_torch.ops import frames
    from audiowmark_tpu_torch.params import Params
    fields = {}
    # the same adds in this process, the tiles recorded, against the
    # known-length streaming add of the WAV (--snr sends it there), and
    # the same at 32 kHz (raw PCM against the WAV, both through the
    # resampler pair): 0 samples apart without the limiter
    n32 = tile_probe.fixture(d, 60, 32000)
    for rate, wav in ((44100, n60), (32000, n32)):
        for lim in (True, False):
            r = tile_probe.unknown_vs_known(wav, rate, lim)
            tag = "%dk_%s" % (rate // 1000,
                              "limiter" if lim else "no_limiter")
            fields[tag] = dict(
                lsb_apart=r["lsb_apart"], largest_lsb=r["largest_lsb"],
                unknown_add_s=r["unknown_s"], known_add_s=r["known_s"],
                tiles=sorted(set(r["tiles"])), tile_count=len(r["tiles"]))
            check(16 in r["tiles"] and 512 in r["tiles"],
                  "the tiles did not ramp: %s" % sorted(set(r["tiles"])))
            if lim:
                check(r["largest_lsb"] <= 1
                      and r["lsb_apart"] < 1e-3 * r["samples"],
                      "unknown- vs known-length add (%s): %d samples, up to "
                      "%g LSB" % (tag, r["lsb_apart"], r["largest_lsb"]))
            else:
                check(r["lsb_apart"] == 0, "unknown- vs known-length add "
                      "(%s): %d samples differ" % (tag, r["lsb_apart"]))
            if rate == 44100:
                worst, n = samples_apart(wav_pipe_samples(piped[lim]),
                                         WavData.load(r["unknown"]).samples,
                                         tag)
                check(worst <= 1, "the stdin add is %g LSB from the same "
                      "add of the raw file" % worst)
                fields[tag]["stdin_vs_file_lsb_apart"] = n

    # the probe: the delta's stages on slices of T frames against one call
    # on 4096 frames of the 200 s fixture; _delta_iffts launches one shape
    # and must agree at every T
    x, mods, awin = tile_probe.probe_input(n200, tile_probe.SIZES[-1],
                                           "cuda")
    table = tile_probe.stage_rows_apart(x, mods, Params.water_delta, awin)
    del x, mods
    check(not any(row["delta_iffts"] for row in table),
          "_delta_iffts on slices differs from one call: %s" % table)
    stages = ("rfft", "factor", "irfft")
    fields["probe"] = dict(
        delta_frames=frames.DELTA_FRAMES,
        stages_apart=[name for name in stages
                      if any(row[name] for row in table)],
        stages_agree_from_frames=min(
            row["frames"] for row in table
            if not any(later[name] for later in table
                       if later["frames"] >= row["frames"]
                       for name in stages)),
        table=table)
    return fields


def phase_streams(d, smi):
    """22. the shell's streams on the card.  Returns K1's launches over the
    phase's in-process gets (the format matrix and the wav-pipe cmp)."""
    from audiowmark_tpu_torch.fixtures import write_wav
    from audiowmark_tpu_torch.io.converters import RawConverter
    from audiowmark_tpu_torch.io.wavdata import WavData
    from audiowmark_tpu_torch.params import Encoding
    t_phase = time.perf_counter()
    fields, seconds = {}, {}
    n200, n60 = os.path.join(d, "n200.wav"), os.path.join(d, "n60.wav")
    s16 = raw_options_format(STREAM_RAW[0][1])
    raw60 = os.path.join(d, "n60.raw")
    with open(raw60, "wb") as f:
        f.write(RawConverter(s16).to_raw(WavData.load(n60).samples))

    # add in.wav - MSG | cmp - MSG, two processes and a pipe, 200 s
    t0 = time.perf_counter()
    add = port_process(["--strict", "add", n200, "-", MSG],
                       stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    cmp_p = port_process(["--strict", "cmp", "-", MSG], stdin=add.stdout,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    add.stdout.close()
    out, _ = finished(cmp_p, "cmp - of the piped add")
    check(add.wait(timeout=60) == 0, "add to stdout failed")
    seconds["pipe_add_cmp_s"] = time.perf_counter() - t0
    fields["pipe_match_count"] = matches(out.decode())
    check(fields["pipe_match_count"] == 5, "add | cmp -:\n" + out.decode())

    # add in.wav - | get -: the marked bytes piped into get
    marked = os.path.join(d, "piped200.wav")
    out, _ = finished(port_process(["--strict", "add", n200, "-", MSG],
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE), "add to stdout")
    with open(marked, "wb") as f:
        f.write(out)
    t0 = time.perf_counter()
    out, _ = finished(port_process(["--strict", "get", "-"],
                                   stdin=subprocess.PIPE,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE), "get -", out)
    seconds["pipe_get_s"] = time.perf_counter() - t0
    fields["pipe_get_patterns"] = sum(
        line.split()[2] == MSG for line in out.decode().splitlines()
        if line.startswith("pattern"))
    check(fields["pipe_get_patterns"] == 5, "add | get -:\n" + out.decode())

    # the unknown-length add from stdin to stdout (raw in, wav-pipe out),
    # with and without the limiter, two processes side by side
    t0 = time.perf_counter()
    procs = {}
    for lim in (True, False):
        opt = [] if lim else ["--test-no-limiter"]
        with open(raw60, "rb") as stdin:
            procs[lim] = port_process(
                ["--strict", "add", "--input-format", "raw", "--raw-rate",
                 "44100", "--output-format", "wav-pipe"] + opt
                + ["-", "-", MSG], stdin=stdin, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE)
    piped = {}
    for lim, proc in procs.items():
        out, _ = finished(proc, "the unknown-length add from stdin")
        check(out[4:8] == b"\xff\xff\xff\xff", "not a wav-pipe header")
        piped[lim] = os.path.join(d, "stdin_add_%d.wav" % lim)
        with open(piped[lim], "wb") as f:
            f.write(out)
    seconds["stdin_add_s"] = time.perf_counter() - t0

    fields.update(unknown_length_adds(d, n200, n60, piped))

    # wav-pipe to stdout, read back with cmp --input-format wav-pipe, and
    # every sample format through add and cmp, in this process
    def gets():
        counts = {}
        wp = os.path.join(d, "wav_pipe.wav")
        with open(wp, "wb") as f:
            finished(port_process(
                ["--strict", "add", "--output-format", "wav-pipe", n60, "-",
                 MSG], stdout=f, stderr=subprocess.PIPE), "wav-pipe add")
        with open(wp, "rb") as f:
            check(f.read(8)[4:] == b"\xff\xff\xff\xff",
                  "not a wav-pipe header")
        rc, out, _, wall = run_cli(["--strict", "cmp", "--input-format",
                                    "wav-pipe", wp, MSG])
        counts["wav_pipe"] = (rc, matches(out), wall)
        samples = WavData.load(n60).samples
        for name, opts in STREAM_RAW:
            src = os.path.join(d, name + ".raw")
            dst = os.path.join(d, name + "_wm.raw")
            with open(src, "wb") as f:
                f.write(RawConverter(raw_options_format(opts)).to_raw(samples))
            raw = ["--format", "raw", "--raw-rate", "44100"] + opts
            rc, _, _, add_s = run_cli(["--strict", "add"] + raw
                                      + [src, dst, MSG])
            check(rc == 0 and os.path.getsize(dst) == os.path.getsize(src),
                  "add of " + name)
            rc, out, _, wall = run_cli(["--strict", "cmp"] + raw
                                       + [dst, MSG])
            counts[name] = (rc, matches(out), add_s + wall)
        for name, bits, enc, opts in STREAM_WAV:
            src = os.path.join(d, name + ".wav")
            dst = os.path.join(d, name + "_wm.wav")
            write_wav(src, samples, bits, Encoding[enc])
            rc, _, _, add_s = run_cli(["--strict", "add"] + opts
                                      + [src, dst, MSG])
            check(rc == 0, "add of " + name)
            with open(dst, "rb") as f:
                check(f.read(4) == (b"RF64" if opts else b"RIFF"),
                      name + ": wrong container")
            rc, out, _, wall = run_cli(["--strict", "cmp", dst, MSG])
            counts[name] = (rc, matches(out), add_s + wall)
        return counts

    counts, launches = launches_of("the gets of phase 22", gets)
    for name, (rc, n, wall) in counts.items():
        check(rc == 0 and n == 3, "%s: exit %d, match_count %s (not 3)"
              % (name, rc, n))
        seconds[name + "_s"] = wall
    phase("streams", match_counts={k: v[1] for k, v in counts.items()},
          k1_launches=launches, seconds=time.perf_counter() - t_phase,
          card=smi, **fields, **seconds)
    return launches


def phase_quality(d, smi):
    """23. the strength sweep of docs/QUALITY.md on the card against the
    same sweep on the CPU (30 s carriers, 8 strengths each): SNR and NMR
    within 1e-3 dB, the marked files <= 1 LSB apart, the tool's checks."""
    from audiowmark_tpu_torch import quality_report as qr
    from audiowmark_tpu_torch.io.wavdata import WavData
    from audiowmark_tpu_torch.tile_probe import (
        samples_apart as samples_apart_files)
    t_phase = time.perf_counter()
    missing = qr.anchors_missing()
    fields, worst_db, apart = {}, 0.0, 0
    for carrier in qr.CARRIERS:
        src = os.path.join(d, "q_%s.wav" % carrier)
        qr.GENERATORS[carrier](src, 30)
        t0 = time.perf_counter()
        card = qr.sweep(src, d, tag="_card")
        card_s = time.perf_counter() - t0
        cpu = qr.sweep(src, d, device="cpu", tag="_cpu")
        for (s, snr, nmr), (_, snr_c, nmr_c) in zip(card, cpu):
            worst_db = max(worst_db, abs(snr - snr_c), abs(nmr - nmr_c))
            r = samples_apart_files(*(os.path.join(
                d, "q_%s_%s_s%d.wav" % (carrier, tag, s))
                for tag in ("card", "cpu")))
            check(r["largest_lsb"] <= 1, "%s strength %d: card and CPU adds "
                  "%g LSB apart" % (carrier, s, r["largest_lsb"]))
            apart += r["lsb_apart"]
        anchors = None
        if not missing:
            orig = WavData.load(src)
            anchors = {br: qr.mp3_anchor_nmr(orig, br)
                       for br in qr.ANCHOR_BITRATES}
        failures = qr.checks(carrier, card, anchors)
        check(not failures, "; ".join(failures))
        fields[carrier] = dict(snr_db=[r[1] for r in card],
                               nmr_db=[r[2] for r in card],
                               cpu_snr_db=[r[1] for r in cpu],
                               cpu_nmr_db=[r[2] for r in cpu],
                               card_sweep_s=card_s)
    check(worst_db <= 1e-3, "card vs CPU SNR/NMR %.6f dB apart" % worst_db)
    phase("quality", strengths=qr.STRENGTHS, card_vs_cpu_max_db=worst_db,
          samples_lsb_apart=apart, checks="pass",
          mp3_anchors=("not run: %s does not load here" % missing
                       if missing else "run"),
          seconds=time.perf_counter() - t_phase, card=smi, **fields)


def phase_ttfb(d, smi, cli_s):
    """24. the reference's latency harness (ttfb.py) on the card: the 200 s
    fixture as a WAV on stdin (a known length) and as raw PCM on stdin (the
    unknown-length add's ramp); each output decodes to 5 matches.  Then the
    in-process time from the call of add_stream_watermark on the 60 s raw
    stream to its first write of samples.  Returns K1's launches over the
    phase's gets."""
    from audiowmark_tpu_torch import tile_probe, ttfb
    from audiowmark_tpu_torch.io.converters import RawConverter
    from audiowmark_tpu_torch.io.wavdata import WavData
    t_phase = time.perf_counter()
    n200 = os.path.join(d, "n200.wav")
    raw200 = os.path.join(d, "n200.raw")
    with open(raw200, "wb") as f:
        f.write(RawConverter(raw_options_format(STREAM_RAW[0][1])).to_raw(
            WavData.load(n200).samples))
    fields, outs = {}, {}
    for name, src, opts in (("wav", n200, []),
                            ("raw", raw200, ["--input-format", "raw",
                                             "--raw-rate", "44100"])):
        outs[name] = os.path.join(d, "ttfb_%s.wav" % name)
        with open(outs[name], "wb") as sink:
            first, total, n = ttfb.measure(src, MSG, opts, sink=sink)
        check(n == 44 + 200 * 44100 * 2 * 2, "ttfb.py (%s) counted %d bytes"
              % (name, n))
        fields[name] = dict(ttfb_s=first, total_s=total, bytes=n,
                            mb_per_s=n / total / 1e6)

    def gets():
        counts = {}
        for name, path in outs.items():
            rc, out, _, wall = run_cli(["--strict", "cmp", "--input-format",
                                        "wav-pipe", path, MSG])
            check(rc == 0 and matches(out) == 5, "the marked stream of "
                  "ttfb.py (%s): exit %d, match_count %s (not 5)"
                  % (name, rc, matches(out)))
            counts[name] = 5
            fields[name]["get_s"] = wall
        return counts

    counts, launches = launches_of("the gets of phase 24", gets)
    fields["first_write"] = tile_probe.first_writes(
        os.path.join(d, "n60.raw"))
    phase("ttfb", match_counts=counts, k1_launches=launches,
          cli_process_s=cli_s, seconds=time.perf_counter() - t_phase,
          card=smi, **fields)
    return launches


# phase 25's files: (channels, rate, seconds), seeded noise at full scale
CHANNEL_FILES = [(1, 44100, 200), (6, 48000, 60), (2, 22050, 60),
                 (2, 96000, 60)]
# seconds of each file marked and read at the reduced geometry (card vs CPU)
CHANNEL_REDUCED_SECONDS = 30
# phase 25's fleet streams: (channels, streams)
CHANNEL_FLEET = [(1, 4), (6, 4)]


def add_on(device, src, dst, raw=None, **params):
    """The port's add of `src` on `device` (None: the card) under `params`;
    raw=(channels, rate): `src` is 16-bit raw PCM of unknown length.
    Returns (wall s, its informational output)."""
    from audiowmark_tpu_torch.crypto.keys import Key
    from audiowmark_tpu_torch.models.embedder import add_watermark
    from audiowmark_tpu_torch.params import Format, Params
    set_params(**params)
    if raw:
        Params.input_format = Format.RAW
        Params.raw_input_format.set_channels(raw[0])
        Params.raw_input_format.set_sample_rate(raw[1])
    info = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(info):
        rc = add_watermark(Key(), src, dst, MSG, device)
    if device is None:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    set_params()
    check(rc == 0, "add of %s on %s" % (src, device or "the card"))
    return wall, info.getvalue()


def get_on(device, path, **params):
    """The port's cmp of `path` on `device` (None: the card): (exit code,
    stdout, wall s)."""
    from audiowmark_tpu_torch.crypto.keys import Key
    from audiowmark_tpu_torch.models.getter import get_watermark
    set_params(**params)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = get_watermark([Key()], path, MSG, device)
    if device is None:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    set_params()
    return rc, out.getvalue(), wall


def cpu_job(kind, src, dst, raw, params):
    """One of phase 25's CPU runs, in a worker process of its own: "add"
    (the port's add of `src` into `dst` on the CPU) or "get" (its cmp of
    `src`).  Returns (wall s, the add's informational output) or (exit
    code, stdout, wall s)."""
    torch.set_num_threads(2)
    if kind == "add":
        return add_on("cpu", src, dst, raw, **params)
    return get_on("cpu", src, **params)


def channel_card(d, channels, rate, seconds):
    """25. one file's runs on the card: its adds 0 samples apart without
    the limiter, the add and cmp of the file and of its first seconds at
    the reduced geometry.  Returns (the file's fields, its CPU runs as
    {name: cpu_job's arguments}, the card's results they are held to)."""
    from audiowmark_tpu_torch.fixtures import long_noise, raw_format
    from audiowmark_tpu_torch.io.converters import RawConverter
    from audiowmark_tpu_torch.io.wavdata import WavData
    tag = "%dch_%d" % (channels, rate)
    wav = os.path.join(d, "ch_%s.wav" % tag)
    long_noise(channels * 1000 + rate // 1000, wav, seconds, rate, channels)
    samples = WavData.load(wav).samples
    raw = wav[:-4] + ".raw"
    with open(raw, "wb") as f:
        f.write(RawConverter(raw_format("signed", 16)).to_raw(samples))
    fmt = (channels, rate)
    r = dict(channels=channels, rate=rate, seconds=seconds,
             samples=int(samples.size))

    # without the limiter: the known-length add (whole-file at 44.1 kHz,
    # 4096-frame tiles otherwise), at 44.1 kHz also the streaming
    # known-length add (--snr), and the unknown-length add of the raw PCM
    # (its tiles ramp 16 -> 512 frames): 0 samples apart
    outs = {}
    adds = [("known", wav, None, {})]
    if rate == 44100:
        adds.append(("stream", wav, None, dict(snr=True)))
    adds.append(("unknown", raw, fmt, {}))
    for name, src, raw_fmt, extra in adds:
        outs[name] = os.path.join(d, "ch_%s_%s.wav" % (tag, name))
        r[name + "_add_s"], _ = add_on(None, src, outs[name], raw_fmt,
                                       test_no_limiter=True, **extra)
    known = WavData.load(outs["known"]).samples
    for name in outs:
        if name != "known":
            _, n = samples_apart(WavData.load(outs[name]).samples, known,
                                 tag + " " + name)
            r[name + "_vs_known_apart"] = n
            check(n == 0, "%s: the %s add is %d samples from the "
                  "known-length add without the limiter" % (tag, name, n))

    # with the limiter: the add of the file (the user's add) and the
    # unknown-length add of its raw PCM, which the CPU repeats (a
    # known-length add at another rate pads its last tile to 4096 frames,
    # minutes of audio through the CPU's resampler), and cmp
    # (at another rate than 44.1 kHz both go through K2, counted apart)
    counted = k2_launches_of if rate != 44100 else (lambda path, fn: fn())
    marked = os.path.join(d, "ch_%s_marked.wav" % tag)
    r["add_s"], info = counted("channels_%s_add" % tag,
                               lambda: add_on(None, wav, marked))
    r["data_blocks"] = info_line(info, "Data Blocks")
    unknown = os.path.join(d, "ch_%s_unknown_lim.wav" % tag)
    add_on(None, raw, unknown, fmt)
    rc, text, r["get_s"] = counted("channels_%s_get" % tag,
                                   lambda: get_on(None, marked))
    r["match_count"] = matches(text)
    check(rc == 0 and r["match_count"] >= 1, "%s: cmp on the card: exit "
          "%d:\n%s" % (tag, rc, text))

    # the reduced geometry on the file's first seconds
    head = os.path.join(d, "ch_%s_head.wav" % tag)
    WavData(samples[:CHANNEL_REDUCED_SECONDS * rate * channels], channels,
            rate, 16).save(head)
    head_marked = os.path.join(d, "ch_%s_head_marked.wav" % tag)
    add_on(None, head, head_marked, **REDUCED)
    card = get_on(None, head_marked, **REDUCED)
    r["reduced_get_s"], r["reduced_match_count"] = card[2], matches(card[1])

    cpu_unknown = os.path.join(d, "ch_%s_cpu.wav" % tag)
    jobs = {"add": ("add", raw, cpu_unknown, fmt, {}),
            "get": ("get", marked, None, None, {}),
            "reduced_get": ("get", head_marked, None, None, REDUCED)}
    return r, jobs, dict(unknown=unknown, cpu_unknown=cpu_unknown,
                         get=(rc, text), reduced_get=card[:2])


def channel_cpu_checks(tag, r, card, cpu):
    """25. the CPU's runs of one file against the card's: the add <= 1 LSB
    apart on < 3e-3 of the samples (phase 4's rule), the same exit code
    and match count of cmp, and at the reduced geometry the same report
    (phase 20's rule)."""
    from audiowmark_tpu_torch.io.wavdata import WavData
    r["cpu_add_s"] = cpu["add"][0]
    worst, n = samples_apart(WavData.load(card["unknown"]).samples,
                             WavData.load(card["cpu_unknown"]).samples, tag)
    r["card_vs_cpu_lsb_apart"], r["card_vs_cpu_largest_lsb"] = n, worst
    check(worst <= 1 and n < 3e-3 * r["samples"], "%s: the card's add is "
          "%g LSB from the CPU's on %d of %d samples" % (
              tag, worst, n, r["samples"]))
    cpu_rc, cpu_text, r["cpu_get_s"] = cpu["get"]
    r["cpu_match_count"] = matches(cpu_text)
    check(card["get"][0] == cpu_rc and r["match_count"]
          == r["cpu_match_count"], "%s: cmp on the card: exit %d, %s; on "
          "the CPU: exit %d, %s" % (tag, card["get"][0], card["get"][1],
                                    cpu_rc, cpu_text))
    r["reduced_cpu_get_s"] = cpu["reduced_get"][2]
    r["reduced_max_float_apart"] = same_report([card["reduced_get"]],
                                               [cpu["reduced_get"][:2]])
    check(r["reduced_max_float_apart"] is not None, "%s: at the reduced "
          "geometry the card's report differs from the CPU's:\n%s\n%s"
          % (tag, card["reduced_get"][1], cpu["reduced_get"][1]))


def mono_probe(d):
    """25. tile_probe's table on the mono file's first 4096 frames: whether
    cuFFT gives mono's 1024-row calls of _delta_iffts the bits of a
    larger batch."""
    from audiowmark_tpu_torch import tile_probe
    from audiowmark_tpu_torch.params import Params
    x, mods, awin = tile_probe.probe_input(
        os.path.join(d, "ch_1ch_44100.wav"), tile_probe.SIZES[-1], "cuda")
    table = tile_probe.stage_rows_apart(x, mods, Params.water_delta, awin)
    check(not any(row["delta_iffts"] for row in table),
          "mono: _delta_iffts on slices differs from one call: %s" % table)
    return table


def channel_fleet(key):
    """25. watermark_batch then detect_batch on CHANNEL_FLEET's streams of
    60 s: in every stream the best eligible slot holds the message."""
    from audiowmark_tpu_torch.models.common import parse_payload
    from audiowmark_tpu_torch.parallel import batch as fleet
    from audiowmark_tpu_torch.params import Params
    set_params()
    want = parse_payload(MSG).tolist()
    out = {}
    for channels, streams in CHANNEL_FLEET:
        rng = np.random.default_rng(channels)
        audio = (rng.random((streams, 60 * 44100, channels),
                            dtype=np.float32) - np.float32(0.5)) \
            * np.float32(0.6)
        marked, mark_s = timed(lambda: fleet.watermark_batch(key, audio, MSG))
        found, detect_s = timed(lambda: fleet.detect_batch(key, marked))
        check(marked.shape == audio.shape and np.isfinite(marked).all(),
              "watermark_batch with %d channels" % channels)
        for b in range(streams):
            q = np.where(found["eligible"][b], found["qualities"][b], -1.0)
            best = int(np.argmax(q))
            check(q[best] > Params.sync_threshold2
                  and found["bits"][b][best].tolist() == want,
                  "%d channels, stream %d: the best eligible slot %d "
                  "(quality %g) does not hold the message"
                  % (channels, b, best, q[best]))
        out["%dch" % channels] = dict(streams=streams, watermark_s=mark_s,
                                      detect_s=detect_s)
    return out


def channel_api():
    """25. the JAX package's API functions of the port on the card against
    the CPU: conv_decode_hard and code_decode_soft (128 bits, --short 12)
    bits and errors exact, and candidate_eligibility on exact-tie plateaus
    equal to the CPU's and to the host's _select_local_maxima."""
    from audiowmark_tpu_torch.codec import (ConvBlockType, code_decode_soft,
                                            code_encode, conv_decode_hard,
                                            conv_encode)
    from audiowmark_tpu_torch.models.syncfinder import _select_local_maxima
    from audiowmark_tpu_torch.ops.search_fused import candidate_eligibility
    from audiowmark_tpu_torch.params import Params
    rng = np.random.RandomState(25)
    bits = rng.randint(0, 2, 128)
    coded = conv_encode(ConvBlockType.b, bits)
    coded[rng.choice(coded.size, 80, replace=False)] ^= 1
    hard = [conv_decode_hard(ConvBlockType.b, coded, device=dev)
            for dev in ("cuda", "cpu")]
    check(np.array_equal(hard[0], hard[1]) and np.array_equal(hard[0], bits),
          "conv_decode_hard on the card differs from the CPU")
    soft = {}
    for short in (0, 12):
        set_params(payload_short=bool(short), payload_size=short or 128)
        msg = rng.randint(0, 2, short or 128)
        coded = code_encode(ConvBlockType.a, msg)
        row = np.clip(coded + rng.randn(coded.size) * 0.25, 0, 1) \
            .astype(np.float32)
        got = [code_decode_soft(ConvBlockType.a, row, True, dev)
               for dev in ("cuda", "cpu")]
        check(np.array_equal(got[0][0], got[1][0]) and got[0][1] == got[1][1]
              and np.array_equal(got[0][0], msg), "code_decode_soft "
              "(short %d) on the card differs from the CPU" % short)
        soft["short_%d_error" % short] = got[0][1]
    set_params()
    plateaus = [np.zeros(50), np.ones(7),
                np.array([1.0, 1.0, 0.5, 1.0, 1.0, 1.0, 0.2]),
                np.array([0.4, 0.4, 0.4, 0.0, 0.4, 0.4])]
    for q in plateaus:
        q = q.astype(np.float32)
        ok = np.ones(q.size, dtype=bool)
        on = [candidate_eligibility(*(torch.from_numpy(a).to(dev)
                                      for a in (q, np.zeros_like(q), ok)))
              for dev in ("cuda", "cpu")]
        check(torch.equal(on[0][0].cpu(), on[1][0])
              and np.array_equal(on[1][0].numpy(), _select_local_maxima(q)),
              "candidate_eligibility on the plateau %s" % q.tolist())
    check(Params.payload_size == 128, "Params were not reset")
    return dict(plateaus=len(plateaus), **soft)


def phase_channels(d, smi):
    """25. channel counts and rates other than stereo 44.1 kHz on the card
    (CHANNEL_FILES), the fleet API with 1 and 6 channels, and the JAX
    package's API functions on the card; the CPU's runs that the card's
    are held to go to four worker processes meanwhile.  Returns K1's
    launches over the phase's runs on the card."""
    import concurrent.futures
    import multiprocessing
    from audiowmark_tpu_torch.crypto.keys import Key
    t_phase = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            4, mp_context=multiprocessing.get_context("spawn")) as pool:

        def path():
            files, cpu = {}, {}
            for c, rate, secs in CHANNEL_FILES:
                tag = "%dch_%d" % (c, rate)
                r, jobs, card = channel_card(d, c, rate, secs)
                files[tag] = (r, card)
                cpu[tag] = {k: pool.submit(cpu_job, *a)
                            for k, a in jobs.items()}
            return files, cpu, channel_fleet(Key()), channel_api(), \
                mono_probe(d)

        (files, cpu, fleet_fields, api, probe), launches = launches_of(
            "the channels path", path)
        card_s = time.perf_counter() - t_phase
        for tag, (r, card) in files.items():
            channel_cpu_checks(tag, r, card, {k: f.result()
                                              for k, f in cpu[tag].items()})
            phase("channel", file=tag, card=smi, **r)
    stages = ("rfft", "factor", "irfft")
    phase("channels", files=len(files), fleet=fleet_fields, api=api,
          mono_probe=probe, mono_stages_apart=[
              name for name in stages if any(row[name] for row in probe)],
          k1_launches=launches, card_s=card_s,
          seconds=time.perf_counter() - t_phase, card=smi)
    return launches


# ---- 27. kernel K2, the resampler's rows --------------------------------------

# (old rate, new rate) of the ratios K2 is checked at: the pair of the 48 kHz
# add (48 and 32 taps) and a speed scan's centre 0.98 / 2 (80 taps, the
# kernel's generic form), whose rate pair is only named by its ratio
K2_RATIOS = ((48000, 44100), (44100, 48000), (100, 49))
# input frames of a write: 1 frame, odd sizes, one across the plain
# version's 64 K-row tiles, and the 4096-frame tile of the known-length
# streaming add (4096 x 1024 frames, 87.4 s at 48 kHz)
K2_TILE = 4096 * 1024
K2_SIZES = (1, 3, 1001, 65613, K2_TILE)
K2_STREAM_SECONDS = 20


def k2_args(old, new, coeff_dtype, n_in):
    """(ratio, j0, n_rows, offset) of a write of n_in frames: for the
    streaming resampler's float64 coefficients, rows an hour into a stream
    whose first row's taps start at xpad[0]; for resample_frames' float32
    ones, the rows from 0 as it asks for them."""
    ratio = new / old
    n_rows = max(1, int(n_in * ratio))
    if coeff_dtype == torch.float64:
        j0 = 3600 * new + 12345
        return ratio, j0, n_rows, -int(np.floor(j0 / ratio))
    return ratio, 0, n_rows, 0


# FP64 instructions an H100 (sm_90) issues per SM and clock: its 64 FP64
# lanes per SM (33.5 TFLOPS of FMA at 132 SMs and 1.98 GHz)
FP64_PER_SM_CLOCK = 64
# the taps K2 takes in one pass (csrc/resample_k2.cu, kChunk)
K2_CHUNK = 16


def is_fp64(op):
    """Whether a SASS opcode runs on the FP64 units (arithmetic, compares,
    the reciprocal seed of a division, rounding and conversions)."""
    base = op.split(".")[0]
    return base in ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET") or (
        base in ("MUFU", "FRND", "F2F", "F2I", "I2F") and "64" in op)


def k2_fp64_per_pass():
    """The FP64 instructions in the SASS of K2's float64 kernel, by
    cuobjdump: one pass of a row over K2_CHUNK taps (their coefficients:
    a sin, two cos, two divisions each), with the row's own position and
    the called slow paths of sin, cos and division once each."""
    from audiowmark_tpu_torch import cuda_build
    tool = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", cuda_build.build("resample_k2")],
                          capture_output=True, text=True, check=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "resample_k2IdE" in line     # resample_k2<double>
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     line)
        count += bool(inside and m and is_fp64(m.group(1)))
    check(count > 0, "no FP64 instruction in K2's float64 kernel's SASS")
    return count


def fp64_per_ms():
    """FP64 instructions card 0 issues per millisecond at its largest SM
    clock: every SM's FP64 lanes, every clock."""
    mhz = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * FP64_PER_SM_CLOCK * float(mhz) * 1e3


def k2_bound(xpad, got, n_taps, fp64_per_pass):
    """K2's least time (ms) for a write: the larger of its bytes (the
    input read once, the output written once, at 3.35 TB/s) and its FP64
    instructions (rows x n_taps / K2_CHUNK passes, each fp64_per_pass; this
    counts the row's own position and the slow paths' code once a pass, not
    once a row or never, a few per cent high, and the reciprocal seeds and
    conversions at the rate of a multiply-add, which they are slower than)
    at the card's FP64 rate.  Returns (ms, "bytes" or "fp64", both)."""
    both = dict(bytes_ms=(xpad.numel() + got.numel()) * 4 / 3.35e12 * 1e3,
                fp64_ms=got.shape[0] * n_taps / K2_CHUNK * fp64_per_pass
                / fp64_per_ms())
    by = max(both, key=both.get)
    return both[by], by[:-3], both


def k2_check(old, new, coeff_dtype, n_in, rng, timed=None, device="cuda"):
    """K2 against the plain version on `device`, on seeded noise: the
    largest absolute difference and the rows that differ; with `timed`
    (K2's FP64 instructions a pass), both timed with CUDA events beside
    K2's bound (k2_bound)."""
    from audiowmark_tpu_torch.ops import resample
    ratio, j0, n_rows, offset = k2_args(old, new, coeff_dtype, n_in)
    n_taps = resample._filter_params(ratio)[3]
    xpad = torch.from_numpy(((rng.rand(n_in + n_taps, 2) * 2 - 1) * 0.9)
                            .astype(np.float32)).to(device)
    args = (xpad, j0, n_rows, ratio, offset, coeff_dtype)
    got = resample._resample_rows_k2(*args)
    want = resample._resample_rows_plain(*args)
    torch.cuda.synchronize(xpad.device)
    diff = (got - want).abs()
    # one formula op for op on both sides: 0 apart on the card so far; the
    # card test's tolerance (tests/test_torch_cuda.py) is the limit
    check(float(diff.max()) <= 1e-6, "K2 is %g from the plain version at "
          "%d -> %d, %s, %d frames" % (float(diff.max()), old, new,
                                       coeff_dtype, n_in))
    r = dict(old=old, new=new, coeff="f64" if coeff_dtype == torch.float64
             else "f32", taps=n_taps, in_frames=n_in, rows=n_rows,
             max_abs_err=float(diff.max()),
             rows_differ=int((diff.amax(dim=1) > 0).sum()))
    if timed:
        r["ms"] = cuda_ms(lambda: resample._resample_rows_k2(*args), 20)
        r["plain_ms"] = cuda_ms(
            lambda: resample._resample_rows_plain(*args), 2)
        r["bound_ms"], r["bound_by"], both = k2_bound(xpad, got, n_taps,
                                                       timed)
        r.update(both)
        r["share"] = r["bound_ms"] / r["ms"]
    return r


def k2_stream(old, new, rng):
    """The streaming resampler on the card over K2_STREAM_SECONDS of noise:
    one write against seeded writes of 1 frame to 64 K frames (bit for
    bit), and against the CPU's plain version over the same writes."""
    from audiowmark_tpu_torch.ops.resample import StreamingResampler
    n = K2_STREAM_SECONDS * old
    x = ((rng.rand(n * 2) * 2 - 1) * 0.9).astype(np.float32)
    cuts = np.unique(np.concatenate([[0, 1, 2, 3, n], rng.randint(
        4, n, 30)]))

    def run(dev, bounds):
        res = StreamingResampler(2, old, new, dev)
        outs = []
        for lo, hi in zip(bounds, bounds[1:]):
            res.write_frames(x[2 * lo:2 * hi])
            outs.append(res.read_frames(res.can_read_frames()).cpu())
        res.write_trailing_frames()
        outs.append(res.read_frames(res.can_read_frames()).cpu())
        return torch.cat(outs)

    one = run("cuda", [0, n])
    pieces = run("cuda", list(cuts))
    cpu = run("cpu", list(cuts))
    check(torch.equal(one, pieces), "K2's stream %d -> %d differs by how it "
          "was written" % (old, new))
    return dict(old=old, new=new, writes=len(cuts) - 1,
                split_max_abs_err=float((one - pieces).abs().max()),
                cpu_max_abs_err=float((pieces - cpu).abs().max()))


def phase_k2(smi):
    """27. K2 against the plain version on the card, at every ratio of
    K2_RATIOS, both coefficient precisions and every size of K2_SIZES,
    the tile-sized writes of the 48 kHz add timed; the streaming resampler
    on the card split into writes and in one.  Returns the kernels line's
    entry for K2."""
    from audiowmark_tpu_torch.ops import resample
    t_phase = time.perf_counter()
    rng = np.random.RandomState(27)
    launches0 = resample.LAUNCHES
    checks = []
    for old, new in K2_RATIOS:
        for coeff_dtype in (torch.float64, torch.float32):
            for n_in in K2_SIZES:
                checks.append(k2_check(old, new, coeff_dtype, n_in, rng))
    # the writes of one 4096-frame tile of the 48 kHz add: 48 -> 44.1 kHz
    # of its input, 44.1 -> 48 kHz of its watermark
    per_pass = k2_fp64_per_pass()
    timed = [k2_check(48000, 44100, torch.float64, K2_TILE, rng, per_pass),
             k2_check(44100, 48000, torch.float64, K2_TILE * 44100 // 48000,
                      rng, per_pass)]
    streams = [k2_stream(48000, 44100, rng), k2_stream(44100, 48000, rng)]
    audio_s = K2_TILE / 48000
    per_audio_s = {k: sum(t[k] for t in timed) / audio_s for k in (
        "ms", "plain_ms", "bound_ms", "bytes_ms", "fp64_ms")}
    max_err = max(c["max_abs_err"] for c in checks + timed)
    for c in checks:
        phase("k2_check", card=smi, **c)
    phase("k2", checks=len(checks), max_abs_err=max_err,
          rows_differ=sum(c["rows_differ"] for c in checks + timed),
          tile_writes=timed, per_audio_s=per_audio_s, streams=streams,
          fp64_per_pass=per_pass, seconds=time.perf_counter() - t_phase,
          card=smi)
    return {
        "name": "resample_k2",
        "route": "cuda",
        "source": "audiowmark_tpu_torch/csrc/resample_k2.cu",
        "replaces": None,
        "check_launches": resample.LAUNCHES - launches0,
        "max_abs_err": max_err,
        "ms": timed[0]["ms"],
        "plain_ms": timed[0]["plain_ms"],
        "bound_ms": timed[0]["bound_ms"],
        "bound_by": timed[0]["bound_by"],
        "library_ms": None,
        "share": timed[0]["share"],
        "fp64_per_pass": per_pass,
        "tile_writes": timed,
        "per_audio_s": per_audio_s,
    }


# ---- 26. the paths that split over several cards (--cards N) ----------------

CARDS_K1_BATCHES = (1, 8, 24, 256)
CARDS_CHUNK_MINUTES = 6.0       # 8 chunks of the 32-min file: 2 groups of 4
CARDS_SPEED = "0.9764"


def phase_finish(smi):
    """28. the streaming limiter on the card vs the numpy one; the 48 kHz
    streaming add on the card vs the host finish of its own tiles."""
    from audiowmark_tpu_torch.fixtures import (MemoryWav, add_and_host_finish,
                                               limiter_signal, limiters_apart)
    from audiowmark_tpu_torch.params import Encoding
    fields = {}
    for rate in (44100, 48000):
        sizes, apart, skipped = limiters_apart(rate, 2, 1.2, 2 * rate + 777,
                                               "cuda")
        check(skipped[0] == skipped[1] and sizes[0] == sizes[1]
              and apart == 0, "DeviceStreamingLimiter at %d Hz: %d samples "
              "differ from StreamingLimiter (sizes %s, skips %s)"
              % (rate, apart, sizes, skipped))
        fields["limiter_%d" % rate] = dict(samples=sizes[0], apart=0)

    for output, secs, known in (("wav16", 174, True), ("float", 30, False)):
        x = limiter_signal(48, secs, 48000, 2, 1.2)
        bits, enc = (16, Encoding.SIGNED) if output == "wav16" \
            else (32, Encoding.FLOAT)
        r = add_and_host_finish(
            x, 2, 48000, lambda name: MemoryWav(
                2, 48000, bits, enc, x.size // 2 if known else None),
            known, device="cuda")
        check(r["rc"] == 0, "48 kHz streaming add (%s) failed" % output)
        got, want = r["device"].buf.getvalue(), r["host"].buf.getvalue()
        bytes_apart = int(np.count_nonzero(
            np.frombuffer(got, np.uint8) != np.frombuffer(want, np.uint8))) \
            if len(got) == len(want) else -1
        check(len(got) > 0 and bytes_apart == 0,
              "48 kHz streaming add (%s): %d of %d bytes differ from the "
              "host finish" % (output, bytes_apart, len(want)))
        finish = {k: v for k, v in r["counters"].items()
                  if k.startswith("add.finish")}
        name = "add.finish_i16" if output == "wav16" else "add.finish_f32"
        check(set(r["device"].dtypes) == {np.dtype(
            np.int16 if output == "wav16" else np.float32)},
              "48 kHz streaming add (%s): the writer got %s"
              % (output, sorted(set(map(str, r["device"].dtypes)))))
        check(finish == {name: r["writes"]},
              "48 kHz streaming add (%s): counters %s, %d tiles written"
              % (output, finish, r["writes"]))
        fields["add_48k_%s" % output] = dict(
            seconds=secs, known_length=known, tiles=r["tiles"],
            writes=r["writes"], bytes=len(got), bytes_apart=0, **finish)
    phase("finish", card=smi, **fields)


def smi_lines():
    """`nvidia-smi --query-gpu=name,power.limit` of every card, one line
    each."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()


def sync_cards(n):
    for i in range(n):
        torch.cuda.synchronize(i)


def one_and_all(n, fn, same, what):
    """fn(where) on one card (where = "one": AUDIOWMARK_MULTICHIP=0) and on
    all n cards ("all"), in the order one, all, all, one: the first two
    calls are the first of their kind in the process, the last two warm.
    Every result must equal the one-card call's (`same(a, b)`).  Returns
    (the one-card result, the fields: wall s first and warm, and per card
    K1's and K2's launches and the peak of allocated memory in each first
    call)."""
    from audiowmark_tpu_torch.ops import resample, viterbi
    fields, results = {}, {}
    try:
        for i, where in enumerate(("one", "all", "all", "one")):
            os.environ["AUDIOWMARK_MULTICHIP"] = "0" if where == "one" else "1"
            run = "first" if i < 2 else "warm"
            sync_cards(n)
            viterbi.LAUNCHES_BY_CARD.clear()
            resample.LAUNCHES_BY_CARD.clear()
            for c in range(n):
                torch.cuda.reset_peak_memory_stats(c)
            t0 = time.perf_counter()
            result = fn(where)
            sync_cards(n)
            fields["%s_%s_s" % (where, run)] = time.perf_counter() - t0
            if run == "first":
                fields[where + "_k1_by_card"] = [
                    viterbi.LAUNCHES_BY_CARD[c] for c in range(n)]
                fields[where + "_k2_by_card"] = [
                    resample.LAUNCHES_BY_CARD[c] for c in range(n)]
                fields[where + "_peak_bytes_by_card"] = [
                    torch.cuda.max_memory_allocated(c) for c in range(n)]
            check(same(results.setdefault("one", result), result),
                  "%s: the %s call (%s) differs from the first one-card "
                  "call" % (what, where, run))
    finally:
        os.environ.pop("AUDIOWMARK_MULTICHIP", None)
    return results["one"], fields


def cards_k1(n, smi):
    """26a. K1 vs its plain version on every card at B = 1, 8, 24, 256
    (143 steps), each launch counted on its card."""
    from audiowmark_tpu_torch.ops import viterbi
    by_card = []
    for c in range(n):
        checks = []
        for batch in CARDS_K1_BATCHES:
            viterbi.LAUNCHES_BY_CARD.clear()
            checks.append(k1_check(batch + c, batch, 143,
                                   torch.device("cuda", c)))
            check(viterbi.LAUNCHES_BY_CARD.get(c, 0) > 0
                  and set(viterbi.LAUNCHES_BY_CARD) == {c},
                  "K1 on cuda:%d launched on %s" % (
                      c, dict(viterbi.LAUNCHES_BY_CARD)))
        by_card.append(checks)
        phase("cards_k1", card_index=c, card=smi[c], checks=[
            {k: ck[k] for k in ("batch", "steps", "cluster", "ms", "plain_ms",
                                "bound_ms", "share", "max_abs_err")}
            for ck in checks])
    return by_card


def cards_k2(n, smi):
    """26a. K2 against its plain version on every card (phase 27's check,
    on that card) at 48 -> 44.1 kHz with float64 coefficients and at a
    speed scan's centre with float32 ones, each launch counted on its
    card."""
    from audiowmark_tpu_torch.ops import resample
    rng = np.random.RandomState(26)
    by_card = []
    for c in range(n):
        resample.LAUNCHES_BY_CARD.clear()
        checks = [k2_check(48000, 44100, torch.float64, 65613, rng,
                           device=torch.device("cuda", c)),
                  k2_check(100, 49, torch.float32, 65613, rng,
                           device=torch.device("cuda", c))]
        check(dict(resample.LAUNCHES_BY_CARD) == {c: len(checks)},
              "K2 on cuda:%d launched on %s" % (
                  c, dict(resample.LAUNCHES_BY_CARD)))
        by_card.append(checks)
        phase("cards_k2", card_index=c, card=smi[c], checks=checks)
    return by_card


def cards_group(port, key, d, n, smi):
    """26b. cmp of the 32-min marked file in 6-min chunks (groups of n on
    n cards) and in the default 30-min chunks, on all cards and on one:
    stdout byte-equal."""
    from audiowmark_tpu_torch.models import syncfinder as sf
    groups = []
    real = sf.search_block_group

    def recording(key_list, wavs, device=None, xs=None):
        out = real(key_list, wavs, device, xs)
        groups.append((len(wavs), out is not None))
        return out

    fields = {}
    sf.search_block_group = recording
    try:
        for name, minutes in (("6min", CARDS_CHUNK_MINUTES), ("30min", None)):
            params = {} if minutes is None else {"get_chunk_size": minutes}
            seen = {}

            def get(where):
                groups.clear()
                rc, _, text = cmp(port, key, os.path.join(d, "wmlong.wav"),
                                  None, **params)
                seen[where] = list(groups)
                return rc, text

            (rc, text), f = one_and_all(n, get, lambda a, b: a == b,
                                        "the 32-min cmp (%s chunks)" % name)
            counts = [line for line in text.splitlines()
                      if line.startswith("match_count")]
            check(rc == 0 and len(counts) == 1 and "pattern" in text,
                  "the 32-min cmp: rc %d\n%s" % (rc, text))
            check(not seen["one"], "a group search with one card")
            if minutes is not None:
                check(seen["all"] and all(ok for _, ok in seen["all"])
                      and max(k for k, _ in seen["all"]) == n,
                      "6-min chunks on %d cards gave groups %s"
                      % (n, seen["all"]))
            fields[name] = dict(f, match_count=counts[0],
                                groups_all=seen["all"])
    finally:
        sf.search_block_group = real
    phase("cards_group", card=smi, **fields)
    return fields


def cards_speed(port, key, d, n, smi):
    """26c. cmp --detect-speed and --detect-speed-patient of the 30 s file
    played at 0.9764, on all cards and on one: stdout equal; the scans'
    centres split over the cards."""
    from audiowmark_tpu_torch.ops import speed as speed_ops
    path = os.path.join(d, "speed_%s.wav" % CARDS_SPEED)
    shares = []
    real_scan, real_mag = speed_ops.speed_scan, speed_ops._center_mag_matrix

    def scan(*a, **kw):
        shares.append([])
        t0 = time.perf_counter()
        out = real_scan(*a, **kw)
        scan_s.append(time.perf_counter() - t0)
        return out

    def mag(x, *a):
        # one centre on that device, and the host's seconds in its
        # resampling and mag matrix (blocking uploads included)
        t0 = time.perf_counter()
        out = real_mag(x, *a)
        shares[-1].append((x.device, time.perf_counter() - t0))
        return out

    fields, scan_s = {}, []
    speed_ops.speed_scan, speed_ops._center_mag_matrix = scan, mag
    try:
        for option in ("detect_speed", "detect_speed_patient"):
            seen, host = {}, {}

            def get(where):
                shares.clear()
                scan_s.clear()
                rc, _, text = cmp(port, key, path, 1,
                                  test_speed=float(CARDS_SPEED),
                                  **{option: True})
                cards = [torch.device("cuda", c) for c in range(n)]
                seen[where] = [[sum(dev == card for dev, _ in s)
                                for card in cards] for s in shares]
                host[where] = dict(scans_s=sum(scan_s), centres_host_s=[
                    sum(t for s in shares for dev, t in s if dev == card)
                    for card in cards])
                return text

            text, f = one_and_all(n, get, lambda a, b: a == b,
                                  "cmp --%s" % option.replace("_", "-"))
            line = [x for x in text.splitlines()
                    if x.startswith("detect_speed ")]
            check(len(line) == 1, "no detect_speed line in:\n" + text)
            for s in seen["all"]:
                total = sum(s)
                if not total:
                    continue
                per = -(-total // min(n, total))
                check(s == [min(per, max(total - c * per, 0))
                            for c in range(n)],
                      "the centres split over the cards as %s" % s)
            check(all(s[1:] == [0] * (n - 1) for s in seen["one"]),
                  "one card's scan split its centres: %s" % seen["one"])
            check(all(f["all_k2_by_card"]) and f["one_k2_by_card"][0]
                  and not any(f["one_k2_by_card"][1:]),
                  "the resampler's K2 launches by card: %s on %d cards, %s "
                  "on one" % (f["all_k2_by_card"], n, f["one_k2_by_card"]))
            fields[option] = dict(f, detect_speed=line[0],
                                  centres_by_card=seen["all"],
                                  warm_host=host)
    finally:
        speed_ops.speed_scan, speed_ops._center_mag_matrix = \
            real_scan, real_mag
    phase("cards_speed", card=smi, **fields)
    return fields


def cards_fleet(key, n, smi):
    """26d. watermark_batch on the (n, 1) mesh and, with one frame of
    padding, on the (2, n/2) mesh, 0 samples apart from the (1, 1) call;
    detect_batch over the cards: every array equal to the one-card call,
    K1 launched once on each card."""
    from audiowmark_tpu_torch.models.common import parse_payload
    from audiowmark_tpu_torch.ops import detect_fused
    from audiowmark_tpu_torch.params import Params
    from audiowmark_tpu_torch.parallel import batch as fleet
    from audiowmark_tpu_torch.parallel.mesh import make_mesh
    set_params()
    rng = np.random.default_rng(16)
    audio = (rng.random((FLEET_STREAMS, FLEET_SECONDS * 44100, 2),
                        dtype=np.float32) - np.float32(0.5)) * np.float32(0.6)
    check((audio.shape[1] // 1024) % 2 == 1,
          "the fleet's streams have an even frame count")
    # (2, n/2) splits the frames in two: one frame of zeros makes them even
    padded = np.concatenate(
        [audio, np.zeros((FLEET_STREAMS, 1024, 2), np.float32)], axis=1)
    fields = {}
    sharded = "2x%d" % (n // 2)
    for name, x, dp, shape in (("%dx1" % n, audio, 0, (n, 1)),
                               (sharded, padded, 2, (2, n // 2))):
        def mark(where, x=x, dp=dp, shape=shape):
            mesh = make_mesh(dp=dp if where == "all" else 0)
            check(mesh.shape == (shape if where == "all" else (1, 1)),
                  "make_mesh gave %s" % (mesh.shape,))
            return fleet.watermark_batch(key, x, MSG, mesh=mesh)

        marked, f = one_and_all(n, mark, np.array_equal,
                                "watermark_batch on the %s mesh" % name)
        check(np.isfinite(marked).all()
              and float(np.abs(marked - x).max()) > 1e-4,
              "watermark_batch returned something else than marked audio")
        fields["watermark_" + name] = dict(f, samples_apart=0)
        if name != sharded:
            unpadded = marked

    # the host's seconds in each share's detector call: the call enqueues
    # the share's work and returns without reading anything back
    forward, enqueue = detect_fused.FusedDetector.forward, {}

    def clocked(self, samples):
        t0 = time.perf_counter()
        out = forward(self, samples)
        spent.append((samples.device, time.perf_counter() - t0))
        return out

    def detect(where):
        spent.clear()
        out = fleet.detect_batch(key, unpadded, top_k=FLEET_TOP_K)
        enqueue[where] = [sum(t for dev, t in spent
                              if dev == torch.device("cuda", c))
                          for c in range(n)]
        return out

    spent = []
    detect_fused.FusedDetector.forward = clocked
    try:
        out, f = one_and_all(
            n, detect, lambda a, b: set(a) == set(b) and all(
                np.array_equal(a[k], b[k]) for k in a), "detect_batch")
    finally:
        detect_fused.FusedDetector.forward = forward
    f["warm_enqueue_s_by_card"] = enqueue
    check(f["all_k1_by_card"] == [1] * n and f["one_k1_by_card"]
          == [1] + [0] * (n - 1), "detect_batch launched K1 %s on %d cards"
          " and %s on one" % (f["all_k1_by_card"], n, f["one_k1_by_card"]))
    want = parse_payload(MSG).tolist()
    for b in range(FLEET_STREAMS):
        q = np.where(out["eligible"][b], out["qualities"][b], -1.0)
        best = int(np.argmax(q))
        check(q[best] > Params.sync_threshold2
              and out["bits"][b][best].tolist() == want,
              "stream %d: the best slot is not the message" % b)
    fields["detect"] = f
    phase("cards_fleet", streams=FLEET_STREAMS, seconds_each=FLEET_SECONDS,
          top_k=FLEET_TOP_K, card=smi, **fields)
    return fields


def cards_cli(d, n, smi):
    """26e. the command line as processes of their own on all cards and
    with AUDIOWMARK_MULTICHIP=0: add (the files' bytes), cmp
    --expect-matches 5, get --json (the JSON text) and cmp --detect-speed
    and --detect-speed-patient (stdout) equal."""
    speed_file = os.path.join(d, "speed_%s.wav" % CARDS_SPEED)
    fields, outs = {}, {}
    for where, flag in (("one", "0"), ("all", "1")):
        env = dict(card_env(), AUDIOWMARK_MULTICHIP=flag)
        wm = os.path.join(d, "cli_wm_%s.wav" % where)
        js = os.path.join(d, "cli_%s.json" % where)
        runs = (("add", ["add", os.path.join(d, "n200.wav"), wm, MSG]),
                ("cmp", ["cmp", wm, MSG, "--expect-matches", "5"]),
                ("get_json", ["get", wm, "--json", js]),
                ("detect_speed", ["cmp", speed_file, MSG, "--detect-speed",
                                  "--test-speed", CARDS_SPEED]),
                ("detect_speed_patient",
                 ["cmp", speed_file, MSG, "--detect-speed-patient",
                  "--test-speed", CARDS_SPEED]))
        for name, args in runs:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "audiowmark_tpu_torch"] + args,
                cwd=REPO, env=env, capture_output=True, text=True,
                timeout=600)
            fields["%s_%s_s" % (where, name)] = time.perf_counter() - t0
            check(proc.returncode == 0, "%s (%s): exit %d:\n%s\n%s" % (
                " ".join(args), where, proc.returncode, proc.stdout,
                proc.stderr))
            outs[where, name] = proc.stdout
        with open(wm, "rb") as f:
            outs[where, "file"] = f.read()
        with open(js) as f:
            outs[where, "json"] = f.read()
    for name in ("add", "cmp", "get_json", "detect_speed",
                 "detect_speed_patient", "file", "json"):
        check(outs["one", name] == outs["all", name],
              "the command line's %s on %d cards differs from one card"
              % (name, n))
    check("\nmatch_count 5 " in "\n" + outs["all", "cmp"]
          and "detect_speed " in outs["all", "detect_speed"]
          and "detect_speed " in outs["all", "detect_speed_patient"],
          "the command line printed:\n%s" % outs["all", "cmp"])
    phase("cards_cli", card=smi, add_bytes=len(outs["all", "file"]),
          **fields)
    return fields


def phase_cards(port, n, smi):
    """26. every path of the port that splits over cards, on n cards
    against one.  Returns the kernels line's entries, K1's and K2's."""
    from audiowmark_tpu_torch.crypto.keys import Key
    from audiowmark_tpu_torch.fixtures import gen_noise, long_noise
    from audiowmark_tpu_torch.io.wavdata import WavData
    from audiowmark_tpu_torch.ops import viterbi
    from audiowmark_tpu_torch.ops.resample import resample_ratio
    t_phase = time.perf_counter()
    by_card = cards_k1(n, smi)
    k2_by_card = cards_k2(n, smi)

    key = Key()
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".chip_smoke_") as d:
        t0 = time.perf_counter()
        long_noise(1, os.path.join(d, "nlong.wav"), LONG_MINUTES * 60, 44100)
        add(port, key, os.path.join(d, "nlong.wav"),
            os.path.join(d, "wmlong.wav"))
        os.remove(os.path.join(d, "nlong.wav"))
        for secs in (200, 30):
            gen_noise(key, os.path.join(d, "n%d.wav" % secs), secs, 44100)
        add(port, key, os.path.join(d, "n30.wav"), os.path.join(d, "wm30.wav"))
        resample_ratio(WavData.load(os.path.join(d, "wm30.wav")),
                       1 / float(CARDS_SPEED), 44100).save(
            os.path.join(d, "speed_%s.wav" % CARDS_SPEED))
        phase("cards_fixtures", seconds=time.perf_counter() - t0)

        # ---- the paths: K1's launches on each card counted per path ----
        paths = {"group": cards_group(port, key, d, n, smi),
                 "speed": cards_speed(port, key, d, n, smi),
                 "fleet": cards_fleet(key, n, smi)}
        cli = cards_cli(d, n, smi)

    launches = [0] * n
    flat = {}
    for name, fields in paths.items():
        for sub, f in fields.items():
            if sub in ("6min", "30min", "detect_speed",
                       "detect_speed_patient", "detect"):
                flat[name + "_" + sub] = f["all_k1_by_card"]
                launches = [a + b for a, b in zip(launches,
                                                  f["all_k1_by_card"])]
    check(all(launches), "K1 never launched on some card: %s" % launches)
    # K2 on the paths that resample on several cards: the speed scans
    k2_flat = {"speed_" + sub: f["all_k2_by_card"]
               for sub, f in paths["speed"].items()}
    k2_launches = [sum(col) for col in zip(*k2_flat.values())]
    phase("cards", cards=n, k1_launches_by_card=launches,
          k1_launches_by_path=flat, k2_launches_by_card=k2_launches,
          k2_launches_by_path=k2_flat, cli_s=cli,
          seconds=time.perf_counter() - t_phase, card=smi)
    headline = by_card[0][-1]
    return [{
        "name": "viterbi_acs",
        "route": "cuda",
        "source": "audiowmark_tpu_torch/csrc/viterbi_acs.cu",
        "replaces": "audiowmark_tpu/ops/viterbi_pallas.py:128",
        "launches": sum(launches),
        "launches_by_card": launches,
        "launches_by_path": flat,
        "max_abs_err": max(c["max_abs_err"] for checks in by_card
                           for c in checks),
        "ms": headline["ms"],
        "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "batch": headline["batch"],
        "steps": headline["steps"],
        "by_card": [{str(c["batch"]): c["ms"] for c in checks}
                    for checks in by_card],
    }, {
        "name": "resample_k2",
        "route": "cuda",
        "source": "audiowmark_tpu_torch/csrc/resample_k2.cu",
        "replaces": None,
        "launches": sum(k2_launches),
        "launches_by_card": k2_launches,
        "launches_by_path": k2_flat,
        "max_abs_err": max(c["max_abs_err"] for checks in k2_by_card
                           for c in checks),
    }]


def main_path(port, key, d, n200, wm200, smi):
    """5.-7. 200 s add and cmp (cold, warm), the SNR, 60 s and 30 s."""
    from audiowmark_tpu_torch.io.wavdata import WavData
    for run in ("cold", "warm"):
        add_s, get_s, _ = add_and_cmp(port, key, n200, wm200, 5)
        phase("200s_" + run, add_s=add_s, get_s=get_s,
              add_realtime=200 / add_s, get_realtime=200 / get_s, card=smi)

    nolim = os.path.join(d, "wm_nolim.wav")
    add_and_cmp(port, key, n200, nolim, 5, test_no_limiter=True)
    o = WavData.load(n200).samples.astype(np.float64)
    w = WavData.load(nolim).samples.astype(np.float64)
    check(o.shape == w.shape and np.isfinite(w).all(),
          "marked file has another length or non-finite samples")
    snr = 10 * np.log10(np.sum(o * o) / np.sum((o - w) ** 2))
    check(snr >= SNR_FLOOR_DB, "SNR %.3f dB < %.1f dB" % (snr, SNR_FLOOR_DB))
    phase("snr", snr_db=snr, floor_db=SNR_FLOOR_DB)

    for secs, expect in ((60, 3), (30, 1)):
        add_s, get_s, _ = add_and_cmp(
            port, key, os.path.join(d, "n%d.wav" % secs),
            os.path.join(d, "wm%d.wav" % secs), expect)
        phase("%ds" % secs, match_count=expect, add_s=add_s, get_s=get_s)


def earlier_phases(port, key, d, smi, checks):
    """5.-15.; returns K1's launches by path, the main path's K1 check,
    the branch metrics' preparation time and phase 15's process walls."""
    from audiowmark_tpu_torch.ops import viterbi
    # ---- 5.-7. the main path; K1's launch count starts at 0 here ----
    n200, wm200 = os.path.join(d, "n200.wav"), os.path.join(d, "wm.wav")
    viterbi.LAUNCHES = 0
    _, shapes = batches_of(
        lambda: main_path(port, key, d, n200, wm200, smi))

    # ---- 8. the main path went through K1 ----
    paths = {"main": viterbi.LAUNCHES}
    check(paths["main"] > 0, "the main path never launched K1")
    batch, steps = max(shapes)
    checks.append(k1_check(2, batch, steps))
    prep_ms = bm_prep_ms(batch, steps)
    phase("launches", viterbi_acs=paths["main"],
          k1_batches=sorted(set(shapes)), k1_check=checks[-1],
          bm_prep_ms=prep_ms, card=smi)
    main_check = checks[-1]

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
    checks.append(long_check)

    # ---- 14.-15. replay-speed detection, the command line ----
    paths["speed"], speed_check = phase_speed(port, key, d, smi)
    checks.append(speed_check)
    cli_s = phase_cli(d, smi)

    return paths, main_check, prep_ms, cli_s


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on a CUDA card",
              file=sys.stderr)
        return 1
    args = sys.argv[1:]
    new_only = args == ["--new-only"]
    n_cards = int(args[1]) if len(args) == 2 and args[0] == "--cards" \
        and args[1].isdigit() else 0
    check(new_only or n_cards or not args,
          "usage: chip_smoke.py [--new-only | --cards N]")
    # no fallback: --cards N runs on a machine of exactly N cards or fails
    check(not n_cards or (n_cards >= 2 and n_cards % 2 == 0
                          and torch.cuda.device_count() == n_cards),
          "--cards %d needs an even N >= 2 and a machine of exactly N CUDA "
          "cards; this one has %d" % (n_cards, torch.cuda.device_count()))
    t_script = time.perf_counter()
    import audiowmark_tpu_torch as port
    from audiowmark_tpu_torch.crypto.keys import Key
    from audiowmark_tpu_torch import cuda_build
    from audiowmark_tpu_torch.fixtures import gen_noise
    from audiowmark_tpu_torch.ops import frames, resample, viterbi

    # ---- 1. environment ----
    name = torch.cuda.get_device_name(0)
    smi_all = smi_lines()
    smi = smi_all[0]
    check(not n_cards or len(smi_all) == n_cards,
          "nvidia-smi lists %d cards, not %d" % (len(smi_all), n_cards))
    for line in smi_all if n_cards else [smi]:
        print(line, flush=True)
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
    ptxas = [line.split("info    :")[-1].strip() for line in
             cuda_build.ptxas_report("viterbi_acs").splitlines()
             if "registers" in line or "spill" in line]
    phase("build", kernel="viterbi_acs", seconds=time.perf_counter() - t0,
          library=os.path.relpath(lib_path, REPO), ptxas=ptxas)
    t0 = time.perf_counter()
    lib_path = cuda_build.build("resample_k2")
    resample._library()
    ptxas = [line.split("info    :")[-1].strip() for line in
             cuda_build.ptxas_report("resample_k2").splitlines()
             if "registers" in line or "spill" in line]
    phase("build", kernel="resample_k2", seconds=time.perf_counter() - t0,
          library=os.path.relpath(lib_path, REPO), ptxas=ptxas)

    if n_cards:
        # ---- 26. the paths that split over the cards ----
        kernels = phase_cards(port, n_cards, smi_all)
        phase("total", seconds=time.perf_counter() - t_script, card=smi_all)
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    if new_only:
        # ---- 27. K2 against its plain version; 28. the add's finish ----
        phase_k2(smi)
        phase_finish(smi)
        phase("total", seconds=time.perf_counter() - t_script, card=smi)
        return 0

    # ---- 3. K1 vs plain on the card ----
    checks = []
    for batch in K1_BATCHES:
        checks.append(k1_check(batch, batch, K1_STEPS))
        phase("k1_check", decisions_differ=0, card=smi, **checks[-1])

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

        paths, main_check, prep_ms, cli_s = earlier_phases(
            port, key, d, smi, checks)
        # ---- 16.-19. the fleet API, groups and prefetch, HLS, the trace ----
        paths["fleet"], fleet_check, marked = phase_fleet(key, smi)
        checks.append(fleet_check)
        paths["group"] = phase_group(port, key, d, marked, smi)
        del marked
        paths["hls"] = phase_hls(port, key, d, smi)
        phase_profile(d, smi)

        # ---- 20.-21. the command line's modes, the codec-free BER rows ----
        paths["modes"] = phase_modes(port, d, smi, checks)
        paths["ber"] = phase_ber(d, smi)

        # ---- 22.-24. the shell's streams, the strength sweep, the time to
        # first byte ----
        paths["streams"] = phase_streams(d, smi)
        phase_quality(d, smi)
        paths["ttfb"] = phase_ttfb(d, smi, cli_s)

        # ---- 25. other channel counts and rates ----
        paths["channels"] = phase_channels(d, smi)

        # ---- 27. K2 against its plain version ----
        k2 = phase_k2(smi)

        # ---- 28. the streaming add finishes each tile on the card ----
        phase_finish(smi)

    phase("total", seconds=time.perf_counter() - t_script, card=smi)

    # the headline numbers are those at the main path's largest batch
    print(json.dumps({"kernels": [{
        "name": "viterbi_acs",
        "route": "cuda",
        "source": "audiowmark_tpu_torch/csrc/viterbi_acs.cu",
        "replaces": "audiowmark_tpu/ops/viterbi_pallas.py:128",
        "launches": sum(paths.values()),
        "launches_by_path": paths,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main_check["ms"],
        "plain_ms": main_check["plain_ms"],
        "bound_ms": main_check["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "batch": main_check["batch"],
        "steps": main_check["steps"],
        "cluster": main_check["cluster"],
        "share": main_check["share"],
        "bm_prep_ms": prep_ms,
        "fleet": {k: fleet_check[k] for k in (
            "batch", "steps", "cluster", "ms", "plain_ms", "bound_ms",
            "share")},
        "checks": checks,
    }, dict(k2, launches=sum(K2_PATHS.values()),
            launches_by_path=K2_PATHS)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The strength sweep of docs/QUALITY.md on the port: SNR and a Bark-band
noise-to-mask ratio (NMR) of the watermark at strengths 30 ... 1 on two
carriers, and the mp3 bitrate ladder that calibrates the NMR.

    python3 -m audiowmark_tpu_torch.quality_report [--seconds 30]
        [--out docs/QUALITY_torch.md]

The port's copy of what tools/quality_report.py computes (the port imports
nothing of tools/): the carriers (test-gen-noise scaled to 0.6 peak, and
ber_row.gen_tonal, tools/ber_report.py's tonal carrier sample for sample),
the SNR that the port's `add --strength S --snr` prints, `nmr_db`, the mp3
anchors (`_align_delay`, `mp3_anchor_nmr`, `odg_region`) and the tool's
checks (`checks`):
  * SNR monotone decreasing in strength, within 0.1 dB;
  * at strength 10 SNR >= 20 dB and NMR <= 0 dB on both carriers;
  * the anchor ladder NMR-monotone on both carriers;
  * the strength-10 NMR at or under the mp3@256 anchor (+0.1 dB) on the
    noise carrier and 10 dB under the mp3@64 anchor on the tonal one.
The table is docs/QUALITY.md's with docs/QUALITY.md's number beside each
of the port's.  The anchors need libmp3lame (and libmpg123 to read the mp3
back); where they do not load they are listed as not run, with the library
named, and so are the checks that need them.  Exits 1 when a check that ran
fails.

Runs on the CUDA card (AUDIOWMARK_TORCH_DEVICE=cpu: on the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import io
import os
import re
import sys
import tempfile

import numpy as np

from .ber_row import gen_tonal
from .cli import main as cli_main
from .crypto.keys import Key
from .fixtures import gen_noise as _gen_noise
from .io import lame, mpg123
from .io.wavdata import WavData
from .params import Params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(REPO, "docs", "QUALITY.md")
PATTERN = "4e1243bd22c66e76c2ba9eddc1f91394"   # snr.sh's pseudo pattern
STRENGTHS = [30, 20, 15, 10, 5, 3, 2, 1]       # strength2snr.sh sweep
RATE = 44100
CARRIERS = ("noise", "music")


# ---------------------------------------------------------------- carriers

def gen_noise(path: str, seconds: int) -> None:
    """test-gen-noise scaled to 0.6 peak (at full scale the limiter's gain
    riding would dominate the delta the NMR measures)."""
    _gen_noise(Key(), path, seconds, RATE)
    w = WavData.load(path)
    scaled = w.samples * (0.6 / np.max(np.abs(w.samples)))
    WavData(scaled.astype(np.float32), w.n_channels, w.sample_rate,
            w.bit_depth).save(path)


def gen_music(path: str, seconds: int) -> None:
    gen_tonal(path, seconds, RATE)


GENERATORS = {"noise": gen_noise, "music": gen_music}


# ---------------------------------------------------------------- embed

def add_with_snr(src: str, dst: str, strength: int, device=None) -> float:
    """`add --strength S --snr` through the port's command line on
    `device` (None: as the environment says, the card by default); the SNR
    dB it prints."""
    Params.reset()
    err = io.StringIO()
    env_before = os.environ.get("AUDIOWMARK_TORCH_DEVICE")
    if device is not None:
        os.environ["AUDIOWMARK_TORCH_DEVICE"] = str(device)
    try:
        with contextlib.redirect_stderr(err):
            rc = cli_main(["add", src, dst, PATTERN,
                           "--strength", str(strength), "--snr"])
    finally:
        Params.reset()
        if device is not None:
            if env_before is None:
                del os.environ["AUDIOWMARK_TORCH_DEVICE"]
            else:
                os.environ["AUDIOWMARK_TORCH_DEVICE"] = env_before
    if rc != 0:
        raise RuntimeError("add --strength %s --snr failed:\n%s"
                           % (strength, err.getvalue()))
    m = re.search(r"SNR:\s+([-0-9.]+) dB", err.getvalue())
    if not m:
        raise RuntimeError("no SNR line in:\n" + err.getvalue())
    return float(m.group(1))


# ---------------------------------------------------------------- NMR proxy

_FFT = 2048
_HOP = 1024
_N_BARK = 24


def _bark(f):
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _ath_db(f):
    """Absolute threshold in quiet (Terhardt), dB SPL; clamped for f=0."""
    khz = np.maximum(f, 20.0) / 1000.0
    return (3.64 * khz ** -0.8 - 6.5 * np.exp(-0.6 * (khz - 3.3) ** 2)
            + 1e-3 * khz ** 4)


def nmr_db(orig: np.ndarray, marked: np.ndarray, n_channels: int) -> float:
    """Mean noise-to-mask ratio of the watermark delta, dB.

    Per-frame Bark-band signal energies, spread with -27 dB/Bark upward
    and -10 dB/Bark downward slopes, offset by the Johnston tonality
    interpolation alpha*(14.5 + z) + (1 - alpha)*5.5 dB (alpha from the
    spectral flatness), floored at the absolute threshold in quiet (a
    full-scale 4 kHz sine at 96 dB SPL), with forward masking of 5 dB per
    23 ms hop carried across frames."""
    orig = orig.reshape(-1, n_channels).astype(np.float64)
    marked = marked.reshape(-1, n_channels).astype(np.float64)
    n = min(orig.shape[0], marked.shape[0])
    delta = marked[:n] - orig[:n]
    orig = orig[:n]

    freqs = np.fft.rfftfreq(_FFT, 1.0 / RATE)
    band = np.minimum(_bark(freqs).astype(np.int32), _N_BARK - 1)
    group = np.zeros((_N_BARK, freqs.size))
    group[band, np.arange(freqs.size)] = 1.0
    zc = np.array([np.mean(_bark(freqs)[band == b]) if np.any(band == b)
                   else b for b in range(_N_BARK)])
    # spreading matrix (dB slopes -> linear gains, row = masked band)
    dz = zc[:, None] - zc[None, :]          # masked - masker
    spread_db = np.where(dz >= 0, -27.0 * dz, 10.0 * dz)
    spread = 10.0 ** (spread_db / 10.0)
    # ATH in the same power units: full-scale sine ~ 96 dB SPL
    ath_pow = 10.0 ** ((_ath_db(freqs) - 96.0) / 10.0) * (_FFT / 2.0) ** 2
    ath_band = group @ ath_pow

    win = np.hanning(_FFT)
    n_frames = max(0, (n - _FFT) // _HOP + 1)
    post_decay = 10.0 ** (-5.0 / 10.0)     # -5 dB per hop forward masking
    ratios = []
    for ch in range(n_channels):
        prev_thr = np.zeros(_N_BARK)
        for k in range(n_frames):
            i0 = k * _HOP
            s = np.fft.rfft(orig[i0:i0 + _FFT, ch] * win)
            d = np.fft.rfft(delta[i0:i0 + _FFT, ch] * win)
            spow = group @ (np.abs(s) ** 2)
            dpow = group @ (np.abs(d) ** 2)
            if np.sum(spow) < 1e-9:        # silent frame: nothing to mask
                continue
            masked = spread @ spow
            # tonality via spectral flatness (geometric/arithmetic mean)
            p = np.abs(s) ** 2 + 1e-30
            sfm_db = 10.0 * (np.mean(np.log10(p)) - np.log10(np.mean(p)))
            alpha = min(sfm_db / -60.0, 1.0)
            offset_db = alpha * (14.5 + zc) + (1.0 - alpha) * 5.5
            offset = 10.0 ** (-offset_db / 10.0)
            thr = np.maximum(masked * offset, ath_band)
            thr = np.maximum(thr, prev_thr * post_decay)
            prev_thr = thr
            ratios.append(np.mean(dpow / thr))
    return 10.0 * np.log10(np.mean(ratios)) if ratios else float("-inf")


# ------------------------------------------------------- codec anchors

# the mp3 ladder that calibrates the proxy: stereo mp3 at >= 256 kbit/s is
# transparent (ODG ~ 0 .. -0.5), 128 kbit/s "perceptible, not annoying"
# (ODG ~ -1 .. -2 on critical items), 64 kbit/s clearly degraded (<= -3);
# the ODG points serve only the ordinal interpolation of odg_region
ANCHOR_BITRATES = [320, 256, 128, 64]
ANCHOR_ODG = {320: -0.2, 256: -0.5, 128: -1.5, 64: -3.2}


def anchors_missing():
    """The library the mp3 anchors need where it does not load here, else
    None."""
    if not lame.available():
        return "libmp3lame"
    if not mpg123.available():
        return "libmpg123"
    return None


def _align_delay(ref: np.ndarray, test: np.ndarray, n_channels: int,
                 max_lag: int = 4096) -> int:
    """The lag of `test` behind `ref` (a codec's delay), by
    cross-correlating one channel over the first 5 s."""
    a = ref.reshape(-1, n_channels)[: RATE * 5, 0].astype(np.float64)
    b = test.reshape(-1, n_channels)[: RATE * 5 + max_lag, 0] \
        .astype(np.float64)
    n = 1
    while n < b.size:
        n *= 2
    corr = np.fft.irfft(np.fft.rfft(b, n) * np.conj(np.fft.rfft(a, n)), n)
    return int(np.argmax(corr[: max_lag + 1]))


def mp3_anchor_nmr(orig: WavData, bitrate: int) -> float:
    """NMR of an mp3 round trip at `bitrate` against the original: the
    codec's noise scored by the model that scores the watermark."""
    data = lame.encode_mp3(orig.samples, orig.n_channels, orig.sample_rate,
                           bitrate)
    with tempfile.NamedTemporaryFile(suffix=".mp3", delete=False) as f:
        f.write(data)
        name = f.name
    try:
        dec = WavData.load(name)
    finally:
        os.remove(name)
    lag = _align_delay(orig.samples, dec.samples, orig.n_channels)
    aligned = dec.samples.reshape(-1, orig.n_channels)[lag:].reshape(-1)
    return nmr_db(orig.samples, aligned, orig.n_channels)


def odg_region(nmr: float, anchors: dict) -> str:
    """`nmr` placed on the anchor ladder: the ODG operating points,
    linear between neighbours."""
    pts = sorted(((v, ANCHOR_ODG[b]) for b, v in anchors.items()))
    if nmr <= pts[0][0]:
        return "<= %.1f (at/under the %s anchor)" % (
            pts[0][1], "transparent")
    for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
        if nmr <= x1:
            t = (nmr - x0) / (x1 - x0) if x1 > x0 else 0.0
            return "~ %.1f" % (y0 + t * (y1 - y0))
    return ">= %.1f (beyond the lowest anchor)" % pts[-1][1]


# ---------------------------------------------------------------- checks

def checks(carrier: str, rows, anchors=None):
    """The tool's checks on one carrier's rows [(strength, SNR, NMR)] in
    STRENGTHS order (any subset that holds strength 10) and its anchors
    {bitrate: NMR} (None: not run, nor the checks that need them); the
    list of failures."""
    failures = []
    for (s1, v1, _), (s2, v2, _) in zip(rows, rows[1:]):
        if v2 < v1 - 0.1:            # a weaker mark must raise the SNR
            failures.append("%s: SNR not monotone at %d->%d (%.2f -> %.2f)"
                            % (carrier, s1, s2, v1, v2))
    snr10, nmr10 = [(snr, nmr) for s, snr, nmr in rows if s == 10][0]
    if snr10 < 20.0:
        failures.append("%s: SNR at strength 10 = %.2f < 20 dB"
                        % (carrier, snr10))
    if nmr10 > 0.0:
        failures.append("%s: NMR at strength 10 = %.2f > 0 dB"
                        % (carrier, nmr10))
    if anchors is None:
        return failures
    ladder = [anchors[b] for b in sorted(ANCHOR_BITRATES, reverse=True)]
    if not all(x < y + 0.1 for x, y in zip(ladder, ladder[1:])):
        failures.append("%s: anchor ladder not monotone (%s)" % (
            carrier, ["%.2f" % v for v in ladder]))
    # noise: at/under the transparent mp3@256 anchor; the sparse tonal
    # carrier: 10 dB under the clearly degraded mp3@64 anchor
    gate_br = 256 if carrier == "noise" else 64
    margin = 0.1 if gate_br == 256 else -10.0
    if nmr10 > anchors[gate_br] + margin:
        failures.append("%s: watermark strength 10 NMR %.2f exceeds the "
                        "mp3@%d anchor %.2f"
                        % (carrier, nmr10, gate_br, anchors[gate_br]))
    return failures


# ---------------------------------------------------------------- run

def sweep(src: str, d: str, strengths=STRENGTHS, device=None, tag=""):
    """[(strength, SNR dB, NMR dB)] of the port's adds of `src`; the marked
    files stay in `d`."""
    orig = WavData.load(src)
    rows = []
    for s in strengths:
        dst = os.path.join(d, "%s%s_s%d.wav" % (
            os.path.splitext(os.path.basename(src))[0], tag, s))
        snr = add_with_snr(src, dst, s, device)
        rows.append((s, snr, nmr_db(orig.samples, WavData.load(dst).samples,
                                    orig.n_channels)))
    return rows


def reference(path: str = REFERENCE):
    """docs/QUALITY.md's numbers: ({strength: (noise SNR, noise NMR, music
    SNR, music NMR)}, {carrier: [mp3@320, @256, @128, @64, wm s10 NMR]})
    as the printed strings."""
    sweep_rows, anchor_rows = {}, {}
    if not os.path.exists(path):
        return sweep_rows, anchor_rows
    with open(path) as f:
        for line in f:
            cells = [c.strip() for c in line.strip().strip("|").split("|")]
            if len(cells) == 5 and cells[0].isdigit():
                sweep_rows[int(cells[0])] = tuple(cells[1:])
            elif len(cells) == 7 and cells[0] in CARRIERS:
                anchor_rows[cells[0]] = cells[1:6]
    return sweep_rows, anchor_rows


def report(rows, anchors, regions, missing, failures, seconds: int,
           where: str) -> str:
    """docs/QUALITY.md's tables with docs/QUALITY.md's numbers beside the
    port's, and the verdict."""
    ref_sweep, ref_anchors = reference()
    diffs = []                          # (what, port, QUALITY.md)

    def cell(value, ref, what):
        if ref is None:
            return "%.3f | —" % value
        diffs.append((what, "%.3f" % value, ref))
        return "%.3f | %s" % (value, ref)

    lines = [
        "# Watermark quality report — the PyTorch port",
        "",
        "Generated %s by `python3 -m audiowmark_tpu_torch.quality_report "
        "--seconds %d` %s (%d s fixtures, pattern `%s`): the strength sweep "
        "and mp3 ladder of docs/QUALITY.md (`tools/quality_report.py`) "
        "through the port's `add --strength S --snr`, each number beside "
        "docs/QUALITY.md's." % (datetime.date.today().isoformat(), seconds,
                                where, seconds, PATTERN),
        "",
        "| strength | noise SNR dB | QUALITY.md | noise NMR dB | QUALITY.md "
        "| music SNR dB | QUALITY.md | music NMR dB | QUALITY.md |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for i, s in enumerate(STRENGTHS):
        ref = ref_sweep.get(s, (None,) * 4)
        vals = (rows["noise"][i][1], rows["noise"][i][2],
                rows["music"][i][1], rows["music"][i][2])
        names = ("noise SNR", "noise NMR", "music SNR", "music NMR")
        lines.append("| %d | %s |" % (s, " | ".join(
            cell(v, r, "%s s%d" % (n, s))
            for v, r, n in zip(vals, ref, names))))
    lines += ["", "## NMR calibration against the MP3 bitrate ladder", ""]
    if missing:
        lines.append("Not run: %s does not load here, so the mp3 anchors, "
                     "the ODG-region estimate and the checks that need them "
                     "were not run." % missing)
    else:
        lines += [
            "| carrier | " + " | ".join("mp3@%d NMR dB | QUALITY.md" % b
                                        for b in ANCHOR_BITRATES)
            + " | wm s10 NMR dB | QUALITY.md | wm s10 ODG-region |",
            "|---|" + "---|---|" * (len(ANCHOR_BITRATES) + 1) + "---|",
        ]
        for carrier in CARRIERS:
            ref = ref_anchors.get(carrier, [None] * 5)
            nmr10 = [v for s, _, v in rows[carrier] if s == 10][0]
            vals = [anchors[carrier][b] for b in ANCHOR_BITRATES] + [nmr10]
            names = ["mp3@%d" % b for b in ANCHOR_BITRATES] + ["wm s10"]
            lines.append("| %s | %s | %s |" % (carrier, " | ".join(
                cell(v, r, "%s %s NMR" % (carrier, n))
                for v, r, n in zip(vals, ref, names)), regions[carrier]))
    differ = [(w, p, r) for w, p, r in diffs if p != r]
    worst = max((abs(float(p) - float(r)) for _, p, r in differ),
                default=0.0)
    lines += [
        "",
        "Checks (the tool's): SNR monotone decreasing in strength; strength"
        " 10 keeps SNR >= 20 dB and NMR <= 0 dB on both carriers; the mp3"
        " anchor ladder NMR-monotone on both carriers; the strength-10 NMR"
        " at/under the mp3@256 anchor on noise and >= 10 dB under the mp3@64"
        " anchor on the tonal carrier.",
        "Result: **%s**" % ("PASS" if not failures else
                            "FAIL: " + "; ".join(failures)),
        "",
        "Against docs/QUALITY.md at its 3 printed decimals: %d of %d numbers"
        " equal%s." % (len(diffs) - len(differ), len(diffs), "" if not differ
                       else "; differ (port vs QUALITY.md): " + ", ".join(
                           "%s %s vs %s" % d for d in differ)
                       + "; largest difference %.3f dB" % worst),
        "",
    ]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=int, default=30)
    ap.add_argument("--out", help="write the report here")
    args = ap.parse_args(argv)

    missing = anchors_missing()
    rows, anchors, regions, failures = {}, {}, {}, []
    with tempfile.TemporaryDirectory() as d:
        for carrier in CARRIERS:
            src = os.path.join(d, carrier + ".wav")
            GENERATORS[carrier](src, args.seconds)
            rows[carrier] = sweep(src, d)
            for s, snr, nmr in rows[carrier]:
                print("%-6s strength=%-3d snr=%7.3f dB  nmr=%7.3f dB"
                      % (carrier, s, snr, nmr), flush=True)
            if not missing:
                orig = WavData.load(src)
                anchors[carrier] = {br: mp3_anchor_nmr(orig, br)
                                    for br in ANCHOR_BITRATES}
                for br in ANCHOR_BITRATES:
                    print("%-6s mp3@%-3d anchor nmr=%7.3f dB"
                          % (carrier, br, anchors[carrier][br]), flush=True)
                nmr10 = [v for s, _, v in rows[carrier] if s == 10][0]
                regions[carrier] = odg_region(nmr10, anchors[carrier])
            failures += checks(carrier, rows[carrier],
                               anchors.get(carrier))
    if missing:
        print("mp3 anchors not run: %s does not load here" % missing)
    where = ("on the CPU" if os.environ.get("AUDIOWMARK_TORCH_DEVICE")
             == "cpu" else "on the CUDA card")
    text = report(rows, anchors, regions, missing, failures, args.seconds,
                  where)
    print(text, end="")
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    if failures:
        print("FAILURES:", *failures, sep="\n  ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

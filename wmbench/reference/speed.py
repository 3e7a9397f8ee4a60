"""The plain reference of replay-speed detection: the speed that `get
--detect-speed` must find, and the patterns it must report there.

Upstream audiowmark's detect_speed (src/wmspeed.cc:622-781) and the decode
at the detected speed (src/wmget.cc:886-939), written from the upstream
semantics in plain torch, float64 in the `f64` precision:

* clip choice (src/wmspeed.cc:532-573): the keyed PRNG's `speed_clip`
  stream, seeded 0, steps through the interleaved float32 samples by draws
  mod 1000; SHA-1 over those samples (first 8 bytes, big-endian) seeds the
  stream again, and its next draws / 2^64 are the candidate locations; of
  the clips of scan 1's seconds at those locations the one of most energy
  (sum of squares, the first on a tie) is kept;
* a scan (src/wmspeed.cc:204-382, 458-480): the clip of 1.3 times the
  scan's seconds at that location; centre speeds speed * step^(c (2
  n_steps + 1)) for c in [-n_center_steps, n_center_steps] around each
  given speed; per centre the clip's first round(44100 seconds / centre)
  frames resampled by centre / 2 (zita's protocol, reference/mark.py),
  512-point frames at hops of 128 under a Hann window of sum 2, per sync
  entry the dB of its up bands and of its down bands summed over the
  bands and both channels (the mag matrix); per relative speed rel =
  step^p, p in [-n_steps, n_steps], the 16.16 offsets state_off =
  trunc(o (2^16 / rel)) for o in [-pad_start, 0) and frame_off = trunc(((b
  fpb + frame) 4 (1 / rel) + 0.5) 2^16) for blocks b = 0, 1, 2; an entry
  reads mag row (state_off + frame_off) >> 16 where that sum is >= 0 and
  the row lies inside the matrix, the middle block with up and down
  swapped; per state the sync bits' qualities (reference/scan.py's, as
  the sync search's) weighted by their entries read, normalised; the
  score of speed rel * centre is the largest magnitude over the states;
* selection (src/wmspeed.cc:391-421, 495-530): local maxima in speed order
  (a maximum skips its right neighbour), the n best by quality; scan 2
  around scan 1's n best, scan 3 around scan 2's best (and, beside
  upstream's own path, every other path that qualities tied to TIE could
  take: `Detected.branches`); scan 3's scores
  smoothed by a cosine window of (1 - step) x distance, the argmax on a
  grid of 1e-6 from the lowest speed to below the highest; accepted where
  scan 3's best quality exceeds the threshold and the speed lies outside
  the band around 1 (src/wmspeed.cc:772-778);
* decode (src/wmget.cc:886-939): the whole input resampled at ratio speed
  (resample_ratio, the rate's name changed, the samples' count
  round(n speed): `at_speed`), then every pattern of reference/scan.py on
  it (`patterns`; the benchmark holds the program's resampled input to
  `at_speed` and decodes the program's own, judge_speed.py).

The scans' constants come from the configuration's `get` section.

Departures from upstream, none of which changes a value by more than
rounding: upstream splits the centres into jobs over a thread pool; the
smoothing grid is start + k 1e-6 (upstream adds 1e-6 in a loop, which
drifts in the last bits); equal qualities keep their speed order
(upstream's sort is not stable); every (block, entry) pair is scanned,
also those that no state brings inside the matrix.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import aes, keyed, mark, scan
from .dsp import db_bands
from .keyed import Geom
from .prec import Prec

SPEED_CLIP = 3                  # the PRNG's stream of the clip choice
CLIP_MARGIN = 1.3               # a scan's clip is this times its seconds
SUB_FRAME, SUB_HOP = 512, 128   # the scans' frames at half the rate
OFFSET_SHIFT = 16
N_BLOCKS = 3                    # blocks one offset scan covers
# (rels x states x entries) elements of one compare pass
_WORKSPACE = 1 << 24
# speed-scan qualities this close are ties to float32 rounding (the
# program's lie ~1e-5 from float64's, PERF.md): the reference follows every
# choice such a tie could make, as reference/scan.py keeps the candidates
# that tie
TIE = 1e-3
# smoothed scan-3 qualities this close tie: twice a bound of 1e-5 on their
# float32 error (scan 3's qualities lie up to 3.4e-6 from float64's,
# PERF.md); on a flat curve (no mark at that speed) the argmax may then
# move by more than the 1e-6 grid
SMOOTH_TIE = 2e-5

Score = Tuple[float, float]     # (speed, quality)


@contextlib.contextmanager
def _no_tf32():
    """float32 products without TF32 (the controls compute in float32;
    Prec.matmul turns TF32 on inside it for the `tf32` control alone)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@dataclass(frozen=True)
class Scan:
    seconds: float
    step: float
    n_steps: int
    n_center_steps: int


@dataclass(frozen=True)
class SpeedGeom:
    """The speed search a configuration's `get` section states."""

    scans: Tuple[Scan, Scan, Scan]
    n_best: int
    clip_candidates: int
    smooth_distance: float
    accept_quality: float
    accept_band: Tuple[float, float]

    @classmethod
    def from_config(cls, cfg: Dict) -> "SpeedGeom":
        s = cfg["get"]
        return cls(scans=tuple(Scan(**s["scans"][k])
                               for k in ("scan1", "scan2", "scan3")),
                   n_best=s["n_best"],
                   clip_candidates=s["clip_candidates"],
                   smooth_distance=float(s["smooth_distance"]),
                   accept_quality=float(s["accept_quality"]),
                   accept_band=tuple(s["accept_band"]))


# ---- the clip ---------------------------------------------------------------

def draws(key: bytes, seed: int, n: int) -> np.ndarray:
    """The first n uint64 draws of the keyed PRNG's `speed_clip` stream
    seeded `seed` (src/random.cc:117-161)."""
    rk = aes.expand_key(key)
    return aes.ctr_keystreams_u64_batch(
        rk, keyed._ivs(rk, [seed], SPEED_CLIP), n)[0]


def _double(word) -> float:
    """libstdc++'s uniform double in [0, 1) of one 64-bit draw."""
    d = float(int(word)) / 2.0 ** 64
    return d if d < 1.0 else float(np.nextafter(1.0, 0.0))


def clip_locations(key: bytes, samples: np.ndarray, n: int) -> List[float]:
    """The n keyed, content-hashed candidate locations of the interleaved
    float32 `samples`."""
    size = samples.size
    k = size // 400 + 64
    while True:
        steps = (draws(key, 0, k) % np.uint64(1000)).astype(np.int64)
        pos = np.concatenate([[0], np.cumsum(steps)])
        if pos[-1] >= size:
            break
        k *= 2
    picked = np.asarray(samples, np.float32)[pos[pos < size]]
    seed = int.from_bytes(hashlib.sha1(picked.tobytes()).digest()[:8],
                          "big")
    return [_double(w) for w in draws(key, seed, n)]


def clip_bounds(location: float, n_frames: int, rate: int,
                seconds: float) -> Tuple[int, int]:
    end_sec = n_frames / rate
    start = int(max(location * (end_sec - seconds), 0.0) * rate)
    return start, min(start + int(seconds * rate), n_frames)


def best_clip_location(key: bytes, x: torch.Tensor, samples: np.ndarray,
                       rate: int, seconds: float, n: int) -> float:
    """The candidate whose clip of `seconds` holds the most energy."""
    best, best_energy = 0.0, 0.0
    for loc in clip_locations(key, samples, n):
        s, e = clip_bounds(loc, x.shape[0], rate, seconds)
        energy = float(torch.sum(x[s:e] ** 2))
        if energy > best_energy:
            best, best_energy = loc, energy
    return best


# ---- a scan -----------------------------------------------------------------

@dataclass
class SyncEntries:
    """The sync frames of a block as J entries: block frame, sync bit and
    0/1 band selections of the up and the down bands."""

    frame: np.ndarray           # (J,) int64
    bit: np.ndarray             # (J,) int64
    vu: torch.Tensor            # (J, n_bands)
    vd: torch.Tensor
    frames_per_block: int


def sync_entries(key: bytes, g: Geom, prec: Prec, device) -> SyncEntries:
    lay = keyed.layout(key, g)
    frames, up, dn = keyed.sync_bits(lay, False)
    J = frames.size
    vu = np.zeros((J, g.n_bands))
    vd = np.zeros((J, g.n_bands))
    rows = np.arange(J)[:, None]
    vu[rows, up.reshape(J, -1)] = 1.0
    vd[rows, dn.reshape(J, -1)] = 1.0
    return SyncEntries(
        frame=frames.reshape(-1),
        bit=np.repeat(np.arange(g.sync_bits), frames.shape[1]),
        vu=torch.from_numpy(vu).to(device=device, dtype=prec.dtype),
        vd=torch.from_numpy(vd).to(device=device, dtype=prec.dtype),
        frames_per_block=g.frames_per_block)


def mag_matrix(clip: torch.Tensor, center: float, seconds: float,
               sync: SyncEntries, g: Geom, prec: Prec
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The up and the down band sums of every sync entry at every half-
    rate hop: two (rows, J) matrices."""
    n_in = min(clip.shape[0],
               int(round(g.mark_sample_rate * seconds / center)))
    ratio = center / 2
    sub = mark.resample(clip[:n_in], ratio, int(round(n_in * ratio)), prec)
    n = sub.shape[0]
    rows = (n - SUB_FRAME - 1) // SUB_HOP + 1 if n > SUB_FRAME else 0
    J = sync.frame.size
    if rows <= 0:
        z = sub.new_zeros((0, J))
        return z, z
    windows = sub.T.unfold(1, SUB_FRAME, SUB_HOP)[:, :rows].transpose(0, 1)
    half = dataclasses.replace(g, frame_size=SUB_FRAME)
    S = prec.q(torch.sum(db_bands(windows, half, prec), dim=1))
    with prec.matmul():
        return (prec.q(torch.matmul(S, sync.vu.T)),
                prec.q(torch.matmul(S, sync.vd.T)))


def offsets(rels: Sequence[float], sync: SyncEntries, g: Geom
            ) -> Tuple[np.ndarray, np.ndarray]:
    """The 16.16 offsets: (R, states) of the states and (R, 3J) of the
    entries of the three blocks, int64, truncated as upstream's casts."""
    spf = g.frame_size // g.sync_search_step
    pad_start = sync.frames_per_block * spf + spf
    frames = sync.frame.astype(np.float64)
    one = float(1 << OFFSET_SHIFT)
    f_off = np.empty((len(rels), N_BLOCKS * frames.size), np.int64)
    for i, rel in enumerate(rels):
        inv = 1.0 / rel
        f_off[i] = np.concatenate([np.trunc(
            ((b * sync.frames_per_block + frames) * spf * inv + 0.5) * one)
            for b in range(N_BLOCKS)])
    o = np.arange(-pad_start, 0, dtype=np.float64)
    s_off = np.stack([np.trunc(o * (one / rel)) for rel in rels])
    return s_off.astype(np.int64), f_off


def rows_of(s_off: torch.Tensor, f_off: torch.Tensor, rows: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mag row and validity of every (state, entry): (..., S, E)."""
    raw = s_off[..., :, None] + f_off[..., None, :]
    row = raw >> OFFSET_SHIFT
    return row, (raw >= 0) & (row < rows)


def compare(up: torch.Tensor, dn: torch.Tensor, rels: Sequence[float],
            sync: SyncEntries, g: Geom, prec: Prec) -> np.ndarray:
    """The best |sync quality| over the states for each relative speed:
    (R,) float64."""
    rows, J = up.shape
    if rows == 0:
        return np.zeros(len(rels))
    dev = up.device
    s_off, f_off = offsets(rels, sync, g)
    s_off = torch.from_numpy(s_off).to(dev)
    f_off = torch.from_numpy(f_off).to(dev)
    col = torch.arange(J, device=dev).repeat(N_BLOCKS)
    swap = torch.arange(N_BLOCKS * J, device=dev) // J == 1
    onehot = torch.zeros((N_BLOCKS * J, g.sync_bits), dtype=prec.dtype,
                         device=dev)
    onehot[torch.arange(N_BLOCKS * J, device=dev),
           torch.from_numpy(np.tile(sync.bit, N_BLOCKS)).to(dev)] = 1.0
    per_pass = max(1, _WORKSPACE // (s_off.shape[1] * f_off.shape[1]))
    out = []
    for r0 in range(0, len(rels), per_pass):
        row, valid = rows_of(s_off[r0:r0 + per_pass],
                             f_off[r0:r0 + per_pass], rows)
        row = row.clamp_(0, rows - 1)
        a, b = up[row, col], dn[row, col]
        mask = valid.to(prec.dtype)
        u = torch.where(swap, b, a) * mask
        d = torch.where(swap, a, b) * mask
        with prec.matmul():
            ub = prec.q(torch.matmul(u, onehot))
            db = prec.q(torch.matmul(d, onehot))
            cnt = torch.matmul(mask, onehot)
        q = scan._bit_quality(ub, db, cnt, g)        # (r, states)
        out.append(torch.amax(torch.abs(prec.q(q)), dim=-1))
    return torch.cat(out).double().cpu().numpy()


def run_scan(x: torch.Tensor, location: float, sc: Scan,
             speeds: Sequence[float], sync: SyncEntries, g: Geom,
             prec: Prec) -> List[Score]:
    """The (speed, quality) scores of one scan around `speeds`."""
    s, e = clip_bounds(location, x.shape[0], g.mark_sample_rate,
                       sc.seconds * CLIP_MARGIN)
    clip = x[s:e]
    rels = [sc.step ** p for p in range(-sc.n_steps, sc.n_steps + 1)]
    centres = [speed * sc.step ** (c * (sc.n_steps * 2 + 1))
               for speed in speeds
               for c in range(-sc.n_center_steps, sc.n_center_steps + 1)]
    scores: List[Score] = []
    for c in centres:
        up, dn = mag_matrix(clip, c, sc.seconds, sync, g, prec)
        q = compare(up, dn, rels, sync, g, prec)
        scores += [(rel * c, float(qq)) for rel, qq in zip(rels, q)]
    return scores


# ---- selection --------------------------------------------------------------

def select_n_best(scores: Sequence[Score], n: int) -> List[Score]:
    """Local maxima in speed order (a maximum skips its right neighbour),
    the n of highest quality."""
    s = sorted(scores, key=lambda sc: sc[0])

    def q(i):
        return s[i][1] if 0 <= i < len(s) else 0.0

    lmax = []
    i = 0
    while i < len(s):
        if q(i - 1) <= q(i) >= q(i + 1):
            lmax.append(s[i])
            i += 1
        i += 1
    return sorted(lmax, key=lambda sc: -sc[1])[:n]


def _smoothed(scores: Sequence[Score], step: float, distance: float
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The 1e-6 grid and the cosine-smoothed qualities on it."""
    s = sorted(scores, key=lambda sc: sc[0])
    speeds = np.array([v[0] for v in s])
    quals = np.array([v[1] for v in s])
    grid = np.arange(speeds[0], speeds[-1], 0.000001)
    if grid.size == 0:
        return speeds[:1], quals[:1]
    x = (speeds[None, :] - grid[:, None]) / (step * distance)
    w = np.where(np.abs(x) > 1, 0.0, 0.5 * np.cos(x * np.pi) + 0.5)
    return grid, (quals[None, :] * w).sum(axis=1) / w.sum(axis=1)


def smooth_find_best(scores: Sequence[Score], step: float,
                     distance: float) -> float:
    """The argmax of the cosine-smoothed qualities on a 1e-6 grid."""
    grid, q = _smoothed(scores, step, distance)
    return float(grid[np.argmax(q)])


def smooth_span(scores: Sequence[Score], step: float, distance: float,
                tie: float) -> Tuple[float, float]:
    """The lowest and the highest grid speed whose smoothed quality lies
    within `tie` of the best: where an argmax of qualities rounded by
    tie / 2 can fall."""
    grid, q = _smoothed(scores, step, distance)
    near = grid[q >= q.max() - tie]
    return float(near[0]), float(near[-1])


# ---- detection and the decode at the speed --------------------------------

@dataclass
class Branch:
    speed: float                # scan 3's smoothed argmax
    quality: float              # scan 3's best quality
    span: Tuple[float, float]   # where a tie could move the argmax


@dataclass
class Detected:
    speed: Optional[float]      # upstream's own choice where accepted
    quality: float
    location: float
    branches: List[Branch]      # upstream's own path first, then those a
    #                             tie to rounding could take


def _input(samples: np.ndarray, prec: Prec, device) -> torch.Tensor:
    return prec.q(torch.from_numpy(np.ascontiguousarray(samples)).to(
        device=device, dtype=prec.dtype) / 32768.0)


def _scan2_centres(scores: Sequence[Score], n: int, tie: float
                   ) -> Tuple[List[Score], List[Score], List[Score]]:
    """Upstream's n best of scan 1 (`own`); every local maximum that a tie
    could put among them (`plausible`, own included); and those of own
    that no tie can displace (`sure`)."""
    own = select_n_best(scores, n)
    if tie <= 0 or not own:
        return own, own, own
    s = sorted(scores, key=lambda v: v[0])

    def q(i):
        return s[i][1] if 0 <= i < len(s) else 0.0

    q_n = own[-1][1] if len(own) >= n else -np.inf
    plausible = dict(own)
    for i, (speed, qq) in enumerate(s):
        if qq + tie >= q(i - 1) and qq + tie >= q(i + 1) \
                and qq >= q_n - tie:
            plausible[speed] = qq
    where = {v[0]: i for i, v in enumerate(s)}
    sure = [v for v in own if v[1] > q_n + tie
            and v[1] > q(where[v[0]] - 1) + tie
            and v[1] > q(where[v[0]] + 1) + tie]
    return own, sorted(plausible.items()), sure


@_no_tf32()
def detect_speed(samples: np.ndarray, key: bytes, g: Geom, sg: SpeedGeom,
                 prec: Prec, device, tie: float = TIE) -> Detected:
    """The speed detect_speed accepts on int16 (n, C) samples at 44.1 kHz
    (None where it accepts none), and the other branches: scan 2 runs
    around every scan-1 maximum that a tie of `tie` could put among the n
    best, scan 3 around every scan-2 score that such a choice could make
    the best."""
    rate = g.mark_sample_rate
    if samples.shape[0] / rate < 0.25:
        return Detected(None, 0.0, 0.0, [])
    x = _input(samples, prec, device)
    flat = (samples.astype(np.float32) / np.float32(32768.0)).reshape(-1)
    scan1, scan2, scan3 = sg.scans
    loc = best_clip_location(key, x, flat, rate, scan1.seconds,
                             sg.clip_candidates)
    sync = sync_entries(key, g, prec, device)
    scores = run_scan(x, loc, scan1, [1.0], sync, g, prec)
    own, plausible, sure = _scan2_centres(scores, sg.n_best, tie)
    groups = {v[0]: run_scan(x, loc, scan2, [v[0]], sync, g, prec)
              for v in plausible}
    best = select_n_best([w for v in own for w in groups[v[0]]], 1)
    centres = [best[0][0] if best else 1.0]
    if tie > 0:
        floor = max((w[1] for v in sure for w in groups[v[0]]),
                    default=-np.inf) - tie
        centres += sorted({w[0] for ws in groups.values() for w in ws
                           if w[1] >= floor} - set(centres))
    branches = []
    for c in centres:
        sc = run_scan(x, loc, scan3, [c], sync, g, prec)
        branches.append(Branch(
            smooth_find_best(sc, 1 - scan3.step, sg.smooth_distance),
            max((v[1] for v in sc), default=0.0),
            smooth_span(sc, 1 - scan3.step, sg.smooth_distance,
                        SMOOTH_TIE if tie > 0 else 0.0)))
    own_b = branches[0]
    ok = accepts(own_b, sg)
    return Detected(own_b.speed if ok else None, own_b.quality, loc,
                    branches)


def accepts(b: Branch, sg: SpeedGeom, tie: float = 0.0) -> bool:
    """Whether upstream accepts branch b; with `tie`, whether a rounding
    of the quality by `tie` could make it accept."""
    lo, hi = sg.accept_band
    return b.quality > sg.accept_quality - tie and (b.speed < lo
                                                    or b.speed > hi)


def rejects(b: Branch, sg: SpeedGeom, tie: float = 0.0) -> bool:
    lo, hi = sg.accept_band
    return b.quality <= sg.accept_quality + tie or lo <= b.speed <= hi


@_no_tf32()
def at_speed(samples: np.ndarray, speed: float, prec: Prec,
             device) -> np.ndarray:
    """The input resampled at ratio `speed` (upstream's resample_ratio),
    as float64 (n', C) on the int16 scale, for reference/scan.py."""
    y = mark.resample(_input(samples, prec, device), speed,
                      int(round(samples.shape[0] * speed)), prec)
    return (y.double() * 32768.0).cpu().numpy()


@_no_tf32()
def change_speed(samples: np.ndarray, speed: float, prec: Prec,
                 device) -> np.ndarray:
    """upstream's test-change-speed: int16 (n, C) replayed at `speed`, the
    rate kept (resample_ratio at 1 / speed), written as 16 bits."""
    y = mark.resample(_input(samples, prec, device), 1 / speed,
                      int(round(samples.shape[0] / speed)), prec)
    return mark.to_int16(y)


def _local_mean(q: np.ndarray, distance: int = 20,
                exclude: int = 4) -> np.ndarray:
    """reference/scan.py's local_mean, skipping the offsets that reach no
    neighbour: scan.py's slices past a sweep of 3-19 starts (a block
    search of 2228-2231 frames, ~51.8 s, which a ~64 s file decoded at a
    speed of ~0.81 gives) and raises.  Elsewhere the two are equal."""
    n = q.size
    tot = np.zeros(n)
    cnt = np.zeros(n)
    for j in list(range(-distance, -exclude + 1)) \
            + list(range(exclude, distance + 1)):
        lo, hi = max(0, -j), min(n, n - j)
        if lo < hi:
            tot[lo:hi] += q[lo + j:hi + j]
            cnt[lo:hi] += 1
    return np.where(cnt > 0, tot / np.maximum(cnt, 1), 0.0)


def _refine(x: torch.Tensor, t: int, q: np.ndarray, mean: np.ndarray,
            sync, g: Geom, prec: Prec, sil, extra: int
            ) -> List[Tuple[int, float, float]]:
    """reference/scan.py's refinement of start hop t: its best position
    first, then (`extra` > 0) the positions that tie it to scan.TIE; each
    (index, raw quality, mean)."""
    step, fine = g.sync_search_step, g.sync_search_fine
    base = int(t) * step
    pos = np.arange(max(base - step, 0), base + step + 1, fine)
    pos = pos[pos + sync.total * g.frame_size <= x.shape[0]]
    best_q, best_i = q[t], base
    qs = np.zeros(0)
    if pos.size:
        qs = scan._quality_at(x, torch.from_numpy(pos).to(x.device), sync,
                              g, prec, sil).double().cpu().numpy()
        for p, qq in zip(pos, qs):
            if abs(qq - mean[t]) > abs(best_q - mean[t]):
                best_q, best_i = float(qq), int(p)
    near = [(int(p), float(qq), mean[t]) for p, qq in zip(pos, qs)
            if p != best_i and abs(abs(qq - mean[t])
                                   - abs(best_q - mean[t])) <= scan.TIE]
    return [(best_i, best_q, mean[t])] + (near if extra else [])


def _maybe_maxima(aq: np.ndarray) -> np.ndarray:
    """The start hops that are no local maximum of reference/scan.py's
    scan but would be one were each quality moved by scan.TIE / 2: at
    least the larger neighbour less scan.TIE (the scan's skip of a
    maximum's right neighbour leaves the hop after it to be held to that
    neighbour alone, so a shoulder two hops right of a peak can become a
    maximum too)."""
    prev = np.concatenate(([0.0], aq[:-1]))
    nxt = np.concatenate((aq[1:], [0.0]))
    could = aq >= np.maximum(prev, nxt) - scan.TIE
    return np.nonzero(could & ~scan.local_maxima(aq))[0]


def _search(x: torch.Tensor, lay, clip: bool, prec: Prec, extra: int,
            sil=None, final: bool = True) -> List[Tuple[int, float, str]]:
    """reference/scan.py's search, whose superset (`extra` > 0) also
    follows the local maxima that rounding could make: a float32 sweep
    may take as a maximum a hop within scan.TIE of a neighbour
    (`_maybe_maxima`), and its +-256 refinement then reaches positions no
    float64 maximum's does (noise-level candidates at a wrong speed: a
    float32 peak one hop right of float64's, 4.1e-5 apart, refined 5.3e-3
    higher; a shoulder 1.8e-5 above float32's neighbour taken beside the
    peak).  scan.py's candidates and cuts are kept as they are; a maybe
    maximum joins them where its quality reaches the last one kept less
    scan.TIE, at the sweep's cut and at the refined cut, and so crowds
    none of them out."""
    g = lay.geom
    sync = scan._Sync(lay, clip, prec, x.device)
    q = scan.sweep(x, sync, g, prec, sil).double().cpu().numpy()
    if q.size == 0:
        return []
    mean = scan.local_mean(q)
    aq = np.abs(q - mean)
    sel = np.nonzero(scan.local_maxima(aq))[0]
    sel = sel[scan.mask_false_positives(sel * g.sync_search_step, q[sel],
                                        mean[sel], g)]
    sel = sel[scan.best_order(aq[sel], g.sync_threshold2 * 0.75,
                              g.get_n_best, extra)]
    if clip:
        sel = sel[:max(g.get_n_best, 5) + extra]
    maybe = np.zeros(0, int)
    if extra and sel.size:
        maybe = _maybe_maxima(aq)
        maybe = maybe[aq[maybe] >= aq[sel].min() - scan.TIE]

    def refine_all(hops):
        found = [_refine(x, t, q, mean, sync, g, prec, sil, extra)
                 for t in hops]
        found.sort(key=lambda f: f[0][0])
        return [f[0] for f in found], [f[1:] for f in found]

    refined, near = refine_all(sel)
    aq2 = np.array([abs(r[1] - r[2]) for r in refined])
    keep = sorted(scan.best_order(aq2, g.sync_threshold2, g.get_n_best,
                                  extra)
                  if final else range(len(refined)))
    out = []
    for i in keep:
        for idx, rq, m in [refined[i]] + near[i]:
            out.append((idx, abs(rq - m), "a" if rq - m > 0 else "b"))
    if maybe.size and keep:
        level = min(aq2[i] for i in keep) - scan.TIE
        for r, ties in zip(*refine_all(maybe)):
            if abs(r[1] - r[2]) >= level or not final:
                out += [(idx, abs(rq - m), "a" if rq - m > 0 else "b")
                        for idx, rq, m in [r] + ties]
    return sorted(out)


@_no_tf32()
def patterns(y: np.ndarray, key: bytes, g: Geom, prec: Prec, device,
             extra: int = 8) -> List[scan.RefPattern]:
    """reference/scan.py's patterns of (n, C) samples on the int16 scale,
    its local mean given every length and its search following the ties
    of local maxima (`_search`; scan.py changes only in a `benchmark` PR:
    PERF.md, Open questions)."""
    mean0, search0 = scan.local_mean, scan.search
    scan.local_mean, scan.search = _local_mean, _search
    try:
        return scan.reference_patterns(y, key, g, prec, device, extra)
    finally:
        scan.local_mean, scan.search = mean0, search0


@dataclass
class Reference:
    """What get --detect-speed must give on one file: the detection and
    the patterns at speed 1."""

    detected: Detected
    patterns: List[scan.RefPattern]


def reference(samples: np.ndarray, key: bytes, g: Geom, sg: SpeedGeom,
              prec: Prec, device, extra: int = 8,
              tie: float = TIE) -> Reference:
    """`extra` and `tie` 0 give upstream's own selections alone."""
    return Reference(detect_speed(samples, key, g, sg, prec, device, tie),
                     patterns(samples, key, g, prec, device, extra))

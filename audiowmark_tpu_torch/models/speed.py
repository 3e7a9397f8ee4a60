"""Replay-speed detection: 3-pass grid search over candidate speeds.

Port of audiowmark_tpu/models/speed.py.  Reference behaviour
(src/wmspeed.cc:622-781):
  scan1 (coarse, ~0.8..1.25): 57 centre speeds x 11 relative steps on a keyed
  content-selected clip; scan2 refines the 5 (patient: 15) best local maxima;
  scan3 runs a fine +-40 x 1.00005 grid around the single best; a cosine-
  smoothed argmax (1e-6 step) picks the final speed; accepted when the sync
  quality exceeds 0.4 and the speed differs from 1.0 by more than 1e-4.

The clip choice (a PRNG seeded by a hash of the samples, an energy sum in
float64) and the score lists stay on the host; each scan is one
ops/speed.speed_scan on the device, which keeps every centre's mag matrix
there and returns the (centres x rels) quality grid.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..crypto.keys import Key
from ..crypto.prng import Random, Stream, seed_from_hash
from ..device import DeviceLike
from ..io.wavdata import WavData
from ..ops import speed as speed_ops
from ..params import Params
from ..tables import get_key_tables


@dataclass
class ScanParams:
    seconds: float
    step: float
    n_steps: int
    n_center_steps: int = 0


@dataclass
class Score:
    speed: float
    quality: float


def _get_speed_clip(location: float, in_data: WavData,
                    clip_seconds: float) -> WavData:
    end_sec = in_data.n_frames / in_data.sample_rate
    start_sec = max(location * (end_sec - clip_seconds), 0.0)
    start_point = int(start_sec * in_data.sample_rate)
    end_point = min(start_point + int(clip_seconds * in_data.sample_rate),
                    in_data.n_frames)
    return in_data.with_samples(
        in_data.samples[start_point * in_data.n_channels:
                        end_point * in_data.n_channels])


def _get_clip_locations(key: Key, in_data: WavData, n: int) -> List[float]:
    """Keyed, content-hash-seeded clip candidates (src/wmspeed.cc:532-550)."""
    rng = Random(key, 0, Stream.speed_clip)
    samples = in_data.samples
    xsamples = []
    p = 0
    while p < samples.size:
        xsamples.append(samples[p])
        p += rng() % 1000
    rng.seed(seed_from_hash(np.array(xsamples, dtype=np.float32)),
             Stream.speed_clip)
    return [rng.random_double() for _ in range(n)]


def _get_best_clip_location(key: Key, in_data: WavData, seconds: float,
                            candidates: int) -> float:
    clip_location = 0.0
    best_energy = 0.0
    for location in _get_clip_locations(key, in_data, candidates):
        wd = _get_speed_clip(location, in_data, seconds)
        energy = float(np.sum(wd.samples.astype(np.float64) ** 2))
        if energy > best_energy:
            best_energy = energy
            clip_location = location
    return clip_location


def _select_n_best_scores(scores: List[Score], n: int) -> List[Score]:
    """Local maxima (incl. double peaks) by speed order, top-n by quality
    (src/wmspeed.cc:495-530)."""
    scores = sorted(scores, key=lambda s: s.speed)

    def q(pos):
        return scores[pos].quality if 0 <= pos < len(scores) else 0.0

    lmax = []
    x = 0
    while x < len(scores):
        if q(x - 1) <= q(x) and q(x) >= q(x + 1):
            lmax.append(scores[x])
            x += 1  # next value cannot be a local maximum
        x += 1
    lmax.sort(key=lambda s: -s.quality)
    return lmax[:n]


def _window_cos(x: np.ndarray) -> np.ndarray:
    return np.where(np.abs(x) > 1, 0.0, 0.5 * np.cos(x * np.pi) + 0.5)


def _score_smooth_find_best(scores: List[Score], step: float,
                            distance: float) -> float:
    """Cosine-window smoothing over the speed axis, 1e-6-step argmax
    (src/wmspeed.cc:391-421)."""
    scores = sorted(scores, key=lambda s: s.speed)
    speeds = np.array([s.speed for s in scores])
    quals = np.array([s.quality for s in scores])
    grid = np.arange(speeds[0], speeds[-1], 0.000001)
    if grid.size == 0:
        return float(speeds[0])
    w = _window_cos((speeds[None, :] - grid[:, None]) / (step * distance))
    qsum = (quals[None, :] * w).sum(axis=1) / w.sum(axis=1)
    return float(grid[np.argmax(qsum)])


class _KeySearch:
    def __init__(self, key: Key, in_data: WavData, clip_location: float,
                 device: DeviceLike = None):
        self.key = key
        self.in_data = in_data
        self.clip_location = clip_location
        self.device = device
        self.sync_bits = speed_ops.build_speed_sync_bits(get_key_tables(key))
        self.scores: List[Score] = []

    def run_scan(self, scan: ScanParams, speeds: List[float]):
        clip = _get_speed_clip(self.clip_location, self.in_data,
                               scan.seconds * 1.3)
        # the reference runs each SpeedSync's jobs with speed == its own
        # center (src/wmspeed.cc:477-478), so the relative grid is step^p
        # around every center
        centers = [speed * scan.step ** (c * (scan.n_steps * 2 + 1))
                   for speed in speeds
                   for c in range(-scan.n_center_steps,
                                  scan.n_center_steps + 1)]
        rels = [scan.step ** p
                for p in range(-scan.n_steps, scan.n_steps + 1)]
        per_center = speed_ops.speed_scan(
            clip.samples, clip.n_channels, centers, scan.seconds, rels,
            self.sync_bits, self.device)
        self.scores = [Score(sp, q) for row in per_center for q, sp in row]


def detect_speed(key_list: List[Key], in_data: WavData,
                 print_results: bool, device: DeviceLike = None
                 ) -> List[Tuple[Key, float]]:
    """The replay speed of `in_data` per key, where one is found: the scans
    run on `device` (default: the CUDA card)."""
    results: List[Tuple[Key, float]] = []

    in_seconds = in_data.n_frames / in_data.sample_rate
    if in_seconds < 0.25:
        return results

    scan1 = (ScanParams(50, 1.00035, 11, 28) if Params.detect_speed_patient
             else ScanParams(25, 1.0007, 5, 28))
    scan2 = (ScanParams(50, 1.000175, 1) if Params.detect_speed_patient
             else ScanParams(50, 1.00035, 1))
    scan3 = ScanParams(50, 1.00005, 40)
    scan3_smooth_distance = 20.0
    speed_sync_threshold = 0.4
    n_best = 15 if Params.detect_speed_patient else 5
    clip_candidates = 5

    searches = []
    for key in key_list:
        clip_location = _get_best_clip_location(key, in_data, scan1.seconds,
                                                clip_candidates)
        searches.append(_KeySearch(key, in_data, clip_location, device))

    for ks in searches:
        ks.run_scan(scan1, [1.0])

    for ks in searches:
        best = _select_n_best_scores(ks.scores, n_best)
        ks.run_scan(scan2, [s.speed for s in best])

    for ks in searches:
        best = _select_n_best_scores(ks.scores, 1)
        ks.run_scan(scan3, [best[0].speed] if best else [1.0])

    for ks in searches:
        best_speed = _score_smooth_find_best(ks.scores, 1 - scan3.step,
                                             scan3_smooth_distance)
        best_quality = max((s.quality for s in ks.scores), default=0.0)

        if print_results:
            delta = -1.0
            if Params.test_speed > 0:
                delta = 100 * abs(best_speed - Params.test_speed) \
                    / Params.test_speed
            print("detect_speed %f %f %.4f" % (best_speed, best_quality,
                                               delta))

        if best_quality > speed_sync_threshold:
            if best_speed < 0.9999 or best_speed > 1.0001:
                results.append((ks.key, best_speed))
    return results

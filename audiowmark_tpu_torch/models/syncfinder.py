"""Sync finder: candidate selection over the device search.

Port of audiowmark_tpu/models/syncfinder.py's main path (reference:
src/syncfinder.cc): the search of ops/search_fused.py on the device, then
the exact CLI selection on its fetched (K,) outputs — approx
threshold/n-best, refined candidates, final classification (quality =
|raw - mean|, block type A for a positive sign).

What the port does not do yet raises NotImplementedError naming its
ROADMAP item: --test-no-sync, streams longer than MAX_FUSED_FRAMES (the
tiled search), and candidate slots that stay saturated after the x4
escalation (the staged search).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional, Tuple

import numpy as np
import torch

from audiowmark_tpu.crypto.keys import Key
from audiowmark_tpu.params import Params

from ..codec.convcode import ConvBlockType
from ..device import DeviceLike, resolve
from ..ops import search_fused
from ..ops.sync import SHIFTS
from ..tables import get_key_tables


class SyncMode(Enum):
    BLOCK = 0
    CLIP = 1


@dataclass
class Score:
    index: int
    quality: float
    block_type: ConvBlockType
    # raw soft bits the search extracted at this score's refined position;
    # CLIP-mode scores also carry raw2, the consecutive second block's bits
    raw: Optional[np.ndarray] = None
    raw2: Optional[np.ndarray] = None


@dataclass
class KeyResult:
    key: Key
    sync_scores: List[Score] = field(default_factory=list)


@dataclass
class _SearchScore:
    index: int
    raw_quality: float
    local_mean: float
    raw: Optional[np.ndarray] = None
    raw2: Optional[np.ndarray] = None

    def abs_quality(self) -> float:
        return abs(self.raw_quality - self.local_mean)


def _scan_silence(samples: np.ndarray) -> Tuple[int, int]:
    """First/last non-zero raw sample-value indices
    (src/syncfinder.cc:155-169); returns (first, last) with last exclusive."""
    nz = np.nonzero(samples)[0]
    if nz.size == 0:
        return 0, 0
    return int(nz[0]), int(nz[-1]) + 1


def _threshold_n_best_order(abs_q: np.ndarray,
                            threshold: float) -> np.ndarray:
    """Positions ordered by descending quality, truncated to all-above-
    threshold or at least get_n_best (src/syncfinder.cc:364-383).  Stable
    sort keeps the reference's tie order (original index order)."""
    order = np.argsort(-abs_q, kind="stable")
    n_above = int(np.count_nonzero(abs_q > threshold))
    keep = n_above if n_above >= Params.get_n_best \
        else min(Params.get_n_best, abs_q.size)
    return order[:keep]


def _select_threshold_and_n_best(scores: List[_SearchScore],
                                 threshold: float) -> List[_SearchScore]:
    aq = np.array([s.abs_quality() for s in scores], dtype=np.float64)
    return [scores[i] for i in _threshold_n_best_order(aq, threshold)]


def search(key_list: List[Key], wav_data, mode: SyncMode,
           device: DeviceLike = None) -> List[KeyResult]:
    """Candidate block starts per key, from the device search."""
    if Params.test_no_sync:
        raise NotImplementedError(
            "audiowmark_tpu_torch: --test-no-sync is not ported yet "
            "(ROADMAP Queue 1: staged sync search)")
    dev = resolve(device)
    return [_search_fused_one(key, wav_data, mode, dev) for key in key_list]


_K_CAP = 1024


def _fused_k_for(T: int, frames_per_block: int, n_starts_s: int,
                 k_min: int = 0) -> Tuple[int, bool]:
    """Candidate slot count (>= k_min for saturation-escalation retries)
    and whether it covers EVERY start — complete coverage makes slot
    saturation impossible."""
    K = min(n_starts_s,
            max(search_fused.top_k_for(T, frames_per_block),
                -(-max(Params.get_n_best, 1) // 8) * 8, k_min))
    return K, K >= n_starts_s


def _finalize_scores(key: Key, refined: List[_SearchScore]) -> KeyResult:
    """Refined candidates -> threshold/n-best -> index-ordered Scores
    (the tail of src/syncfinder.cc:393-458)."""
    refined.sort(key=lambda s: s.index)
    refined = _select_threshold_and_n_best(refined, Params.sync_threshold2)
    refined.sort(key=lambda s: s.index)

    result = KeyResult(key=key)
    for s in refined:
        qd = s.raw_quality - s.local_mean
        result.sync_scores.append(Score(
            index=s.index, quality=abs(qd),
            block_type=ConvBlockType.a if qd > 0 else ConvBlockType.b,
            raw=s.raw, raw2=s.raw2))
    return result


def _select_from_fused(key: Key, out_np: dict, K: int, clip: bool,
                       complete: bool = False) -> Optional[KeyResult]:
    """Exact CLI selection from the search's fetched (K,) outputs;
    None -> slot saturation (candidates may be missing)."""
    n_el = int(np.count_nonzero(out_np["eligible"]))
    q = np.asarray(out_np["q"], dtype=np.float64)[:n_el]
    mean = np.asarray(out_np["mean"], dtype=np.float64)[:n_el]
    rpos = np.asarray(out_np["refined_pos"])[:n_el]
    rq = np.asarray(out_np["refined_q"], dtype=np.float64)[:n_el]

    # approx threshold/n-best truncation (the top-K slots are quality-
    # descending with index tie order, exactly the host ordering)
    aq = np.abs(q - mean)
    n_above = int(np.count_nonzero(aq > Params.sync_threshold2 * 0.75))
    if n_el == K and n_above == K and not complete:
        return None
    keep = n_above if n_above >= Params.get_n_best \
        else min(Params.get_n_best, n_el)
    if clip:
        keep = min(keep, max(Params.get_n_best, 5))

    raws = out_np["raws"]
    refined = []
    for i in range(keep):
        s = _SearchScore(index=int(rpos[i]), raw_quality=float(rq[i]),
                         local_mean=float(mean[i]))
        if clip:
            s.raw = np.asarray(raws[i][0], dtype=np.float32)
            s.raw2 = np.asarray(raws[i][1], dtype=np.float32)
        else:
            s.raw = np.asarray(raws[i], dtype=np.float32)
        refined.append(s)
    return _finalize_scores(key, refined)


def _search_fused_one(key: Key, wav_data, mode: SyncMode,
                      device: torch.device) -> KeyResult:
    samples = wav_data.samples
    n_channels = wav_data.n_channels
    true_frames = samples.size // n_channels
    F = true_frames // Params.frame_size
    tables = get_key_tables(key)
    clip = mode == SyncMode.CLIP
    total = tables.frames_per_block * (2 if clip else 1)
    n_starts_true = SHIFTS * (F - 1 - total)
    if n_starts_true <= 0:
        return KeyResult(key=key)

    T = search_fused.bucket_frames(F)
    if T > search_fused.MAX_FUSED_FRAMES:
        raise NotImplementedError(
            "audiowmark_tpu_torch: a %d-frame stream needs the tiled sync "
            "search (more than %d frames), which is not ported yet "
            "(ROADMAP Queue 1: long files)"
            % (F, search_fused.MAX_FUSED_FRAMES))
    n_starts_s = SHIFTS * (T - 1 - total)

    if clip:
        sil_first, sil_last = _scan_silence(samples)
    else:
        sil_first, sil_last = 0, samples.size

    x = np.zeros(T * Params.frame_size * n_channels, np.float32)
    x[:samples.size] = samples
    x = torch.from_numpy(x).to(device)
    searcher = search_fused.sync_searcher(tables, clip, device)

    # saturation escalation: retry with 4x the slots (reduced sync
    # geometries overflow the default top-K with above-threshold candidates)
    k_min = 0
    while True:
        K, complete = _fused_k_for(T, tables.frames_per_block, n_starts_s,
                                   k_min)
        out = searcher(x, n_channels, K, n_starts_true, true_frames,
                       sil_first, sil_last)
        out_np = {k: v.cpu().numpy() for k, v in out.items()}
        r = _select_from_fused(key, out_np, K, clip, complete)
        if r is not None:
            return r
        if complete or K >= _K_CAP:
            raise NotImplementedError(
                "audiowmark_tpu_torch: sync candidate slots saturated at "
                "K=%d; the staged sync search is not ported yet "
                "(ROADMAP Queue 1: staged sync search)" % K)
        k_min = K * 4

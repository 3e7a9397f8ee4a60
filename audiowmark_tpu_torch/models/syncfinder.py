"""Sync finder: candidate selection over the device search.

Port of audiowmark_tpu/models/syncfinder.py (reference: src/syncfinder.cc):
the fused search of ops/search_fused.py on the device, then the exact CLI
selection on its fetched (K,) outputs — approx threshold/n-best, refined
candidates, final classification (quality = |raw - mean|, block type A for
a positive sign).  BLOCK streams longer than MAX_FUSED_FRAMES are searched
in overlapping tiles; the staged search (one stage at a time, selection on
the host) takes oversize CLIP streams and candidate slots that stay
saturated after the x4 escalation; --test-no-sync places the blocks where
the embedder put them.  `search_block_group` searches several chunks of
a long file in one batched launch per key, split over the cards, and
`search_clip_pair` the clip decoder's two windows in one; both give what
the per-chunk and per-window `search` gives, or None where the caller must
take that one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..crypto.keys import Key
from ..params import Params

from ..codec.convcode import ConvBlockType
from ..device import DeviceLike, card_count, resolve, spread
from ..ops import search_fused
from ..ops import sync as sync_ops
from ..ops.sync import SHIFTS
from ..tables import get_key_tables
from ..utils import prof


class SyncMode(Enum):
    BLOCK = 0
    CLIP = 1


@dataclass
class Score:
    index: int
    quality: float
    block_type: ConvBlockType
    # raw soft bits the search extracted at this score's refined position
    # (None after the staged or tiled search and --test-no-sync: the
    # decoder then extracts in one batch); CLIP-mode scores also carry
    # raw2, the consecutive second block's bits
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


def _frame_count(wav_data) -> int:
    return wav_data.n_values // wav_data.n_channels // Params.frame_size


def _scan_silence(samples: np.ndarray) -> Tuple[int, int]:
    """First/last non-zero raw sample-value indices
    (src/syncfinder.cc:155-169); returns (first, last) with last exclusive."""
    nz = np.nonzero(samples)[0]
    if nz.size == 0:
        return 0, 0
    return int(nz[0]), int(nz[-1]) + 1


def _select_local_maxima(abs_q: np.ndarray) -> np.ndarray:
    """Local-maxima mask matching the reference's sequential scan
    (src/syncfinder.cc:258-281): a selected peak skips its right neighbor,
    which on plateaus of equal values selects every other element.  That
    alternation restarts at each run of consecutive candidate positions, so
    it vectorizes as (position - run_start) even."""
    n = abs_q.size
    if n == 0:
        return np.zeros(0, dtype=bool)
    q_prev = np.concatenate(([0.0], abs_q[:-1]))
    q_next = np.concatenate((abs_q[1:], [0.0]))
    mask = (abs_q >= q_prev) & (abs_q >= q_next)
    idx = np.arange(n)
    run_start = mask & np.concatenate(([True], ~mask[:-1]))
    start = np.maximum.accumulate(np.where(run_start, idx, -1))
    return mask & ((idx - start) % 2 == 0)


def _mask_avg_false_positives(indices: np.ndarray, raw: np.ndarray,
                              mean: np.ndarray) -> np.ndarray:
    """Keep-mask: drop candidates with an opposite-sign neighbor 3x larger
    within 23 steps (src/syncfinder.cc:283-332), as shifted array
    comparisons."""
    mask_distance = 20 + 3  # local_mean_distance + 3
    mask_factor = 3.0
    n = indices.size
    aq = np.abs(raw - mean)
    sign = np.where(raw - mean < 0, -1, 1)
    masked = np.zeros(n, dtype=bool)
    for d in range(1, min(mask_distance, n - 1) + 1):
        step_dist = (indices[d:] - indices[:-d]) // Params.sync_search_step
        opp = (step_dist <= mask_distance) & (sign[d:] != sign[:-d])
        masked[:-d] |= opp & (aq[d:] > aq[:-d] * mask_factor)
        masked[d:] |= opp & (aq[:-d] > aq[d:] * mask_factor)
    return ~masked


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


def _fake_sync(key_list: List[Key], wav_data,
               mode: SyncMode) -> List[KeyResult]:
    """--test-no-sync: the exact expected positions
    (src/syncfinder.cc:460-485)."""
    result_scores = []
    if mode == SyncMode.BLOCK:
        tables = get_key_tables(key_list[0])
        expect0 = Params.frames_pad_start * Params.frame_size
        expect_step = tables.frames_per_block * Params.frame_size
        expect_end = _frame_count(wav_data) * Params.frame_size
        ab = 0
        idx = expect0
        while idx + expect_step < expect_end:
            result_scores.append(Score(
                idx, 1.0,
                ConvBlockType.b if (ab & 1) else ConvBlockType.a))
            ab += 1
            idx += expect_step
    return [KeyResult(key=key, sync_scores=list(result_scores))
            for key in key_list]


def upload(wav_data, device: torch.device) -> torch.Tensor:
    """wav_data's samples as a (n*C,) f32 tensor on `device`."""
    return torch.from_numpy(
        np.ascontiguousarray(wav_data.samples, dtype=np.float32)).to(device)


def search(key_list: List[Key], wav_data, mode: SyncMode,
           device: DeviceLike = None,
           x: Optional[torch.Tensor] = None) -> List[KeyResult]:
    """Candidate block starts per key: the fused search, or the staged one
    where the fused search returns None (an oversize CLIP stream, slots
    saturated at _K_CAP).  x: wav_data's samples already on the device
    (upload), else uploaded here."""
    if Params.test_no_sync:
        return _fake_sync(key_list, wav_data, mode)
    dev = resolve(device)
    with prof.phase("get.search_%s" % mode.name.lower()):
        if x is None:
            x = upload(wav_data, dev)
        results = []
        for key in key_list:
            r = _search_fused_one(key, wav_data, mode, x)
            if r is None:
                return search_staged(key_list, wav_data, mode, dev, x)
            results.append(r)
        return results


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
                      x: torch.Tensor) -> Optional[KeyResult]:
    """The fused search for one key on x (wav_data's samples on the
    device); None -> the caller takes the staged search."""
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

    # T covers every sample, a partial last frame included (the JAX
    # package takes bucket_frames(F) and fails when F is a multiple of
    # _BUCKET_FRAMES and a partial frame follows; T is the same elsewhere)
    T = search_fused.bucket_frames(-(-true_frames // Params.frame_size))
    if T > search_fused.MAX_FUSED_FRAMES:
        if clip:
            return None         # clips are short; oversize -> staged search
        return _search_fused_tiled(key, wav_data, tables, x, n_starts_true)
    n_starts_s = SHIFTS * (T - 1 - total)

    if clip:
        sil_first, sil_last = _scan_silence(samples)
    else:
        sil_first, sil_last = 0, samples.size

    x = torch.cat([x, x.new_zeros(T * Params.frame_size * n_channels
                                  - x.shape[0])])
    searcher = search_fused.sync_searcher(tables, clip, x.device)

    # saturation escalation: retry with 4x the slots (reduced sync
    # geometries overflow the default top-K with above-threshold candidates)
    k_min = 0
    while True:
        K, complete = _fused_k_for(T, tables.frames_per_block, n_starts_s,
                                   k_min)
        out = searcher(x, n_channels, K, n_starts_true, true_frames,
                       sil_first, sil_last, 0, n_starts_s)
        out_np = {k: v.cpu().numpy() for k, v in out.items()}
        r = _select_from_fused(key, out_np, K, clip, complete)
        if r is not None:
            return r
        if complete or K >= _K_CAP:
            return None
        k_min = K * 4


def _n_above(out_np: dict, n_el: int) -> int:
    aq = np.abs(out_np["q"][:n_el].astype(np.float64)
                - out_np["mean"][:n_el].astype(np.float64))
    return int(np.count_nonzero(aq > Params.sync_threshold2 * 0.75))


def _search_fused_tiled(key: Key, wav_data, tables, x_full: torch.Tensor,
                        n_starts_true: int) -> Optional[KeyResult]:
    """BLOCK search for streams beyond MAX_FUSED_FRAMES (the production
    30-minute chunk, src/wavchunkloader.cc:74-97): overlapping tiles of
    MAX_FUSED_FRAMES frames, one search each on device-side slices of the
    chunk's one upload, eligibility restricted to disjoint cores, merged
    CLI-exact selection on the host.

    Scores are exact everywhere (each start's span lies inside its tile's
    audio); eligibility needs neighbourhood context (+-20 local mean, +-23
    opposite-sign mask), so each tile also scores a TILE_HALO ring it may
    not take candidates from.  The result equals the whole-stream search
    except on exact-score tie plateaus crossing a tile boundary.  Every
    tile is launched before the first host read; tiles skip the raws
    (selection keeps ~n_best of all the slots; the decoder extracts the
    survivors in one batch), and a saturated tile escalates K on its own.
    None -> the staged search (a tile saturated at _K_CAP)."""
    samples = wav_data.samples
    C = wav_data.n_channels
    frame = Params.frame_size
    true_frames = samples.size // C
    T_tile = search_fused.MAX_FUSED_FRAMES
    HALO = search_fused.TILE_HALO
    n_starts_tile = SHIFTS * (T_tile - 1 - tables.frames_per_block)
    if n_starts_tile <= 2 * HALO + SHIFTS:
        return None             # a tile can't fit a core between its halos
    tile_vals = T_tile * frame * C
    searcher = search_fused.sync_searcher(tables, False, x_full.device)

    # ---- geometry, and one launch per tile ----
    tiles = []
    g_core_lo = 0
    while g_core_lo < n_starts_true:
        f0 = max(g_core_lo - HALO, 0) // SHIFTS
        g0 = SHIFTS * f0
        core_lo = g_core_lo - g0
        n_valid = min(n_starts_tile, n_starts_true - g0)
        core_hi = n_valid if g0 + n_starts_tile >= n_starts_true \
            else n_starts_tile - HALO
        lo_v = f0 * frame * C
        seg_vals = min(tile_vals, samples.size - lo_v)
        x = x_full[lo_v: lo_v + seg_vals]
        if seg_vals < tile_vals:
            x = torch.cat([x, x.new_zeros(tile_vals - seg_vals)])
        args = (x, C, n_valid, true_frames - f0 * frame, 0, seg_vals,
                core_lo, core_hi)
        K, complete = _fused_k_for(T_tile, tables.frames_per_block,
                                   core_hi - core_lo)
        out = _launch(searcher, args, K)
        tiles.append((g0, f0, args, K, complete, out))
        g_core_lo = g0 + core_hi

    # ---- read in launch order; escalate saturated tiles ----
    cand = {k: [] for k in ("t", "q", "mean", "rpos", "rq")}
    for g0, f0, args, K, complete, out in tiles:
        while True:
            out_np = {k: v.cpu().numpy() for k, v in out.items()}
            n_el = int(np.count_nonzero(out_np["eligible"]))
            if not (n_el == K and _n_above(out_np, n_el) == K
                    and not complete):
                break
            if K >= _K_CAP:
                return None     # saturated tile at the cap: staged search
            core_lo, core_hi = args[-2:]
            K, complete = _fused_k_for(T_tile, tables.frames_per_block,
                                       core_hi - core_lo, K * 4)
            out = _launch(searcher, args, K)
        cand["t"].append(out_np["t"][:n_el].astype(np.int64) + g0)
        cand["q"].append(out_np["q"][:n_el].astype(np.float64))
        cand["mean"].append(out_np["mean"][:n_el].astype(np.float64))
        cand["rpos"].append(out_np["refined_pos"][:n_el].astype(np.int64)
                            + f0 * frame)
        cand["rq"].append(out_np["refined_q"][:n_el].astype(np.float64))

    # ---- merged CLI-exact selection: each tile's slots are quality-
    # descending, but the host selection breaks quality ties by approx step
    # order, so sort the merged slots by global step first (cores are
    # disjoint, so steps are unique across tiles) ----
    order = np.argsort(np.concatenate(cand["t"]), kind="stable")
    q = np.concatenate(cand["q"])[order]
    mean = np.concatenate(cand["mean"])[order]
    rpos = np.concatenate(cand["rpos"])[order]
    rq = np.concatenate(cand["rq"])[order]
    sel = _threshold_n_best_order(np.abs(q - mean),
                                  Params.sync_threshold2 * 0.75)
    keep = [_SearchScore(index=int(rpos[i]), raw_quality=float(rq[i]),
                         local_mean=float(mean[i])) for i in sel]
    return _finalize_scores(key, keep)


def _launch(searcher, args, K: int) -> dict:
    """One tile's search without raws; its outputs stay on the device."""
    x, C, n_valid, n_samp_rel, sil_first, sil_last, core_lo, core_hi = args
    return searcher(x, C, K, n_valid, n_samp_rel, sil_first, sil_last,
                    core_lo, core_hi, extract=False)


def group_device_count(device: DeviceLike = None) -> int:
    """Devices for the chunk-group search of the get path
    (device.card_count)."""
    return card_count(device)


def _padded_frames(wav_data) -> int:
    """Frames of the padded search length for a stream, a partial last
    frame included (as _search_fused_one pads)."""
    true_frames = wav_data.samples.size // wav_data.n_channels
    return search_fused.bucket_frames(-(-true_frames // Params.frame_size))


def _upload_padded(wav_data, T: int, device: torch.device,
                   x: Optional[torch.Tensor] = None) -> torch.Tensor:
    """wav_data's samples on `device`, zero-padded to T frames; x: the
    samples where a device holds them already."""
    x = upload(wav_data, device) if x is None else x.to(device)
    return torch.cat([x, x.new_zeros(
        T * Params.frame_size * wav_data.n_channels - x.shape[0])])


def _select_rows(key: Key, out_np: dict, n_starts, K: int, clip: bool,
                 complete: bool) -> Optional[List[KeyResult]]:
    """The CLI selection on every row of a group's fetched outputs; None
    when a row's slots are saturated."""
    key_rs = []
    for i, n in enumerate(n_starts):
        if n <= 0:
            key_rs.append(KeyResult(key=key))
            continue
        r = _select_from_fused(key, {k: v[i] for k, v in out_np.items()}, K,
                               clip, complete)
        if r is None:
            return None
        key_rs.append(r)
    return key_rs


def search_block_group(key_list: List[Key], wav_list,
                       device: DeviceLike = None,
                       xs: Optional[list] = None) -> Optional[list]:
    """BLOCK search over a group of chunks: ONE batched launch per key
    scores every chunk, the rows split over group_device_count() devices
    (the reference's analogue is the ThreadPool fan-out in
    src/syncfinder.cc:607-657).

    Returns per-chunk List[KeyResult] equal to `search(key_list, chunk,
    BLOCK)` per chunk, or None if any chunk needs another path (chunks
    past MAX_FUSED_FRAMES, saturated slots at _K_CAP, degenerate sizes,
    --test-no-sync): the caller then searches chunk by chunk.  xs: per
    chunk its samples on a device (upload's form) or None."""
    if Params.test_no_sync or len(wav_list) < 2:
        return None
    n_dev = group_device_count(device)
    n_channels = wav_list[0].n_channels
    T = max(_padded_frames(w) for w in wav_list)
    if T > search_fused.MAX_FUSED_FRAMES:
        return None
    B = -(-len(wav_list) // n_dev) * n_dev      # rows, zero rows included
    devices = spread(device, n_dev)
    per = B // n_dev

    # each chunk uploaded once, to the device of its row
    have = xs if xs is not None else [None] * len(wav_list)
    xs = []
    for i in range(B):
        dev = devices[i // per]
        xs.append(_upload_padded(wav_list[i], T, dev, have[i])
                  if i < len(wav_list)
                  else torch.zeros(T * Params.frame_size * n_channels,
                                   device=dev))
    zeros = [0] * B

    per_chunk: list = [[] for _ in wav_list]
    for key in key_list:
        tables = get_key_tables(key)
        total = tables.frames_per_block
        n_starts_s = SHIFTS * (T - 1 - total)
        if n_starts_s <= 0:
            return None
        n_starts, frames, sil_last = list(zeros), list(zeros), list(zeros)
        for i, wav in enumerate(wav_list):
            true_frames = wav.samples.size // n_channels
            n_starts[i] = max(
                SHIFTS * (true_frames // Params.frame_size - 1 - total), 0)
            frames[i] = true_frames
            sil_last[i] = wav.samples.size

        group = search_fused.build_searcher_group(tables, False, devices)
        k_min = 0
        while True:
            K, complete = _fused_k_for(T, total, n_starts_s, k_min)
            out_np = group.fetch(group(xs, n_channels, K, n_starts, frames,
                                       zeros, sil_last, zeros,
                                       [n_starts_s] * B))
            key_rs = _select_rows(key, out_np, n_starts[:len(wav_list)], K,
                                  False, complete)
            if key_rs is not None:
                break
            if complete or K >= _K_CAP:
                return None
            k_min = K * 4               # a saturated chunk: escalate K
        for i, r in enumerate(key_rs):
            per_chunk[i].append(r)
    return per_chunk


def search_clip_pair_launch(key_list: List[Key], wav_list,
                            device: DeviceLike = None
                            ) -> Optional[Callable[[], Optional[list]]]:
    """The launching half of search_clip_pair: upload the clip decoder's
    padded windows and enqueue one batched search per key WITHOUT reading
    anything back.  Returns a zero-argument finish() that reads back and
    selects (escalating K on saturated slots), or None when the pair
    search does not apply up front.

    The split lets the get path enqueue the clip search before the block
    search's blocking read, so the card scores the clip windows while the
    host waits for and selects from the block results."""
    if Params.test_no_sync or len(wav_list) < 2:
        return None
    C = wav_list[0].n_channels
    T = max(_padded_frames(w) for w in wav_list)
    if T > search_fused.MAX_FUSED_FRAMES:
        return None              # clips are short; oversize -> per window
    B = len(wav_list)
    dev = resolve(device)

    with prof.phase("get.search_clip"):
        sil = [_scan_silence(w.samples) for w in wav_list]
        xs = [_upload_padded(w, T, dev) for w in wav_list]
        pending = []
        for key in key_list:
            tables = get_key_tables(key)
            total = 2 * tables.frames_per_block
            n_starts_s = SHIFTS * (T - 1 - total)
            if n_starts_s <= 0:
                return None
            sizes = [w.samples.size for w in wav_list]
            args = ([max(SHIFTS * (s // C // Params.frame_size - 1 - total),
                         0) for s in sizes],
                    [s // C for s in sizes],
                    [a for a, _ in sil], [b for _, b in sil],
                    [0] * B, [n_starts_s] * B)
            K, complete = _fused_k_for(T, tables.frames_per_block,
                                       n_starts_s)
            group = search_fused.build_searcher_group(tables, True, [dev])
            out = group(xs, C, K, *args)         # enqueued, not read
            pending.append((key, tables, group, n_starts_s, args, K,
                            complete, out))

    def finish() -> Optional[List[List[KeyResult]]]:
        with prof.phase("get.search_clip"):
            per_window: List[List[KeyResult]] = [[] for _ in wav_list]
            for key, tables, group, n_starts_s, args, K, complete, out \
                    in pending:
                while True:
                    key_rs = _select_rows(key, group.fetch(out), args[0], K,
                                          True, complete)
                    if key_rs is not None:
                        break
                    if complete or K >= _K_CAP:
                        return None
                    K, complete = _fused_k_for(T, tables.frames_per_block,
                                               n_starts_s, K * 4)
                    out = group(xs, C, K, *args)
                for i, r in enumerate(key_rs):
                    per_window[i].append(r)
            return per_window

    return finish


def search_clip_pair(key_list: List[Key], wav_list,
                     device: DeviceLike = None
                     ) -> Optional[List[List[KeyResult]]]:
    """CLIP search over the clip decoder's padded start and end windows in
    ONE batched launch per key.  Returns per-window List[KeyResult] equal
    to `search(key_list, window, CLIP)`, or None when the caller must
    search per window (--test-no-sync, an oversize window, slots saturated
    at _K_CAP)."""
    fin = search_clip_pair_launch(key_list, wav_list, device)
    return fin() if fin is not None else None


def search_staged(key_list: List[Key], wav_data, mode: SyncMode,
                  device: DeviceLike = None,
                  x: Optional[torch.Tensor] = None) -> List[KeyResult]:
    """The search one stage at a time (the fused search's oracle and its
    fallback): spectrogram, sweep and local mean on the device, selection
    on the host, then the refinement grid on the device.  Scores carry no
    raws."""
    dev = resolve(device)
    if x is None:
        x = upload(wav_data, dev)
    samples = wav_data.samples
    n_channels = wav_data.n_channels
    clip = mode == SyncMode.CLIP
    silence_bounds = _scan_silence(samples) if clip else None

    # one spectrogram shared by all keys
    S, have = sync_ops.hop_spectrogram(x, n_channels, silence_bounds)

    key_results: List[KeyResult] = []
    for key in key_list:
        sb = sync_ops.device_sync_bits(get_key_tables(key), clip, dev)
        q_dev = sync_ops.sync_score_sweep(S, have, sb).to(torch.float64)
        qualities = q_dev.cpu().numpy()
        means = sync_ops.local_mean(q_dev).cpu().numpy()

        # array-stage selection: no per-tau Python objects until only
        # ~n_best candidates remain
        abs_q = np.abs(qualities - means)
        sel = np.nonzero(_select_local_maxima(abs_q))[0]
        indices = sel * Params.sync_search_step
        keep = _mask_avg_false_positives(indices, qualities[sel], means[sel])
        sel = sel[keep]
        order = _threshold_n_best_order(abs_q[sel],
                                        Params.sync_threshold2 * 0.75)
        sel = sel[order]
        if clip:
            # already quality-sorted; truncate (src/syncfinder.cc:528-533)
            sel = sel[:max(Params.get_n_best, 5)]

        scores = [
            _SearchScore(index=int(t) * Params.sync_search_step,
                         raw_quality=float(qualities[t]),
                         local_mean=float(means[t]))
            for t in sel
        ]

        # refine: +-256 around each candidate in steps of 8
        grid_pos, grid_quals = sync_ops.refine_grid(
            x, n_channels,
            np.asarray([s.index for s in scores], dtype=np.int64), sb,
            silence_bounds)

        refined = []
        for score, positions, quals in zip(scores, grid_pos, grid_quals):
            best_quality = score.raw_quality
            best_index = score.index
            for pos, q in zip(positions, quals):
                if np.isnan(q):
                    continue
                if abs(q - score.local_mean) \
                        > abs(best_quality - score.local_mean):
                    best_quality = float(q)
                    best_index = int(pos)
            refined.append(_SearchScore(best_index, best_quality,
                                        score.local_mean))
        key_results.append(_finalize_scores(key, refined))
    return key_results

"""Watermark decoder: block decoder, clip decoder, soft-bit normalisation.

Port of audiowmark_tpu/models/decoder.py (reference: src/wmget.cc): sync
candidates from the sync finder, with the raw soft bits the fused device
search extracted at each refined start (or, after the staged or tiled
search and --test-no-sync, the raws of one batched extraction), keyed
de-interleaving, A+B joining, the greedy "all" block-chain merge, and the
clip decoder on zero-padded ~2-block windows at the stream's start and
end.  Each decoder uploads its audio once, for the search and the
extraction.  The block decoder also takes the results of a group search
made ahead of it, and the clip decoder searches its two windows in one
launch, enqueued by `launch` and read back by the `finish` it returns.
All decodes of one get share ONE batched trellis launch (codec/convcode.py
-> kernel K1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..crypto.keys import Key
from ..params import Params

from ..codec import ConvBlockType, code_size
from ..codec.convcode import conv_decode_soft_mixed
from ..codec.dispatch import code_decode_soft_batch
from ..device import DeviceLike, resolve
from ..ops.extract import block_raw, layout
from ..ops.frames import FRAME
from ..tables import (KeyTables, get_key_tables, randomize_bit_order,
                      tables_to_device)
from ..utils import prof
from . import syncfinder
from .resultset import PatternType, ResultSet
from .syncfinder import SyncMode


def _block_raw_batch(x: torch.Tensor, n_channels: int, indices: List[int],
                     tables: KeyTables) -> dict:
    """Raw (pre-interleave) soft bits for each candidate start index of x
    ((n*C,) f32 on the device), in one batched extraction; indices repeat
    at most once, and blocks that read past the end are dropped (the
    reference skips them).  Returns {index: raw (n_coded,)}."""
    count = tables.frames_per_block
    n_sample_frames = x.shape[0] // n_channels
    valid = [i for i in dict.fromkeys(indices)
             if i + count * FRAME <= n_sample_frames]
    if not valid:
        return {}
    lay_frame, lay_up, lay_dn, group = layout(tables, x.device)
    raws = block_raw(
        x.reshape(-1, n_channels), torch.tensor(valid, device=x.device),
        tables_to_device(tables, x.device)["analysis_window"], lay_frame,
        lay_up, lay_dn, count, bool(Params.mix), group,
        Params.frames_per_bit).cpu().numpy()
    return {i: raws[k] for k, i in enumerate(valid)}


def _raw_map_from_scores(samples: np.ndarray, n_channels: int, scores,
                         tables: KeyTables, clip: bool) -> Optional[dict]:
    """{index: raw} from the raws the fused search extracted at the refined
    positions (Score.raw/raw2), dropping blocks that read past the end
    (index + frames_per_block*FRAME <= frames, as the reference skips
    them); None when any score lacks them (the staged or tiled search,
    --test-no-sync): the caller then extracts in one batch."""
    if not scores or any(ss.raw is None or (clip and ss.raw2 is None)
                         for ss in scores):
        return None
    nsf = samples.size // n_channels
    cnt = tables.frames_per_block * FRAME
    raw_map = {}
    for ss in scores:
        if ss.index + cnt <= nsf:
            raw_map[ss.index] = ss.raw
        if clip and ss.index + 2 * cnt <= nsf:
            raw_map[ss.index + cnt] = ss.raw2
    return raw_map


def normalize_soft_bits(soft_bits: np.ndarray) -> np.ndarray:
    """Rescale [-mean,+mean] -> [0,1] (src/wmget.cc:40-65)."""
    if Params.hard:
        return (soft_bits > 0).astype(np.float32)
    mean = float(np.mean(np.abs(soft_bits)))
    with np.errstate(invalid="ignore", divide="ignore"):
        # mean == 0 on degenerate (all-zero) input gives nan soft bits,
        # matching the reference's unchecked C++ float division
        return (0.5 * (soft_bits / mean + 1)).astype(np.float32)


# ---- block decoder -----------------------------------------------------------

class _DecodeJobs:
    """Queue of soft-bit Viterbi decodes (the reference runs these on its
    thread pool).  All block types flush in ONE batched trellis launch
    (convcode.conv_decode_soft_mixed).  Short payloads keep the per-type
    path (the exhaustive codeword match differs)."""

    def __init__(self, device: DeviceLike = None):
        self.device = device
        self.jobs = []

    def add(self, block_type: ConvBlockType, soft_bits: np.ndarray, emit):
        self.jobs.append((block_type, soft_bits, emit))

    def flush(self):
        if not self.jobs:
            return
        order = (ConvBlockType.a, ConvBlockType.b, ConvBlockType.ab)
        by_type = [(bt, [(soft, emit) for t, soft, emit in self.jobs
                         if t == bt]) for bt in order]
        by_type = [(bt, group) for bt, group in by_type if group]
        self.jobs = []
        if Params.payload_short:
            for bt, group in by_type:
                batch = np.stack([soft for soft, _ in group])
                for (bits, err), (_, emit) in zip(
                        code_decode_soft_batch(bt, batch, self.device),
                        group):
                    if len(bits):
                        emit(bits, err)
            return
        groups = [(bt, np.stack([soft for soft, _ in group]))
                  for bt, group in by_type]
        for (bits, errs), (_, group) in zip(
                conv_decode_soft_mixed(groups, self.device), by_type):
            for i, (_, emit) in enumerate(group):
                if bits.shape[1]:
                    emit(bits[i], float(errs[i]))


@dataclass
class _PatternRawBits:
    index: int
    quality: float
    raw_bit_vec: np.ndarray
    block_type: ConvBlockType


class BlockDecoder:
    def __init__(self, speed: float, device: DeviceLike = None):
        self.speed = speed
        self.device = device
        self.debug_sync_frame_count = 0
        self.key_results: List[syncfinder.KeyResult] = []

    def run(self, key_list: List[Key], wav_data, result_set: ResultSet,
            jobs: _DecodeJobs,
            sync_results: Optional[List[syncfinder.KeyResult]] = None,
            x: Optional[torch.Tensor] = None):
        """Search and queue this chunk's decodes on `jobs`; the caller
        flushes (one trellis launch covers the block and clip decodes).
        sync_results: the chunk's BLOCK KeyResults where a group search
        already made them (syncfinder.search_block_group); None -> search
        now.  x: the chunk's samples where they are on the device already
        (syncfinder.upload's form); None -> uploaded here when needed."""
        if sync_results is None:
            if x is None:
                with prof.phase("get.upload"):
                    x = syncfinder.upload(wav_data, resolve(self.device))
            sync_results = syncfinder.search(key_list, wav_data,
                                             SyncMode.BLOCK, self.device, x)
        self.key_results = sync_results
        with prof.phase("get.extract"):
            self._extract(wav_data, result_set, jobs, x)

    def _extract(self, wav_data, result_set: ResultSet, jobs: _DecodeJobs,
                 x: Optional[torch.Tensor]):
        """The soft bits of the found blocks, their A+B joins and the
        block chain, queued on `jobs`."""
        n_channels = wav_data.n_channels
        samples = wav_data.samples

        for key_result in self.key_results:
            key = key_result.key
            tables = get_key_tables(key)
            pattern_raw: List[_PatternRawBits] = []

            raw_map = _raw_map_from_scores(
                samples, n_channels, key_result.sync_scores, tables,
                clip=False)
            if raw_map is None:
                if x is None:
                    x = syncfinder.upload(wav_data, resolve(self.device))
                raw_map = _block_raw_batch(
                    x, n_channels,
                    [ss.index for ss in key_result.sync_scores], tables)
            for sync_score in key_result.sync_scores:
                raw_bits = raw_map.get(sync_score.index)
                if raw_bits is None:
                    continue
                raw_bits = randomize_bit_order(tables, raw_bits, encode=False)
                pattern_raw.append(_PatternRawBits(
                    sync_score.index, sync_score.quality, raw_bits,
                    sync_score.block_type))

                time = sync_score.index / wav_data.sample_rate

                def emit(bits, err, key=key, time=time, ss=sync_score):
                    result_set.add_pattern(
                        key, time, ss.quality, ss.block_type, bits, err,
                        PatternType.BLOCK, self.speed)

                jobs.add(sync_score.block_type,
                         normalize_soft_bits(raw_bits), emit)

            self._join_ab(key, tables, pattern_raw, wav_data, result_set,
                          jobs)
            self._all_chain(key, tables, pattern_raw, result_set, jobs)

        self.debug_sync_frame_count = (
            wav_data.n_values // wav_data.n_channels // FRAME)

    def _join_ab(self, key, tables, pattern_raw, wav_data, result_set, jobs):
        """A block followed by B block at the right distance -> AB decode."""
        count = tables.frames_per_block
        for i, pat_b in enumerate(pattern_raw):
            if pat_b.block_type != ConvBlockType.b:
                continue
            best_j = -1
            best_abs_dist = Params.frame_size // 2
            for j in range(i):
                if pattern_raw[j].block_type == ConvBlockType.a:
                    abs_dist = abs((pat_b.index - pattern_raw[j].index)
                                   - count * Params.frame_size)
                    if abs_dist < best_abs_dist:
                        best_j = j
                        best_abs_dist = abs_dist
            if best_j >= 0:
                a_pat = pattern_raw[best_j]
                ab_bits = np.empty(a_pat.raw_bit_vec.size * 2, np.float32)
                ab_bits[0::2] = a_pat.raw_bit_vec
                ab_bits[1::2] = pat_b.raw_bit_vec
                time = pat_b.index / wav_data.sample_rate
                quality = (a_pat.quality + pat_b.quality) / 2

                def emit(bits, err, key=key, time=time, quality=quality):
                    result_set.add_pattern(
                        key, time, quality, ConvBlockType.ab, bits, err,
                        PatternType.BLOCK, self.speed)

                jobs.add(ConvBlockType.ab, normalize_soft_bits(ab_bits),
                         emit)

    def _all_chain(self, key, tables, pattern_raw, result_set, jobs):
        """Greedy chain of blocks at expected spacing with A/B alternation;
        average soft bits over the best chain (src/wmget.cc:606-701)."""
        if not pattern_raw:
            return
        count = tables.frames_per_block
        best_all_blocks: List[int] = []

        def sync_sum(blocks):
            return sum(pattern_raw[b].quality for b in blocks)

        for i in range(len(pattern_raw)):
            max_block_idx = int(round(
                pattern_raw[-1].index / float(count * Params.frame_size)
                + 0.5))
            all_blocks = [i]
            block_idx = 1
            while block_idx <= max_block_idx:
                expect_start = pattern_raw[all_blocks[-1]].index \
                    + block_idx * count * Params.frame_size
                best_j = -1
                best_abs_dist = block_idx * Params.frame_size // 2
                expect_bt = pattern_raw[all_blocks[-1]].block_type
                if block_idx & 1:
                    expect_bt = (ConvBlockType.b
                                 if expect_bt == ConvBlockType.a
                                 else ConvBlockType.a)
                for j in range(all_blocks[-1], len(pattern_raw)):
                    abs_dist = abs(expect_start - pattern_raw[j].index)
                    if abs_dist < best_abs_dist:
                        if pattern_raw[j].block_type == expect_bt:
                            best_j = j
                            best_abs_dist = abs_dist
                if best_j >= 0:
                    all_blocks.append(best_j)
                    block_idx = 1
                else:
                    block_idx += 1
            if sync_sum(all_blocks) > sync_sum(best_all_blocks):
                best_all_blocks = all_blocks

        if len(best_all_blocks) > 1:
            n_ab = code_size(ConvBlockType.ab, Params.payload_size)
            raw_all = np.zeros(n_ab, dtype=np.float64)
            norm = [0, 0]
            quality = 0.0
            for bi in best_all_blocks:
                pat = pattern_raw[bi]
                quality += pat.quality
                ab = 1 if pat.block_type == ConvBlockType.b else 0
                raw_all[ab::2] += pat.raw_bit_vec
                norm[ab] += 1
            raw_all[0::2] /= max(norm[0], 1)
            raw_all[1::2] /= max(norm[1], 1)
            quality /= (norm[0] + norm[1])
            soft = normalize_soft_bits(raw_all.astype(np.float32))

            def emit(bits, err, key=key, quality=quality):
                result_set.add_pattern(
                    key, 0.0, quality, ConvBlockType.ab, bits, err,
                    PatternType.ALL, self.speed)

            jobs.add(ConvBlockType.ab, soft, emit)

    def debug_sync(self) -> str:
        """sync_match debug line (exactly one key; src/wmget.cc:707-734)."""
        if len(self.key_results) != 1:
            return ""
        tables = get_key_tables(self.key_results[0].key)
        sync_scores = self.key_results[0].sync_scores
        expect0 = Params.frames_pad_start * Params.frame_size
        expect_step = tables.frames_per_block * Params.frame_size
        expect_end = self.debug_sync_frame_count * Params.frame_size

        sync_match = 0
        expect_index = expect0
        while expect_index + expect_step < expect_end:
            for ss in sync_scores:
                if abs(ss.index + Params.test_cut - expect_index) \
                        < Params.frame_size // 2:
                    sync_match += 1
                    break
            expect_index += expect_step
        return "sync_match %d %d\n" % (sync_match, len(sync_scores))


# ---- clip decoder ------------------------------------------------------------

class ClipDecoder:
    def __init__(self, speed: float, device: DeviceLike = None):
        self.speed = speed
        self.device = device

    def _run_padded(self, key_list, wav_data, result_set, time_offset_sec,
                    jobs: _DecodeJobs, sync_results=None):
        """sync_results: the window's CLIP KeyResults where the pair search
        made them; None -> search now."""
        x = None
        if sync_results is None:
            with prof.phase("get.upload"):
                x = syncfinder.upload(wav_data, resolve(self.device))
            sync_results = syncfinder.search(key_list, wav_data,
                                             SyncMode.CLIP, self.device, x)
        with prof.phase("get.extract"):
            self._extract(wav_data, sync_results, result_set,
                          time_offset_sec, jobs, x)

    def _extract(self, wav_data, key_results, result_set: ResultSet,
                 time_offset_sec, jobs: _DecodeJobs,
                 x: Optional[torch.Tensor]):
        """The joined soft bits of each found block pair of the window,
        queued on `jobs`."""
        n_channels = wav_data.n_channels
        samples = wav_data.samples
        for key_result in key_results:
            key = key_result.key
            tables = get_key_tables(key)
            count = tables.frames_per_block
            raw_map = _raw_map_from_scores(
                samples, n_channels, key_result.sync_scores, tables,
                clip=True)
            if raw_map is None:
                if x is None:
                    x = syncfinder.upload(wav_data, resolve(self.device))
                raw_map = _block_raw_batch(
                    x, n_channels,
                    [i for ss in key_result.sync_scores
                     for i in (ss.index, ss.index + count * FRAME)], tables)
            for sync_score in key_result.sync_scores:
                index = sync_score.index
                r1 = raw_map.get(index)
                r2 = raw_map.get(index + count * FRAME)
                if r1 is None or r2 is None:
                    continue
                raw1 = randomize_bit_order(tables, r1, encode=False)
                raw2 = randomize_bit_order(tables, r2, encode=False)
                raw = np.empty(raw1.size * 2, dtype=np.float32)
                if sync_score.block_type == ConvBlockType.a:
                    raw[0::2], raw[1::2] = raw1, raw2
                else:
                    raw[0::2], raw[1::2] = raw2, raw1

                def emit(bits, err, key=key, ss=sync_score):
                    result_set.add_pattern(
                        key, time_offset_sec, ss.quality, ss.block_type,
                        bits, err, PatternType.CLIP, self.speed)

                jobs.add(ConvBlockType.ab, normalize_soft_bits(raw), emit)

    def _build_window(self, key_list, wav_data, pos: str):
        """Zero-padded ~2-block window at the stream start or end
        (src/wmget.cc clip handling); (wav, time_offset) or None."""
        tables = get_key_tables(key_list[0])
        frames_per_block = tables.frames_per_block
        n = (frames_per_block + 5) * FRAME * wav_data.n_channels
        pad_start = n
        pad_end = n
        if pos == "start":
            first_sample = 0
            last_sample = min(n, wav_data.n_values)
            if last_sample < n:
                pad_start += n - last_sample
        else:
            if wav_data.n_values <= n:
                return None
            first_sample = wav_data.n_values - n
            last_sample = wav_data.n_values
        time_offset = first_sample / wav_data.sample_rate / wav_data.n_channels
        ext = np.concatenate([
            np.zeros(pad_start, dtype=np.float32),
            wav_data.samples[first_sample:last_sample],
            np.zeros(pad_end, dtype=np.float32)])
        return wav_data.with_samples(ext), time_offset

    def launch(self, key_list, wav_data):
        """Build the padded start and end windows and ENQUEUE their pair
        search without reading it back; returns finish(result_set, jobs),
        which reads back, selects and queues the decodes, or None for
        streams of 3.1 blocks or more (no clip decoding).  The get path
        calls launch() before the block search's blocking read."""
        tables = get_key_tables(key_list[0])
        wav_frames = wav_data.n_values // (FRAME * wav_data.n_channels)
        if wav_frames >= tables.frames_per_block * 3.1:
            return None
        with prof.phase("get.clip_windows"):
            windows = [w for w in (self._build_window(key_list, wav_data,
                                                      pos)
                                   for pos in ("start", "end"))
                       if w is not None]
        # both windows in ONE batched search; None -> window by window
        pair_fin = (syncfinder.search_clip_pair_launch(
                        key_list, [w for w, _ in windows], self.device)
                    if len(windows) == 2 else None)

        def finish(result_set: ResultSet, jobs: _DecodeJobs):
            pre = pair_fin() if pair_fin is not None else None
            for i, (l_wav, time_offset) in enumerate(windows):
                self._run_padded(key_list, l_wav, result_set, time_offset,
                                 jobs, pre[i] if pre is not None else None)

        return finish

    def run(self, key_list, wav_data, result_set: ResultSet,
            jobs: _DecodeJobs):
        """Search the start and end windows and queue their decodes on
        `jobs`; nothing for streams of 3.1 blocks or more."""
        fin = self.launch(key_list, wav_data)
        if fin is not None:
            fin(result_set, jobs)

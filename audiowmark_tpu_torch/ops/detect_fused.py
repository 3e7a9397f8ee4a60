"""The fleet detector: the whole block-detect chain for a batch of streams.

Port of audiowmark_tpu/ops/detect_fused.py (reference hot loops:
src/syncfinder.cc:172-458, src/wmget.cc:503-553).  For every stream of a
(B, n_samples, C) batch:

  hop-256 dB spectrogram  ->  score sweep D = V . S^T over every start
  ->  local mean (+-20 without +-3)  ->  the CLI's candidate eligibility
  ->  top-K slots (ties to the lower start)  ->  +-256 / step-8 grid refine
  ->  the 2226-frame block spectrum at the refined start, mix-decoded soft
  bits with background subtraction, keyed de-interleave

and then ONE Viterbi launch for the whole batch: all B*K candidates against
the A generators and all of them against the B generators (B*2K trellis
rows, kernel K1 on the card), the candidate's sync sign choosing which of
the two decodes is reported.

The stages are those of the CLI search (ops/sync.py, ops/extract.py) on the
stream's exact length.  The detector differs from ops/search_fused.py in
what it keeps: a fixed number of slots per stream rather than the host's
threshold / n-best truncation (slots past the eligible candidates are
flagged by `eligible`), the fine position always in place of the approx
one, and the decode inside the same call.  Spectra come from the f32 rfft
as everywhere in this package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..codec.convcode import ORDER, ConvBlockType, viterbi_decoder
from ..crypto.keys import Key
from ..device import DeviceLike, resolve
from ..params import Params
from ..tables import get_key_tables, tables_to_device
from ..utils import prof
from .extract import block_raw
from .frames import FRAME, db_bands
from .search_fused import candidate_eligibility
from .sync import (HOP, SHIFTS, device_sync_bits, local_mean,
                   pad_channels_first, refine_grid_scores, sync_scores)


@dataclass
class DetectorConfig:
    n_frames: int            # T — whole frames in each stream
    n_channels: int = 2
    top_k: int = 8
    # candidates refined and extracted per pass: each one builds a
    # (J*C, 65, FRAME) f32 window stack for the refine and a whole block's
    # windows for the extraction
    candidate_batch: int = 4
    # apply the CLI's candidate eligibility (local maxima + opposite-sign
    # false-positive masking, src/syncfinder.cc:258-332) before the top-K,
    # so the fleet API surfaces the candidate set the CLI would; slots
    # beyond the eligible count are flagged by the `eligible` output
    cli_masking: bool = True


class FusedDetector(nn.Module):
    """The detector for one key and stream geometry, holding the key's sync
    layout, soft-bit layout and de-interleaver as buffers on its device."""

    def __init__(self, key: Key, cfg: DetectorConfig,
                 device: DeviceLike = None):
        super().__init__()
        prof.count("build.detector")
        dev = resolve(device)
        tables = get_key_tables(key)
        tdev = tables_to_device(tables, dev)
        self.cfg = cfg
        self.sb = device_sync_bits(tables, False, dev)
        self.fpb = tables.frames_per_block
        self.n_starts = SHIFTS * (cfg.n_frames - 1 - self.sb.total_frames)
        if self.n_starts <= 0:
            raise ValueError("stream too short for one block (%d frames, "
                             "need > %d)" % (cfg.n_frames,
                                             self.sb.total_frames))
        if cfg.top_k > self.n_starts:
            raise ValueError("top_k %d exceeds the %d starts of a %d-frame "
                             "stream" % (cfg.top_k, self.n_starts,
                                         cfg.n_frames))
        self.group = Params.bands_per_frame * Params.frames_per_bit
        self.register_buffer("awin", tdev["analysis_window"])
        self.register_buffer("mix_frame", tdev["mix_frame"].to(torch.int64))
        self.register_buffer(
            "mix_up", (tdev["mix_up"] - Params.min_band).to(torch.int64))
        self.register_buffer(
            "mix_dn", (tdev["mix_dn"] - Params.min_band).to(torch.int64))
        self.register_buffer("inv_order", torch.from_numpy(
            np.argsort(tables.bit_order).astype(np.int64)).to(dev))
        self.device = dev

    def _candidates(self, x: torch.Tensor):
        """One stream x (n_samples, C): the top-K slots' refined position,
        fine quality, local mean, eligibility and soft bits."""
        cfg = self.cfg
        C = cfg.n_channels
        K = cfg.top_k
        n_samples = x.shape[0]
        n_taus = SHIFTS * (cfg.n_frames - 1)

        # ---- hop-256 dB spectrogram, summed over channels ----
        with prof.phase("detect.spectrogram"):
            windows = x.T.unfold(1, FRAME, HOP)[:, :n_taus]
            S = torch.sum(db_bands(windows, self.awin), dim=0)

        # ---- score sweep, local mean, eligibility, top-K: a stable
        # descending sort gives ties (every filler slot scores -1) to the
        # lower start ----
        with prof.phase("detect.select"):
            q = sync_scores(S, self.sb, self.n_starts)
            mean = local_mean(q)
            if cfg.cli_masking:
                elig, aq = candidate_eligibility(
                    q, mean, torch.ones_like(q, dtype=torch.bool))
                score = torch.where(elig, aq, torch.full_like(aq, -1.0))
            else:
                score = torch.abs(q - mean)
            top = torch.sort(score, descending=True, stable=True).indices[:K]
            eligible = score[top] >= 0
            mean_top = mean[top]

        # ---- grid refine (src/syncfinder.cc:427-442): the fine position
        # with the largest |q - mean| among the valid ones, the first
        # maximum winning ----
        batch = max(1, min(cfg.candidate_batch, K))
        with prof.phase("detect.refine"):
            pos, fq, valid = refine_grid_scores(
                pad_channels_first(x.reshape(-1), C), top * HOP, n_samples,
                self.sb, self.awin, batch=batch)
            best = torch.argmax(torch.abs(fq - mean_top[:, None])
                                * valid.to(fq.dtype), dim=1, keepdim=True)
            best_pos = pos.gather(1, best)[:, 0]
            best_q = fq.gather(1, best)[:, 0]

        # ---- block decode at the refined start (src/wmget.cc:503-553) ----
        with prof.phase("detect.extract"):
            raw = block_raw(x, best_pos, self.awin, self.mix_frame,
                            self.mix_up, self.mix_dn, self.fpb, True,
                            self.group, Params.frames_per_bit, batch=batch)
            raw = raw[:, self.inv_order]
            soft = 0.5 * (raw / torch.mean(torch.abs(raw), dim=1,
                                           keepdim=True) + 1.0)
        return best_pos, best_q, mean_top, eligible, soft

    def forward(self, samples: torch.Tensor) -> Dict[str, torch.Tensor]:
        """samples: (B, n_samples, C) or (B, n_samples*C) f32 on this
        detector's device, n_samples = n_frames*FRAME.  Returns (B, K)
        tensors positions (sample index), qualities, block_is_a, errors,
        eligible and bits (B, K, n_payload)."""
        cfg = self.cfg
        n_samples = cfg.n_frames * FRAME
        if samples.dim() not in (2, 3) \
                or samples[0].numel() != n_samples * cfg.n_channels:
            raise ValueError(
                "samples must be (B, %d, %d) or (B, %d), got %s"
                % (n_samples, cfg.n_channels, n_samples * cfg.n_channels,
                   tuple(samples.shape)))
        if samples.dtype != torch.float32:
            raise TypeError("samples must be float32, got %s" % samples.dtype)
        B = samples.shape[0]
        K = cfg.top_k
        x = samples.reshape(B, n_samples, cfg.n_channels)
        per_stream = [self._candidates(x[b]) for b in range(B)]
        positions, fine_qs, means, eligible, softs = (
            torch.stack(col) for col in zip(*per_stream))

        # block type from the sync sign (A positive, B negative,
        # src/syncfinder.cc:544-553).  Every candidate of every stream
        # decodes against both generator sets in ONE trellis launch of
        # B*2K rows.
        is_a = fine_qs - means > 0
        flat = softs.reshape(B * K, -1)
        bits_ab, errs_ab = viterbi_decoder(self.device)(
            [(ConvBlockType.a, flat), (ConvBlockType.b, flat)])
        bits_ab = bits_ab[:, : bits_ab.shape[1] - ORDER]   # zero-term tail
        bits_a = bits_ab[: B * K].reshape(B, K, -1)
        bits_b = bits_ab[B * K:].reshape(B, K, -1)
        errs_a = errs_ab[: B * K].reshape(B, K)
        errs_b = errs_ab[B * K:].reshape(B, K)
        return {
            "positions": positions,
            "qualities": torch.abs(fine_qs - means),
            "block_is_a": is_a,
            "bits": torch.where(is_a[:, :, None], bits_a, bits_b),
            "errors": torch.where(is_a, errs_a, errs_b),
            "eligible": eligible,
        }


def build_detector(key: Key, cfg: DetectorConfig,
                   device: DeviceLike = None) -> FusedDetector:
    """The detector for `key` and `cfg` on `device` (default: the CUDA
    card)."""
    return FusedDetector(key, cfg, device)

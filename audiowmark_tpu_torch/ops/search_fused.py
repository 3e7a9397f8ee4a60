"""Sync search: approx score sweep -> select -> refine -> extract, on the
device, with the CLI's exact selection semantics.

Port of audiowmark_tpu/ops/search_fused.py's `search` (reference:
src/syncfinder.cc:172-458): dB spectrogram at 4 shifts, score every start,
subtract a +-20 local mean, pick local maxima (a selected peak skips its
right neighbor), drop candidates with an opposite-sign neighbor 3x larger
within 23 steps, keep the top K by |q - mean|, refine +-256 in steps of 8
keeping the best |q - mean|, and extract each kept candidate's raw soft
bits at its refined start.

The audio is padded to T frames (bucket_frames) and the true extent
enters as n_starts / n_sample_frames, so K and every mask match the JAX
package's for the same input; a tile of a long stream also passes the
core range it may take candidates from, and skips the raws.  The stages
are ops/sync.py's.  `SearcherGroup` is the search with a leading batch
dimension: rows of one padded length with per-row extents, split over a
list of devices.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..params import Params

from ..device import DeviceLike, resolve
from ..tables import KeyTables, tables_to_device
from .extract import block_raw, db_bands, layout
from .frames import FRAME
from .sync import (HOP, SHIFTS, device_sync_bits, local_mean,
                   pad_channels_first, refine_grid_scores, shift,
                   silence_mask, sync_scores)

# opposite-sign false-positive masking (src/syncfinder.cc:283-332)
MASK_DISTANCE = 23          # local_mean_distance + 3
MASK_FACTOR = 3.0

_BUCKET_FRAMES = 256        # ~5.9 s granularity of the padded length

# the longest stream the search takes whole, as in the JAX package; longer
# BLOCK streams are searched in overlapping tiles of this many frames
# (models/syncfinder._search_fused_tiled)
MAX_FUSED_FRAMES = 16384    # ~6.3 min

# tile halo in start steps: a core start's eligibility needs its local mean
# (+-20), its neighbours' local maxima (+-1) and the opposite-sign mask
# neighbours (+-MASK_DISTANCE, each with their own local mean), so scores
# must be exact for 20 + MASK_DISTANCE + 2 = 45 steps beyond the core; 48
# keeps a margin and is SHIFTS-aligned
TILE_HALO = 48


def bucket_frames(n_frames: int) -> int:
    return max(-(-n_frames // _BUCKET_FRAMES) * _BUCKET_FRAMES,
               _BUCKET_FRAMES)


def top_k_for(T: int, frames_per_block: int) -> int:
    """Candidate slots: enough for every plausible block peak in a T-frame
    chunk (~T/frames_per_block blocks) plus sideband peaks, never below 16."""
    k = max(16, 2 * (T // frames_per_block) + 8)
    return -(-k // 8) * 8


def candidate_eligibility(q: torch.Tensor, mean: torch.Tensor,
                          validb: torch.Tensor):
    """CLI candidate eligibility over a dense start-step score row: local
    maxima with the reference's plateau-alternation semantics
    (src/syncfinder.cc:258-281) minus opposite-sign false positives
    (src/syncfinder.cc:283-332).  Returns (eligible, |q - mean|)."""
    n = q.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=q.device)
    aq = torch.abs(q - mean) * validb.to(q.dtype)

    # local maxima: a selected peak skips its right neighbor; on plateaus
    # of equal values that alternation restarts at each run start
    m = (aq >= shift(aq, -1, 1)) & (aq >= shift(aq, 1, 1)) & validb
    run_start = m & ~shift(m, -1, 1)
    starts = torch.cummax(torch.where(run_start, idx, -1), dim=0).values
    lmax = m & ((idx - starts) % 2 == 0)

    # drop candidates with an opposite-sign neighbor 3x larger within
    # MASK_DISTANCE steps
    sgn_neg = (q - mean) < 0
    MD = MASK_DISTANCE
    masked = torch.zeros(n, dtype=torch.bool, device=q.device)
    for dd in range(1, MD + 1):
        for off in (dd, -dd):
            masked |= (shift(lmax, off, MD)
                       & (shift(sgn_neg, off, MD) != sgn_neg)
                       & (shift(aq, off, MD) > aq * MASK_FACTOR))
    return lmax & ~masked, aq


class SyncSearcher(nn.Module):
    """The search for one key and mode, holding the key's sync layout
    (V, frames), the analysis window and the soft-bit layout as buffers."""

    def __init__(self, tables: KeyTables, clip_mode: bool, device=None):
        super().__init__()
        dev = tables_to_device(tables, device)
        self.clip_mode = clip_mode
        self.fpb_block = tables.frames_per_block
        self.sb = device_sync_bits(tables, clip_mode, device)
        self.total = self.sb.total_frames
        self.register_buffer("awin", dev["analysis_window"])
        self.mix = bool(Params.mix)
        lay_frame, lay_up, lay_dn, self.group = layout(tables, device)
        self.register_buffer("lay_frame", lay_frame)
        self.register_buffer("lay_up", lay_up)
        self.register_buffer("lay_dn", lay_dn)

    def forward(self, x_flat: torch.Tensor, n_channels: int, K: int,
                n_starts: int, n_sample_frames: int, sil_first: int,
                sil_last: int, core_lo: int, core_hi: int,
                extract: bool = True) -> Dict[str, torch.Tensor]:
        """x_flat: (T*FRAME*C,) f32 interleaved, zero-padded to T frames.
        [core_lo, core_hi) restricts ELIGIBILITY (not scoring) to a range
        of start steps: the tiled search scores a halo around its core for
        exact local means and masking but takes candidates only from the
        core; a whole-stream search passes (0, n_starts_s).
        Returns (K,) tensors t (approx start step), q, mean, refined_pos,
        refined_q, eligible, and with `extract` the raws: (K, n_coded) in
        BLOCK mode, or (n_extract, 2, n_coded) consecutive-block pairs for
        the leading quality-ordered slots in CLIP mode."""
        C = n_channels
        dev = x_flat.device
        n_samples = x_flat.shape[0] // C
        T = n_samples // FRAME
        n_taus = SHIFTS * (T - 1)
        n_starts_s = SHIFTS * (T - 1 - self.total)
        x = x_flat.reshape(n_samples, C)

        # ---- hop-256 dB spectrogram, summed over channels ----
        windows = x.T.unfold(1, FRAME, HOP)[:, :n_taus]     # (C, taus, FRAME)
        S = torch.sum(db_bands(windows, self.awin), dim=0)  # (taus, N_BANDS)

        # ---- score sweep: D = V . S^T at each sync frame's offset ----
        have = None
        if self.clip_mode:
            have = silence_mask(torch.arange(n_taus, device=dev) * HOP, C,
                                sil_first, sil_last)
        idx = torch.arange(n_starts_s, device=dev)
        validb = idx < n_starts
        valid = validb.to(torch.float32)
        q = sync_scores(S, self.sb, n_starts_s, have) * valid

        # ---- local mean over the TRUE extent (edge-aware counts) ----
        mean = local_mean(q, valid)

        # ---- eligibility in the core, then the top K slots by |q - mean|;
        # a stable descending sort gives ties to the lower index ----
        elig, aq = candidate_eligibility(q, mean, validb)
        elig = elig & (idx >= core_lo) & (idx < core_hi)
        score = torch.where(elig, aq, torch.full_like(aq, -1.0))
        tops = torch.sort(score, descending=True, stable=True).indices[:K]
        eligible = score[tops] >= 0
        q_top = q[tops]
        mean_top = mean[tops]

        # ---- refine +-256 step 8; a fine position replaces the approx one
        # only when its |q - mean| is strictly larger (the first maximum
        # wins among the fine positions) ----
        pos, fq, valid_g = refine_grid_scores(
            pad_channels_first(x_flat, C), tops * HOP, n_sample_frames,
            self.sb, self.awin,
            (sil_first, sil_last) if self.clip_mode else None)
        aqg = torch.where(valid_g, torch.abs(fq - mean_top[:, None]),
                          torch.full_like(fq, -float("inf")))
        bk = torch.argmax(aqg, dim=1, keepdim=True)
        improve = aqg.gather(1, bk)[:, 0] > torch.abs(q_top - mean_top)
        rpos = torch.where(improve, pos.gather(1, bk)[:, 0], tops * HOP)
        rq = torch.where(improve, fq.gather(1, bk)[:, 0], q_top)
        out = {"t": tops, "q": q_top, "mean": mean_top, "refined_pos": rpos,
               "refined_q": rq, "eligible": eligible}
        if not extract:
            return out

        # ---- raw soft bits at the refined starts; CLIP keeps at most
        # max(n_best, 5) candidates, so only those slots extract ----
        n_extract = min(K, -(-max(Params.get_n_best, 5) // 2) * 2) \
            if self.clip_mode else K
        starts = rpos[:n_extract]
        if self.clip_mode:
            starts = torch.stack([starts, starts + self.fpb_block * FRAME],
                                 dim=1).reshape(-1)
        raws = block_raw(x, starts, self.awin, self.lay_frame, self.lay_up,
                         self.lay_dn, self.fpb_block, self.mix, self.group,
                         Params.frames_per_bit)
        out["raws"] = raws.reshape(n_extract, 2, -1) if self.clip_mode \
            else raws
        return out


# (id(tables), clip_mode, device, Params.mix) -> (tables, searcher); the
# entry holds the tables, so the id stays theirs while it lives
_searchers: Dict[Tuple[int, bool, torch.device, bool],
                 Tuple[KeyTables, SyncSearcher]] = {}


def sync_searcher(tables: KeyTables, clip_mode: bool,
                  device: DeviceLike = None) -> SyncSearcher:
    """The searcher for `tables` and mode on `device`, built once (its
    layout buffers are uploaded once per key, geometry and device)."""
    dev = resolve(device)
    k = (id(tables), bool(clip_mode), dev, bool(Params.mix))
    hit = _searchers.get(k)
    if hit is None:
        hit = (tables, SyncSearcher(tables, clip_mode, dev))
        _searchers[k] = hit
    return hit[1]


class SearcherGroup:
    """The search over a batch of B rows padded to one length, split over
    `devices` in contiguous shares (B divides by their number): the
    counterpart of the JAX package's build_searcher_group.  A device may
    appear more than once (logical shards on one device).  Every row is
    enqueued on its device before anything is read; `fetch` reads back."""

    def __init__(self, tables: KeyTables, clip_mode: bool,
                 devices: Sequence[torch.device]):
        self.devices = list(devices)
        self.searchers = [sync_searcher(tables, clip_mode, d)
                          for d in self.devices]

    def __call__(self, xs: Sequence[torch.Tensor], n_channels: int, K: int,
                 n_starts: Sequence[int], frames: Sequence[int],
                 sil_first: Sequence[int], sil_last: Sequence[int],
                 core_lo: Sequence[int], core_hi: Sequence[int]
                 ) -> List[Dict[str, torch.Tensor]]:
        """xs: B rows (T*FRAME*C,) f32, row i on device i // (B / n_dev),
        with SyncSearcher.forward's scalar arguments per row.  Returns one
        dict per device share, of (B / n_dev, K, ...) tensors (the fields
        of SyncSearcher.forward) on that device."""
        B = len(xs)
        n_dev = len(self.devices)
        if B % n_dev:
            raise ValueError("%d rows do not divide over %d devices"
                             % (B, n_dev))
        per = B // n_dev
        shares = []
        for d, searcher in enumerate(self.searchers):
            rows = [searcher(xs[i], n_channels, K, int(n_starts[i]),
                             int(frames[i]), int(sil_first[i]),
                             int(sil_last[i]), int(core_lo[i]),
                             int(core_hi[i]))
                    for i in range(d * per, (d + 1) * per)]
            shares.append({k: torch.stack([r[k] for r in rows])
                           for k in rows[0]})
        return shares

    @staticmethod
    def fetch(shares: List[Dict[str, torch.Tensor]]
              ) -> Dict[str, np.ndarray]:
        """The shares on the host: a dict of (B, K, ...) numpy arrays."""
        return {k: np.concatenate([s[k].cpu().numpy() for s in shares])
                for k in shares[0]}


def build_searcher_group(tables: KeyTables, clip_mode: bool,
                         devices: Sequence[torch.device]) -> SearcherGroup:
    return SearcherGroup(tables, clip_mode, devices)

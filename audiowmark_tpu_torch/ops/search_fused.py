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
package's for the same input.  Spectra come from an f32 rfft (the JAX
package's dft mode 0).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from audiowmark_tpu.params import Params

from ..device import DeviceLike, resolve
from ..tables import KeyTables, tables_to_device
from .extract import block_raw, db_bands
from .frames import FRAME
from .sync import (HOP, N_BANDS, N_REFINE, SHIFTS, _SPAN, _SUB,
                   normalize_factor)

# opposite-sign false-positive masking (src/syncfinder.cc:283-332)
MASK_DISTANCE = 23          # local_mean_distance + 3
MASK_FACTOR = 3.0
# local mean over +-20 excluding +-3 (src/syncfinder.cc:221-255)
LM_DIST, LM_EXCL = 20, 4

_BUCKET_FRAMES = 256        # ~5.9 s granularity of the padded length

# the longest stream the search takes whole, as in the JAX package; longer
# streams are tiled there (not ported)
MAX_FUSED_FRAMES = 16384    # ~6.3 min

# candidates refined per pass: each builds (J*C, 65, FRAME) f32 windows,
# ~271 MB at J=510, C=2
_REFINE_BATCH = 4


def bucket_frames(n_frames: int) -> int:
    return max(-(-n_frames // _BUCKET_FRAMES) * _BUCKET_FRAMES,
               _BUCKET_FRAMES)


def top_k_for(T: int, frames_per_block: int) -> int:
    """Candidate slots: enough for every plausible block peak in a T-frame
    chunk (~T/frames_per_block blocks) plus sideband peaks, never below 16."""
    k = max(16, 2 * (T // frames_per_block) + 8)
    return -(-k // 8) * 8


def _shift(arr: torch.Tensor, off: int, pad: int) -> torch.Tensor:
    """arr[i + off] for i in [0, n), zero (False) outside; |off| <= pad."""
    n = arr.shape[0]
    z = arr.new_zeros(pad)
    return torch.cat([z, arr, z])[pad + off: pad + off + n]


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
    m = (aq >= _shift(aq, -1, 1)) & (aq >= _shift(aq, 1, 1)) & validb
    run_start = m & ~_shift(m, -1, 1)
    starts = torch.cummax(torch.where(run_start, idx, -1), dim=0).values
    lmax = m & ((idx - starts) % 2 == 0)

    # drop candidates with an opposite-sign neighbor 3x larger within
    # MASK_DISTANCE steps
    sgn_neg = (q - mean) < 0
    MD = MASK_DISTANCE
    masked = torch.zeros(n, dtype=torch.bool, device=q.device)
    for dd in range(1, MD + 1):
        for off in (dd, -dd):
            masked |= (_shift(lmax, off, MD)
                       & (_shift(sgn_neg, off, MD) != sgn_neg)
                       & (_shift(aq, off, MD) > aq * MASK_FACTOR))
    return lmax & ~masked, aq


class SyncSearcher(nn.Module):
    """The search for one key and mode, holding the key's sync layout
    (V, frames), the analysis window and the soft-bit layout as buffers."""

    def __init__(self, tables: KeyTables, clip_mode: bool, device=None):
        super().__init__()
        dev = tables_to_device(tables, device)
        mode = "clip" if clip_mode else "block"
        self.clip_mode = clip_mode
        self.fpb_block = tables.frames_per_block
        self.n_pos = dev["sync_frame_" + mode].shape[1]
        self.total = self.fpb_block * (2 if clip_mode else 1)
        self.register_buffer("v", dev["sync_v_" + mode])   # (2J, N_BANDS)
        self.register_buffer(
            "frames", dev["sync_frame_" + mode].reshape(-1).to(torch.int64))
        self.max_offset = SHIFTS * int(self.frames.max())
        self.register_buffer("awin", dev["analysis_window"])
        self.mix = bool(Params.mix)
        if self.mix:
            lay_frame = dev["mix_frame"]
            lay_up = dev["mix_up"] - Params.min_band
            lay_dn = dev["mix_dn"] - Params.min_band
            self.group = Params.bands_per_frame * Params.frames_per_bit
        else:
            lay_frame = dev["pos_vec"][tables.n_sync_frames:]
            lay_up = dev["data_up"] - Params.min_band
            lay_dn = dev["data_dn"] - Params.min_band
            self.group = 0
        self.register_buffer("lay_frame", lay_frame.to(torch.int64))
        self.register_buffer("lay_up", lay_up.to(torch.int64))
        self.register_buffer("lay_dn", lay_dn.to(torch.int64))
        self.register_buffer("expect", (torch.arange(Params.sync_bits) & 1)
                             .to(torch.float32).to(self.v.device))

    def _bitq(self, u, d, cnt=None):
        """Per-bit quality, plain mean (cnt None: BLOCK sweep) or count-
        weighted (CLIP sweep, refine)."""
        raw = torch.where((u == 0) | (d == 0), torch.zeros_like(u),
                          torch.where(u < d, 1.0 - u / d, d / u - 1.0))
        q = torch.where(self.expect > 0, raw, -raw)
        norm = normalize_factor()
        if cnt is None:
            return torch.mean(q, dim=-1) * norm
        tc = torch.sum(cnt, dim=-1)
        return torch.where(tc > 0,
                           torch.sum(q * cnt, dim=-1) / torch.clamp_min(tc, 1),
                           torch.zeros_like(tc)) * norm

    def _silence_mask(self, w_start: torch.Tensor, C: int, sil_first: int,
                      sil_last: int) -> torch.Tensor:
        """1.0 where the window at per-channel sample w_start overlaps the
        non-silent raw interleaved range (src/syncfinder.cc:583-585)."""
        f_first = w_start * C
        f_last = (w_start + FRAME) * C
        return (~((f_last < sil_first) | (f_first > sil_last))).to(
            torch.float32)

    def forward(self, x_flat: torch.Tensor, n_channels: int, K: int,
                n_starts: int, n_sample_frames: int, sil_first: int,
                sil_last: int) -> Dict[str, torch.Tensor]:
        """x_flat: (T*FRAME*C,) f32 interleaved, zero-padded to T frames.
        Returns (K,) tensors t (approx start step), q, mean, refined_pos,
        refined_q, eligible, and raws: (K, n_coded) in BLOCK mode, or
        (n_extract, 2, n_coded) consecutive-block pairs for the leading
        quality-ordered slots in CLIP mode."""
        C = n_channels
        dev = x_flat.device
        n_samples = x_flat.shape[0] // C
        T = n_samples // FRAME
        n_taus = SHIFTS * (T - 1)
        n_starts_s = SHIFTS * (T - 1 - self.total)
        x = x_flat.reshape(n_samples, C)
        xt = x.T                                            # (C, n)

        # ---- hop-256 dB spectrogram, summed over channels ----
        windows = xt.unfold(1, FRAME, HOP)[:, :n_taus]      # (C, taus, FRAME)
        S = torch.sum(db_bands(windows, self.awin), dim=0)  # (taus, N_BANDS)

        # ---- score sweep: D = V . S^T at each sync frame's offset ----
        offsets = SHIFTS * self.frames                      # (J,)
        need = self.max_offset + n_starts_s
        S_pad = torch.cat([S, S.new_zeros(max(need - n_taus, 0), N_BANDS)])
        Dt = torch.matmul(self.v, S_pad.T)                  # (2J, need)
        rows = offsets[:, None] + torch.arange(n_starts_s, device=dev)
        J = offsets.shape[0]
        if self.clip_mode:
            taus = torch.arange(n_taus, device=dev)
            have = self._silence_mask(taus * HOP, C, sil_first, sil_last)
            have_pad = torch.cat([have, have.new_zeros(need - n_taus)]) \
                if need > n_taus else have
            Dt = Dt * have_pad[None, :]

        def per_bit(a):                                     # (J, n) -> (n, 6)
            return torch.sum(a.reshape(Params.sync_bits, self.n_pos, -1),
                             dim=1).T

        u = per_bit(torch.gather(Dt[0::2], 1, rows))
        d = per_bit(torch.gather(Dt[1::2], 1, rows))
        if self.clip_mode:
            cnt = per_bit(have_pad[rows])
            q = self._bitq(u, d, cnt)
        else:
            q = self._bitq(u, d)

        idx = torch.arange(n_starts_s, device=dev)
        validb = idx < n_starts
        valid = validb.to(torch.float32)
        q = q * valid

        # ---- local mean over the TRUE extent (edge-aware counts) ----
        tot = torch.zeros_like(q)
        cnt_lm = torch.zeros_like(q)
        for j in (list(range(-LM_DIST, -LM_EXCL + 1))
                  + list(range(LM_EXCL, LM_DIST + 1))):
            tot = tot + _shift(q, j, LM_DIST)
            cnt_lm = cnt_lm + _shift(valid, j, LM_DIST)
        mean = torch.where(cnt_lm > 0, tot / torch.clamp_min(cnt_lm, 1.0),
                           torch.zeros_like(tot)) * valid

        # ---- eligibility, then the top K slots by |q - mean|; a stable
        # descending sort gives ties to the lower index ----
        elig, aq = candidate_eligibility(q, mean, validb)
        score = torch.where(elig, aq, torch.full_like(aq, -1.0))
        tops = torch.sort(score, descending=True, stable=True).indices[:K]
        eligible = score[tops] >= 0
        q_top = q[tops]
        mean_top = mean[tops]

        rpos, rq = self._refine(xt, tops, q_top, mean_top, n_sample_frames,
                                C, sil_first, sil_last)
        out = {"t": tops, "q": q_top, "mean": mean_top, "refined_pos": rpos,
               "refined_q": rq, "eligible": eligible}

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

    def _refine(self, xt, tops, q_top, mean_top, n_sample_frames, C,
                sil_first, sil_last):
        """+-256 step 8 around each slot; a fine position replaces the approx
        one only when its |q - mean| is strictly larger (first maximum
        wins among the fine positions)."""
        dev = xt.device
        step = Params.sync_search_step
        fine = Params.sync_search_fine
        J = self.frames.shape[0]
        xpadT = torch.cat([xt, xt.new_zeros(C, _SPAN)], dim=1)
        span_ar = torch.arange(_SPAN, device=dev)
        grid = fine * torch.arange(N_REFINE, device=dev)
        rpos, rq = [], []
        for k0 in range(0, tops.shape[0], _REFINE_BATCH):
            t = tops[k0:k0 + _REFINE_BATCH]
            qa = q_top[k0:k0 + _REFINE_BATCH]
            mn = mean_top[k0:k0 + _REFINE_BATCH]
            base = t * HOP
            gstart = torch.clamp_min(base - step, 0)
            pos = gstart[:, None] + grid                        # (k, 65)
            valid_g = ((pos <= (base + step)[:, None])
                       & (pos + self.total * FRAME <= n_sample_frames))
            span_starts = torch.clamp(
                gstart[:, None] + self.frames * FRAME, 0,
                xpadT.shape[1] - _SPAN)                         # (k, J)
            spans = xpadT[:, span_starts[..., None] + span_ar]  # (C,k,J,SPAN)
            W = spans.permute(1, 2, 0, 3).unfold(-1, FRAME, _SUB)
            fdb = torch.sum(db_bands(W, self.awin), dim=2)      # (k,J,65,NB)
            u = torch.einsum("kjpb,jb->kpj", fdb, self.v[0::2])
            dn = torch.einsum("kjpb,jb->kpj", fdb, self.v[1::2])
            hv = valid_g.to(torch.float32)[:, :, None].expand(-1, -1, J)
            if self.clip_mode:
                w_start = pos[:, :, None] + self.frames * FRAME
                hv = hv * self._silence_mask(w_start, C, sil_first, sil_last)
            shape = (t.shape[0], N_REFINE, Params.sync_bits, self.n_pos)
            fq = self._bitq(torch.sum((u * hv).reshape(shape), dim=3),
                            torch.sum((dn * hv).reshape(shape), dim=3),
                            torch.sum(hv.reshape(shape), dim=3))
            aqg = torch.where(valid_g, torch.abs(fq - mn[:, None]),
                              torch.full_like(fq, -float("inf")))
            bk = torch.argmax(aqg, dim=1, keepdim=True)
            improve = aqg.gather(1, bk)[:, 0] > torch.abs(qa - mn)
            rpos.append(torch.where(improve, pos.gather(1, bk)[:, 0], base))
            rq.append(torch.where(improve, fq.gather(1, bk)[:, 0], qa))
        return torch.cat(rpos), torch.cat(rq)


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

"""Sync search stages: the keyed sync-bit layout, the hop-256 dB
spectrogram, the sync-score sweep, the local mean and the fine refinement.

Port of audiowmark_tpu/ops/sync.py.  The search scores every start on a
hop-256 dB spectrogram S (tau, band) through a 0/1 band-selection matrix V
(2 rows per sync frame: up and down), D = V . S^T (reference:
src/syncfinder.cc).  The staged search (models/syncfinder.search_staged)
calls these stages one by one; the fused search (ops/search_fused.py)
chains the same ones on the device.  Spectra come from an f32 rfft (the
JAX package's dft mode 0).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..params import Params

from ..device import DeviceLike
from ..tables import KeyTables, tables_to_device
from .extract import db_bands
from .frames import FRAME, analysis_window

N_BANDS = Params.max_band - Params.min_band + 1
HOP = Params.sync_search_step  # 256
SHIFTS = FRAME // HOP          # 4

# refinement grid: +-sync_search_step in steps of sync_search_fine
N_REFINE = 2 * (Params.sync_search_step // Params.sync_search_fine) + 1  # 65
_SPAN = Params.sync_search_fine * (N_REFINE - 1) + FRAME                 # 1536
_SUB = Params.sync_search_fine                                           # 8

# spectrogram rows per pass: bounds the (C, rows, FRAME) window stack
_SPEC_TILE = 16384
# start steps per sweep pass: bounds the (J, starts) gather
_SWEEP_TILE = 16384
# candidates refined per pass: each builds (J*C, 65, FRAME) f32 windows,
# ~271 MB at J=510, C=2
_REFINE_BATCH = 4


@dataclass
class SyncBits:
    """Dense sync-bit layout, bit-major ordering.

    n_pos sync-frame positions per bit (85 in BLOCK mode, 170 in CLIP mode,
    where the second block swaps up and down).  For j = (bit, k):
      frame[bit, k]  — block-frame position
      v[2j], v[2j+1] — (N_BANDS,) 0/1 up / down band-selection rows
    """
    frame: np.ndarray        # (6, n_pos) int32
    v: np.ndarray            # (2*6*n_pos, N_BANDS) float32; row 2j=up, 2j+1=dn
    n_pos: int
    total_frames: int        # frames per (long) block


def build_sync_bits(tables: KeyTables, clip_mode: bool) -> SyncBits:
    """Mirror of SyncFinder::get_sync_bits (src/syncfinder.cc:30-77)."""
    sfb = Params.sync_frames_per_bit
    n_blocks = 2 if clip_mode else 1
    fpb = tables.frames_per_block
    n_pos = sfb * n_blocks

    frames = np.zeros((Params.sync_bits, n_pos), dtype=np.int32)
    v = np.zeros((2 * Params.sync_bits * n_pos, N_BANDS), dtype=np.float32)

    for bit in range(Params.sync_bits):
        entries = []
        for f in range(sfb):
            fidx = bit * sfb + f
            up = tables.sync_up[fidx] - Params.min_band
            dn = tables.sync_dn[fidx] - Params.min_band
            pos = int(tables.pos_vec[fidx])
            entries.append((pos, up, dn))
            if clip_mode:
                entries.append((pos + fpb, dn, up))   # B-after-A swaps up/down
        entries.sort(key=lambda e: e[0])
        for k, (pos, up, dn) in enumerate(entries):
            frames[bit, k] = pos
            j = bit * n_pos + k
            v[2 * j, up] = 1.0
            v[2 * j + 1, dn] = 1.0

    return SyncBits(frame=frames, v=v, n_pos=n_pos,
                    total_frames=fpb * n_blocks)


@dataclass
class DeviceSyncBits:
    """One key's sync layout for one mode on a device: V (2J, N_BANDS),
    the sync frames (J,) int64 in bit-major order, and their host extent."""
    v: torch.Tensor
    frames: torch.Tensor
    n_pos: int
    total_frames: int
    max_frame: int


def device_sync_bits(tables: KeyTables, clip_mode: bool,
                     device: DeviceLike = None) -> DeviceSyncBits:
    """The layout from tables_to_device (uploaded once per key, geometry
    and device)."""
    dev = tables_to_device(tables, device)
    mode = "clip" if clip_mode else "block"
    frame = dev["sync_frame_" + mode]
    fpb = tables.frames_per_block
    return DeviceSyncBits(
        v=dev["sync_v_" + mode], frames=frame.reshape(-1).to(torch.int64),
        n_pos=frame.shape[1], total_frames=fpb * (2 if clip_mode else 1),
        max_frame=int(tables.pos_vec[:tables.n_sync_frames].max())
        + (fpb if clip_mode else 0))


def normalize_factor() -> float:
    """raw / min(water_delta, 0.08) / 2.9 — src/syncfinder.cc:79-91."""
    return 1.0 / (min(Params.water_delta, 0.080) * 2.9)


def bit_quality(u: torch.Tensor, d: torch.Tensor,
                cnt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quality from per-bit up/down sums (..., 6): the plain mean over the
    bits (cnt None: every sync frame weighs in) or the count-weighted mean
    (cnt: sync frames present per bit)."""
    expect = (torch.arange(Params.sync_bits, device=u.device) & 1) > 0
    raw = torch.where((u == 0) | (d == 0), torch.zeros_like(u),
                      torch.where(u < d, 1.0 - u / d, d / u - 1.0))
    q = torch.where(expect, raw, -raw)
    norm = normalize_factor()
    if cnt is None:
        return torch.mean(q, dim=-1) * norm
    tc = torch.sum(cnt, dim=-1)
    return torch.where(tc > 0,
                       torch.sum(q * cnt, dim=-1) / torch.clamp_min(tc, 1),
                       torch.zeros_like(tc)) * norm


def silence_mask(w_start: torch.Tensor, n_channels: int, sil_first: int,
                 sil_last: int) -> torch.Tensor:
    """1.0 where the window at per-channel sample w_start overlaps the
    non-silent raw interleaved range [sil_first, sil_last]
    (src/syncfinder.cc:583-585)."""
    f_first = w_start * n_channels
    f_last = (w_start + FRAME) * n_channels
    return (~((f_last < sil_first) | (f_first > sil_last))).to(torch.float32)


def shift(arr: torch.Tensor, off: int, pad: int) -> torch.Tensor:
    """arr[i + off] for i in [0, n), zero (False) outside; |off| <= pad."""
    n = arr.shape[0]
    z = arr.new_zeros(pad)
    return torch.cat([z, arr, z])[pad + off: pad + off + n]


# ---- spectrogram -------------------------------------------------------------

def hop_spectrogram(x: torch.Tensor, n_channels: int,
                    silence_bounds: Optional[Tuple[int, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hop-256 dB spectrogram of x ((n*C,) f32 interleaved on the device),
    summed over channels.

    Returns (S (n_taus, N_BANDS), have (n_taus,) f32 0/1), both on x's
    device.  Row tau covers samples [tau*HOP, tau*HOP + FRAME); n_taus =
    4*(F-1) with F the whole-frame count, the reference's per-shift F-1
    frames.  silence_bounds (first, last) are raw interleaved sample-value
    indices for CLIP-mode silence skipping: `have` is silence_mask of each
    row (all ones without bounds); the sweep weighs the rows by it, so
    every row is computed."""
    n = x.shape[0] // n_channels
    F = n // FRAME
    n_taus = max(SHIFTS * (F - 1), 0)
    have = x.new_ones(n_taus)
    if silence_bounds is not None:
        have = silence_mask(torch.arange(n_taus, device=x.device) * HOP,
                            n_channels, *silence_bounds)
    if n_taus == 0:
        return x.new_zeros((0, N_BANDS)), have

    awin = torch.from_numpy(analysis_window()).to(x.device)
    windows = x.reshape(n, n_channels).T.unfold(1, FRAME, HOP)
    S = torch.cat([torch.sum(db_bands(windows[:, t0:min(t0 + _SPEC_TILE,
                                                         n_taus)], awin),
                             dim=0)
                   for t0 in range(0, n_taus, _SPEC_TILE)])
    return S, have


# ---- sync score sweep --------------------------------------------------------

def sync_scores(S: torch.Tensor, sb: DeviceSyncBits, n_starts: int,
                have: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quality of start taus [0, n_starts) from the spectrogram rows S:
    for each sync frame j, D = V . S^T at row tau + 4*frame[j], summed per
    bit.  have None: every row present, the plain per-bit mean; have
    (rows,) f32: rows weighted by it, the count-weighted mean.  Rows past
    S's end read zero."""
    n_taus = S.shape[0]
    need = SHIFTS * sb.max_frame + n_starts
    if need > n_taus:
        S = torch.cat([S, S.new_zeros(need - n_taus, N_BANDS)])
        if have is not None:
            have = torch.cat([have, have.new_zeros(need - n_taus)])
    Dt = torch.matmul(sb.v, S.T)                        # (2J, need)
    if have is not None:
        Dt = Dt * have[None, :]
    offsets = SHIFTS * sb.frames                        # (J,)

    def per_bit(a):                                     # (J, n) -> (n, 6)
        return torch.sum(a.reshape(Params.sync_bits, sb.n_pos, -1), dim=1).T

    out = []
    for t0 in range(0, n_starts, _SWEEP_TILE):
        rows = offsets[:, None] + torch.arange(
            t0, min(t0 + _SWEEP_TILE, n_starts), device=S.device)
        u = per_bit(torch.gather(Dt[0::2], 1, rows))
        d = per_bit(torch.gather(Dt[1::2], 1, rows))
        cnt = None if have is None else per_bit(have[rows])
        out.append(bit_quality(u, d, cnt))
    return torch.cat(out) if out else S.new_zeros(0)


def sync_score_sweep(S: torch.Tensor, have: torch.Tensor,
                     sb: DeviceSyncBits) -> torch.Tensor:
    """Quality for every valid start tau of a whole-stream spectrogram;
    (n_starts,) f32 on S's device; have: hop_spectrogram's row mask.
    Start tau t is sample t*HOP; the valid range is the reference's
    per-shift bound start_frame <= F-2-total.  With no silence (every
    `have`) the counts cancel and the plain per-bit mean is used, as in
    the JAX package."""
    F = S.shape[0] // SHIFTS + 1
    n_starts = SHIFTS * (F - 1 - sb.total_frames)
    if n_starts <= 0:
        return S.new_zeros(0)
    return sync_scores(S, sb, n_starts,
                       None if bool(torch.all(have > 0)) else have)


def local_mean(scores: torch.Tensor, valid: Optional[torch.Tensor] = None,
               distance: int = 20, exclude: int = 4) -> torch.Tensor:
    """Local mean over neighbours j in [-distance,-exclude]U[exclude,
    distance], counting only neighbours inside the scores
    (src/syncfinder.cc:234-254).  valid (same shape, 0/1): the true extent
    of a padded row; neighbours outside it are not counted and the mean is
    0 there (scores must already be 0 outside it)."""
    if valid is None:
        valid = torch.ones_like(scores)
    tot = torch.zeros_like(scores)
    cnt = torch.zeros_like(scores)
    for j in (list(range(-distance, -exclude + 1))
              + list(range(exclude, distance + 1))):
        tot = tot + shift(scores, j, distance)
        cnt = cnt + shift(valid, j, distance)
    return torch.where(cnt > 0, tot / torch.clamp_min(cnt, 1.0),
                       torch.zeros_like(tot)) * valid


# ---- refinement --------------------------------------------------------------

def refine_grid_scores(xpadT: torch.Tensor, bases: torch.Tensor,
                 n_sample_frames: int, sb: DeviceSyncBits, awin: torch.Tensor,
                 silence_bounds: Optional[Tuple[int, int]] = None,
                 batch: int = _REFINE_BATCH):
    """Qualities on the reference's fine grid around each candidate start:
    positions start, start+fine, ... with start = max(base - step, 0), up
    to base + step (src/syncfinder.cc:427-442), in passes of `batch`
    candidates.

    xpadT: (C, n + _SPAN) channels-first samples with _SPAN zeros after
    them; bases: (K,) int64 sample indices.  Returns positions (K, 65),
    qualities (K, 65) and valid (K, 65): inside the grid and not reading
    past n_sample_frames."""
    dev = xpadT.device
    C = xpadT.shape[0]
    step = Params.sync_search_step
    fine = Params.sync_search_fine
    J = sb.frames.shape[0]
    span_ar = torch.arange(_SPAN, device=dev)
    gstart = torch.clamp_min(bases - step, 0)
    pos = gstart[:, None] + fine * torch.arange(N_REFINE, device=dev)
    valid = ((pos <= (bases + step)[:, None])
             & (pos + sb.total_frames * FRAME <= n_sample_frames))
    quals = []
    for k0 in range(0, bases.shape[0], batch):
        k1 = k0 + batch
        span_starts = torch.clamp(
            gstart[k0:k1, None] + sb.frames * FRAME, 0,
            xpadT.shape[1] - _SPAN)                         # (k, J)
        spans = xpadT[:, span_starts[..., None] + span_ar]  # (C,k,J,SPAN)
        W = spans.permute(1, 2, 0, 3).unfold(-1, FRAME, _SUB)
        fdb = torch.sum(db_bands(W, awin), dim=2)           # (k,J,65,NB)
        u = torch.einsum("kjpb,jb->kpj", fdb, sb.v[0::2])
        dn = torch.einsum("kjpb,jb->kpj", fdb, sb.v[1::2])
        hv = valid[k0:k1].to(torch.float32)[:, :, None].expand(-1, -1, J)
        if silence_bounds is not None:
            hv = hv * silence_mask(pos[k0:k1, :, None] + sb.frames * FRAME,
                                   C, *silence_bounds)
        shape = (u.shape[0], N_REFINE, Params.sync_bits, sb.n_pos)
        quals.append(bit_quality(torch.sum((u * hv).reshape(shape), dim=3),
                                 torch.sum((dn * hv).reshape(shape), dim=3),
                                 torch.sum(hv.reshape(shape), dim=3)))
    return pos, torch.cat(quals), valid


def pad_channels_first(x: torch.Tensor, n_channels: int) -> torch.Tensor:
    """(n*C,) interleaved -> (C, n + _SPAN) with _SPAN zeros appended."""
    xt = x.reshape(-1, n_channels).T
    return torch.cat([xt, xt.new_zeros(n_channels, _SPAN)], dim=1)


def refine_grid(x: torch.Tensor, n_channels: int, bases: np.ndarray,
                sb: DeviceSyncBits,
                silence_bounds: Optional[Tuple[int, int]] = None):
    """Refinement qualities for candidate starts `bases` over the fine grid
    (see refine_grid_scores) of x ((n*C,) f32 on the device).  Returns
    (positions (K, N_REFINE) int64, quals (K, N_REFINE) float32) on the
    host; invalid slots (past the grid end or reading past the end) are
    NaN."""
    K = bases.size
    if K == 0:
        return (np.zeros((0, N_REFINE), np.int64),
                np.zeros((0, N_REFINE), np.float32))
    awin = torch.from_numpy(analysis_window()).to(x.device)
    pos, quals, valid = refine_grid_scores(
        pad_channels_first(x, n_channels),
        torch.from_numpy(bases.astype(np.int64)).to(x.device),
        x.shape[0] // n_channels, sb, awin, silence_bounds)
    quals = torch.where(valid, quals, torch.full_like(quals, float("nan")))
    return pos.cpu().numpy(), quals.cpu().numpy()

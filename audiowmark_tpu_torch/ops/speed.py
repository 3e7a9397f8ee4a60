"""Speed search on the device: half-rate sync mag matrices and the
(speed x offset) comparison grid.

Port of audiowmark_tpu/ops/speed.py (the staged pair `prepare_mag_matrix`
+ `compare_speed_batch`) and of the whole-scan shape of
audiowmark_tpu/ops/speed_fused.py (`speed_scan`).  Reference behaviour
(src/wmspeed.cc:204-382): for each candidate centre speed the audio clip
is resampled by centre/2, a 512-point hop-128 dB spectrogram is reduced to
per-sync-entry (up, down) band sums (the mag matrix), and each relative
speed is scored by scanning all block offsets in 16.16 fixed point across
3 consecutive blocks.

On the device: the spectrogram is an f32 rfft, the band sums one matmul
against the sync band-selection matrix, and the offset scan of a batch of
relative speeds a gather plus a one-hot segment sum (a matmul) over
(states x entries).  The 16.16 offsets are built on the host in float64 and
int64, letter for letter as the reference rounds them, and added and
shifted as int64 on the device.

`speed_scan` uploads the clip once per device, splits the centres over the
cards (`scan_device_count`), keeps every centre's mag matrix on its device
and brings back only the (centres x rels) quality grid; it drops the
(block, entry) pairs that no state can reach in this scan's clip (the
reference's have_mag == 0 rows), which changes no value.

Spans (utils/prof.py): `speed.prepare` (a share's clip upload and each
centre's mag matrix) and `speed.compare` (each centre's offset scan, and
the read of the grid); counters `speed.scans` (calls of `speed_scan`) and
`speed.centres` (mag matrices built).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, card_count, resolve, spread
from ..params import Params
from ..tables import KeyTables
from ..utils import prof
from .resample import resample_frames

SUB_FRAME = Params.frame_size // 2          # 512
SUB_HOP = Params.sync_search_step // 2      # 128
N_BANDS = Params.max_band - Params.min_band + 1
OFFSET_SHIFT = 16
N_BLOCKS = 3                                # blocks one offset scan covers
_LOG2_DB = 3.01029995663981
# (rels x states x entries) elements of one compare pass: bounds its
# temporaries (an int64 index, an f32 pair and three f32 planes per
# element, ~1 GB at this size)
_WORKSPACE = 1 << 24


@lru_cache(maxsize=None)
def _sub_window() -> np.ndarray:
    """Sum-normalized Hann window of length 512 (gen_normalized_window)."""
    n = SUB_FRAME
    i = np.arange(n, dtype=np.float64)
    x = (i - n / 2.0) / (n / 2.0)
    win = np.where(np.abs(x) > 1, 0.0, 0.5 * np.cos(x * np.pi) + 0.5)
    win *= 2.0 / win.sum()
    return win.astype(np.float32)


@dataclass
class SpeedSyncBits:
    """Sync entries sorted by frame (across bits), BLOCK mode."""
    frame: np.ndarray     # (J,) int32, J = sync_bits * sync_frames_per_bit
    bit: np.ndarray       # (J,) int32
    v: np.ndarray         # (2J, N_BANDS): row 2j up, 2j+1 down
    frames_per_block: int


def build_speed_sync_bits(tables: KeyTables) -> SpeedSyncBits:
    sfb = Params.sync_frames_per_bit
    entries = []
    for bit in range(Params.sync_bits):
        for f in range(sfb):
            fidx = bit * sfb + f
            entries.append((int(tables.pos_vec[fidx]), bit,
                            tables.sync_up[fidx] - Params.min_band,
                            tables.sync_dn[fidx] - Params.min_band))
    entries.sort(key=lambda e: e[0])
    J = len(entries)
    frame = np.array([e[0] for e in entries], dtype=np.int32)
    bit = np.array([e[1] for e in entries], dtype=np.int32)
    v = np.zeros((2 * J, N_BANDS), dtype=np.float32)
    for j, (_, _, up, dn) in enumerate(entries):
        v[2 * j, up] = 1.0
        v[2 * j + 1, dn] = 1.0
    return SpeedSyncBits(frame=frame, bit=bit, v=v,
                         frames_per_block=tables.frames_per_block)


# ---- the mag matrix ----------------------------------------------------------

def mag_matrix_core(windows: torch.Tensor, win: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """(rows, C, SUB_FRAME) frames -> (rows, 2J) up/down band sums of the
    channels' dB spectra."""
    spec = torch.fft.rfft(windows * win, dim=-1)
    spec = spec[:, :, Params.min_band:Params.max_band + 1]
    abs2 = spec.real ** 2 + spec.imag ** 2
    db = torch.where(abs2 > 0, torch.log2(abs2) * _LOG2_DB,
                     torch.full_like(abs2, -96.0))
    return db.sum(dim=1) @ v.T


def mag_rows(n_frames: int) -> int:
    """Rows of the mag matrix of `n_frames` half-rate frames: one per
    window start pos = 0, SUB_HOP, ... with pos + SUB_FRAME < n_frames."""
    return (n_frames - SUB_FRAME - 1) // SUB_HOP + 1 \
        if n_frames > SUB_FRAME else 0


def _scan_in_frames(clip_frames: int, center: float,
                    scan_seconds: float) -> int:
    """Input frames one centre reads: scan_seconds / centre of the clip."""
    return min(clip_frames, int(round(Params.mark_sample_rate
                                      * scan_seconds / center)))


def _center_mag_matrix(x: torch.Tensor, center: float, scan_seconds: float,
                       win: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The (rows, 2J) mag matrix of clip x ((frames, C) on the device) at
    one centre speed: truncate, resample by centre/2, window, reduce."""
    sub = resample_frames(
        x[:_scan_in_frames(x.shape[0], center, scan_seconds)], center / 2)
    rows = mag_rows(sub.shape[0])
    if rows <= 0:
        return torch.zeros((0, v.shape[0]), dtype=torch.float32,
                           device=x.device)
    # (C, n) -> (C, windows, SUB_FRAME) -> (rows, C, SUB_FRAME)
    windows = sub.T.unfold(1, SUB_FRAME, SUB_HOP)[:, :rows].transpose(0, 1)
    return mag_matrix_core(windows, win, v)


def _upload_clip(clip_samples: np.ndarray, n_channels: int,
                 dev: torch.device) -> torch.Tensor:
    x = np.asarray(clip_samples, dtype=np.float32).reshape(-1, n_channels)
    return torch.from_numpy(x).to(dev)


def prepare_mag_matrix(clip_samples: np.ndarray, n_channels: int,
                       center: float, scan_seconds: float,
                       sync_bits: SpeedSyncBits,
                       device: DeviceLike = None) -> np.ndarray:
    """Resample the clip by centre/2 (truncated to scan_seconds/centre of
    input) and reduce it to the (rows, 2J) sync mag matrix
    (reference: src/wmspeed.cc:204-268)."""
    dev = resolve(device)
    prof.count("speed.centres")
    D = _center_mag_matrix(
        _upload_clip(clip_samples, n_channels, dev), center, scan_seconds,
        torch.from_numpy(_sub_window()).to(dev),
        torch.from_numpy(sync_bits.v).to(dev))
    return D.cpu().numpy()


# ---- the offset scan ---------------------------------------------------------

def offset_tables(rels: Sequence[float], sync_bits: SpeedSyncBits
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's 16.16 fixed-point offsets (src/wmspeed.cc:270-382),
    in float64 and int64 on the host:
      state_off[r, s] = trunc(offset_s * ((1<<16) / rel_r))
      frame_off[r, b*J + j] = trunc(((b*fpb + frame_j) * 4 / rel_r + 0.5)
                                    * (1<<16))
    for offsets -pad_start..-1; (R, states) and (R, 3J) int64."""
    J = sync_bits.frame.size
    steps_per_frame = Params.frame_size // Params.sync_search_step
    pad_start = sync_bits.frames_per_block * steps_per_frame + steps_per_frame

    frames = sync_bits.frame.astype(np.float64)
    f_off_all = np.empty((len(rels), N_BLOCKS * J), dtype=np.int64)
    for i, rel in enumerate(rels):
        inv = 1.0 / rel
        for block in range(N_BLOCKS):
            val = ((block * sync_bits.frames_per_block + frames)
                   * steps_per_frame * inv + 0.5) * (1 << OFFSET_SHIFT)
            f_off_all[i, block * J:(block + 1) * J] = np.trunc(val)

    offs = np.arange(-pad_start, 0, dtype=np.float64)
    state_off_all = np.stack([
        np.trunc(offs * ((1 << OFFSET_SHIFT) / rel)).astype(np.int64)
        for rel in rels])
    return state_off_all, f_off_all


def row_index(state_off: torch.Tensor, frame_off: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mag-matrix row of every (state, entry) pair, and whether its raw
    16.16 position is non-negative: (..., states) and (..., entries) int64
    -> (..., states, entries) int64 and bool."""
    raw = state_off.unsqueeze(-1) + frame_off.unsqueeze(-2)
    return raw >> OFFSET_SHIFT, raw >= 0


@dataclass
class _CompareTables:
    """What the offset scan of one batch of relative speeds reads, on the
    device: the offsets, and per kept entry its mag-matrix column, whether
    it lies in the second block (whose up/down swap) and its sync bit."""
    state_off: torch.Tensor     # (R, states) int64
    frame_off: torch.Tensor     # (R, Jk) int64
    cols: torch.Tensor          # (Jk,) int64
    swap: torch.Tensor          # (Jk,) bool
    bit_onehot: torch.Tensor    # (Jk, sync_bits) f32


def _compare_tables(rels: Sequence[float], sync_bits: SpeedSyncBits,
                    max_rows, dev: torch.device) -> _CompareTables:
    """The tables of `rels`; with `max_rows` given, only the (block, entry)
    pairs that some state can bring inside a mag matrix of that many rows
    at some rel.  The others are masked at every state, so dropping them
    changes no sum."""
    state_off, frame_off = offset_tables(rels, sync_bits)
    J = sync_bits.frame.size
    kept = np.arange(N_BLOCKS * J)
    if max_rows is not None:
        s_hi = state_off >> OFFSET_SHIFT        # rises with the state
        f_hi = frame_off >> OFFSET_SHIFT
        keep = ((f_hi + s_hi[:, -1:] + 1 >= 0)
                & (f_hi + s_hi[:, :1] < max_rows)).any(axis=0)
        kept = np.nonzero(keep)[0]
    onehot = np.zeros((kept.size, Params.sync_bits), dtype=np.float32)
    onehot[np.arange(kept.size), np.tile(sync_bits.bit, N_BLOCKS)[kept]] = 1.0
    return _CompareTables(
        state_off=torch.from_numpy(state_off).to(dev),
        frame_off=torch.from_numpy(
            np.ascontiguousarray(frame_off[:, kept])).to(dev),
        cols=torch.from_numpy(kept % J).to(dev),
        swap=torch.from_numpy(kept // J == 1).to(dev),
        bit_onehot=torch.from_numpy(onehot).to(dev))


def compare_speed_core(D: torch.Tensor, t: _CompareTables) -> torch.Tensor:
    """Best |quality| over the states for each relative speed of `t`:
    D (rows, 2J) f32 -> (R,) f32.  The rels go through in batches whose
    (rels x states x entries) temporaries stay within _WORKSPACE."""
    rows, J = D.shape[0], D.shape[1] // 2
    R, S = t.state_off.shape
    Jk = t.frame_off.shape[1]
    if rows == 0 or Jk == 0:
        return torch.zeros(R, dtype=torch.float32, device=D.device)
    pairs = D.reshape(rows * J, 2)              # [row * J + col] = (up, dn)
    norm = 1.0 / (min(Params.water_delta, 0.080) * 2.9)
    expect = (torch.arange(Params.sync_bits, device=D.device) & 1) > 0
    per_pass = max(1, _WORKSPACE // (S * Jk))
    best = []
    for r0 in range(0, R, per_pass):
        idx, valid = row_index(t.state_off[r0:r0 + per_pass],
                               t.frame_off[r0:r0 + per_pass])
        valid &= idx < rows
        g = pairs[idx.clamp_(0, rows - 1).mul_(J).add_(t.cols)]
        mask = valid.to(torch.float32)
        # the second of the three blocks swaps up and down; masked entries
        # count 0 after the swap
        u = torch.where(t.swap, g[..., 1], g[..., 0]) * mask
        d = torch.where(t.swap, g[..., 0], g[..., 1]) * mask
        u_bit = u @ t.bit_onehot                # (r, states, sync_bits)
        d_bit = d @ t.bit_onehot
        cnt = mask @ t.bit_onehot
        raw_q = torch.where(
            (u_bit == 0) | (d_bit == 0), torch.zeros_like(u_bit),
            torch.where(u_bit < d_bit, 1.0 - u_bit / d_bit,
                        d_bit / u_bit - 1.0))
        signed = torch.where(expect, raw_q, -raw_q)
        total = cnt.sum(dim=-1)
        q = torch.where(
            total > 0,
            ((signed * cnt).sum(dim=-1) / total.clamp(min=1.0)).abs() * norm,
            torch.zeros_like(total))
        best.append(q.max(dim=-1).values)
    return torch.cat(best)


def compare_speed_batch(D: np.ndarray, sync_bits: SpeedSyncBits,
                        relative_speeds: List[float], center: float,
                        device: DeviceLike = None
                        ) -> List[Tuple[float, float]]:
    """Best (quality, speed) over all offsets for a batch of relative
    speeds on the mag matrix D (reference: src/wmspeed.cc:270-382).

    index = (state_off + frame_off) >> 16 is valid while state_off +
    frame_off >= 0 (raw) and index < rows."""
    if D.shape[0] == 0:
        return [(0.0, rel * center) for rel in relative_speeds]
    dev = resolve(device)
    q = compare_speed_core(
        torch.tensor(D, dtype=torch.float32, device=dev),
        _compare_tables(relative_speeds, sync_bits, None, dev)).cpu().numpy()
    return [(float(q[i]), rel * center)
            for i, rel in enumerate(relative_speeds)]


def scan_device_count(device: DeviceLike = None) -> int:
    """Devices the speed scan splits its centres over
    (device.card_count)."""
    return card_count(device)


def speed_scan(clip_samples: np.ndarray, n_channels: int,
               centers: Sequence[float], scan_seconds: float,
               rels: Sequence[float], sync_bits: SpeedSyncBits,
               device: DeviceLike = None
               ) -> List[List[Tuple[float, float]]]:
    """Qualities for every (centre, rel) pair, with the clip uploaded once
    per device and one read of the (centres x rels) grid at the end.  The
    centres split over scan_device_count() devices in contiguous shares,
    each share enqueued on its device before anything is read; a centre's
    arithmetic is the same on whichever device it runs.  Returns, per
    centre, [(quality, centre * rel)] in rel order: the values that
    prepare_mag_matrix + compare_speed_batch give centre by centre."""
    resolve(device)
    prof.count("speed.scans")
    clip_frames = clip_samples.size // n_channels
    max_rows = max(mag_rows(int(round(
        _scan_in_frames(clip_frames, c, scan_seconds) * (c / 2))))
        for c in centers)
    if max_rows > 0:
        n_dev = min(scan_device_count(device), len(centers))
        per = -(-len(centers) // n_dev)
        shares = []
        for i, dev in enumerate(spread(device, n_dev)):
            mine = centers[i * per:(i + 1) * per]
            if not len(mine):
                continue
            with prof.phase("speed.prepare"):
                x = _upload_clip(clip_samples, n_channels, dev)
                win = torch.from_numpy(_sub_window()).to(dev)
                v = torch.from_numpy(sync_bits.v).to(dev)
            with prof.phase("speed.compare"):
                tables = _compare_tables(rels, sync_bits, max_rows, dev)
            row = []
            for c in mine:
                with prof.phase("speed.prepare"):
                    D = _center_mag_matrix(x, c, scan_seconds, win, v)
                prof.count("speed.centres")
                with prof.phase("speed.compare"):
                    row.append(compare_speed_core(D, tables))
            shares.append(torch.stack(row))
        with prof.phase("speed.compare"):
            grid = np.concatenate([s.cpu().numpy() for s in shares])
    else:
        grid = np.zeros((len(centers), len(rels)), dtype=np.float32)
    return [[(float(grid[k, r]), rel * center) for r, rel in enumerate(rels)]
            for k, center in enumerate(centers)]

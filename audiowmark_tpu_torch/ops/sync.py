"""Sync-search geometry: the keyed sync-bit layout and the search constants.

Port of the parts of audiowmark_tpu/ops/sync.py that the fused search
(ops/search_fused.py) uses.  The search scores every start on a hop-256 dB
spectrogram S (tau, band) through a 0/1 band-selection matrix V (2 rows per
sync frame: up and down), D = V . S^T (reference: src/syncfinder.cc).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from audiowmark_tpu.params import Params

from ..tables import KeyTables
from .frames import FRAME

N_BANDS = Params.max_band - Params.min_band + 1
HOP = Params.sync_search_step  # 256
SHIFTS = FRAME // HOP          # 4

# refinement grid: +-sync_search_step in steps of sync_search_fine
N_REFINE = 2 * (Params.sync_search_step // Params.sync_search_fine) + 1  # 65
_SPAN = Params.sync_search_fine * (N_REFINE - 1) + FRAME                 # 1536
_SUB = Params.sync_search_fine                                           # 8


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


def normalize_factor() -> float:
    """raw / min(water_delta, 0.08) / 2.9 — src/syncfinder.cc:79-91."""
    return 1.0 / (min(Params.water_delta, 0.080) * 2.9)

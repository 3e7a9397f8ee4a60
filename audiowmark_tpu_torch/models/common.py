"""Shared model-layer helpers: payload parsing and frame-mod tables.

Port of audiowmark_tpu/models/common.py (host numpy), importing the port's
codec and tables."""

from __future__ import annotations

from typing import Optional

import numpy as np

from audiowmark_tpu.params import Params
from audiowmark_tpu.utils.hexbits import bit_str_to_vec
from audiowmark_tpu.utils.log import error

from ..codec import ConvBlockType, code_encode
from ..ops.frames import N_BINS
from ..tables import KeyTables, randomize_bit_order


def parse_payload(bits: str) -> Optional[np.ndarray]:
    """Hex payload -> bit vector; auto-repeats short messages unless strict
    (reference: src/wmcommon.cc:210-238)."""
    bitvec = bit_str_to_vec(bits)
    if not bitvec:
        error("audiowmark: cannot parse bits '%s'\n" % bits)
        return None
    if (Params.payload_short or Params.strict) \
            and len(bitvec) != Params.payload_size:
        error("audiowmark: number of message bits must match payload size "
              "(%d bits)\n" % Params.payload_size)
        return None
    if len(bitvec) > Params.payload_size:
        error("audiowmark: number of bits in message '%s' larger than "
              "payload size\n" % bits)
        return None
    if len(bitvec) < Params.payload_size:
        bitvec = [bitvec[i % len(bitvec)] for i in range(Params.payload_size)]
    return np.array(bitvec, dtype=np.int32)


def build_block_frame_mods(tables: KeyTables, bitvec: np.ndarray,
                           ab: int) -> np.ndarray:
    """Signed frame-mod table for one block type: (frames_per_block, N_BINS)
    int8 with +1 = UP, -1 = DOWN, 0 = KEEP.

    Combines mark_sync (always linear order, pattern 010101 for A, 101010 for
    B) and mark_data (mix scatter by default) —
    reference: src/wmadd.cc:86-162.
    """
    mods = np.zeros((tables.frames_per_block, N_BINS), dtype=np.int8)

    # ---- sync frames ----
    f = np.arange(tables.n_sync_frames)
    data_bit = ((f // Params.sync_frames_per_bit + ab) & 1)
    frames = tables.pos_vec[f]
    up_sign = np.where(data_bit > 0, 1, -1).astype(np.int8)
    mods[frames[:, None], tables.sync_up] = up_sign[:, None]
    mods[frames[:, None], tables.sync_dn] = (-up_sign)[:, None]

    # ---- data frames ----
    block_type = ConvBlockType.b if ab else ConvBlockType.a
    fec = randomize_bit_order(
        tables, code_encode(block_type, bitvec), encode=True)

    bpf = Params.bands_per_frame
    if Params.mix:
        b = np.arange(tables.n_data_frames * bpf)
        bits = fec[b // (bpf * Params.frames_per_bit)]
        sign = np.where(bits > 0, 1, -1).astype(np.int8)
        mods[tables.mix_frame, tables.mix_up] = sign
        mods[tables.mix_frame, tables.mix_dn] = -sign
    else:
        f = np.arange(tables.n_data_frames)
        bits = fec[f // Params.frames_per_bit]
        frames = tables.data_frame(f)
        sign = np.where(bits > 0, 1, -1).astype(np.int8)
        mods[frames[:, None], tables.data_up] = sign[:, None]
        mods[frames[:, None], tables.data_dn] = (-sign)[:, None]

    return mods


def build_ab_frame_mods(tables: KeyTables, bitvec: np.ndarray) -> np.ndarray:
    """A block mods followed by B block mods: (2*frames_per_block, N_BINS)."""
    return np.concatenate([build_block_frame_mods(tables, bitvec, 0),
                           build_block_frame_mods(tables, bitvec, 1)], axis=0)

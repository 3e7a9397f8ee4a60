"""Key-derived watermark layout tables.

Port of audiowmark_tpu/tables.py: the same derivation, line for line, from
the keyed AES PRNG (crypto/, shared with the JAX package) into numpy
arrays, importing the port's codec.  `tables_to_device` turns one key's
tables, its BLOCK and CLIP sync-bit layouts and the analysis/synthesis
windows into tensors on a device; this layout is the system's only state
(it has no weights).

Table semantics (reference: src/wmcommon.hh:92-185, src/wmcommon.cc:143-202):

* up/down bands: per frame f, shuffle [min_band..max_band] (81 bands) with
  seed=f on the stream; first 30 are "up", next 30 "down".
* frame positions: one shuffle of arange(frames_per_block) on stream
  frame_position; first 510 entries are sync frame slots, the rest data.
* mix entries: the (data_frame x 30) triples (frame_pos, up, down) flattened
  and shuffled on stream mix.
* bit order: shuffle of arange(n_coded_bits) on stream bit_order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from .crypto.keys import Key
from .crypto.prng import (Stream, batched_shuffle_identity,
                          shuffle_identity)
from .params import Params

from .codec.convcode import ConvBlockType, conv_code_size
from .codec.shortcode import short_code_output_size
from .device import DeviceLike, resolve


def payload_coded_bits() -> int:
    """Soft bits carried per A (or B) block for the current payload config."""
    if Params.payload_short:
        return conv_code_size(ConvBlockType.a,
                              short_code_output_size(Params.payload_size))
    return conv_code_size(ConvBlockType.a, Params.payload_size)


def mark_data_frame_count() -> int:
    return payload_coded_bits() * Params.frames_per_bit


def mark_sync_frame_count() -> int:
    return Params.sync_bits * Params.sync_frames_per_bit


def frames_per_block() -> int:
    return mark_data_frame_count() + mark_sync_frame_count()


@dataclass
class KeyTables:
    """All key-derived layout tables for one (key, payload config)."""

    key: Key
    n_data_frames: int
    n_sync_frames: int

    # per-frame band choices, absolute band numbers (min_band..max_band)
    data_up: np.ndarray    # (n_data_frames, 30) int32
    data_dn: np.ndarray    # (n_data_frames, 30) int32
    sync_up: np.ndarray    # (n_sync_frames, 30) int32
    sync_dn: np.ndarray    # (n_sync_frames, 30) int32

    # block-frame positions: pos_vec[:510] sync slots, pos_vec[510:] data
    pos_vec: np.ndarray    # (frames_per_block,) int32

    # mix scatter (already shuffled): entry b -> (block frame, up, down bands)
    mix_frame: np.ndarray  # (n_data_frames*30,) int32
    mix_up: np.ndarray     # (n_data_frames*30,) int32
    mix_dn: np.ndarray     # (n_data_frames*30,) int32

    # interleaver over coded bits
    bit_order: np.ndarray  # (payload_coded_bits,) int32

    @property
    def frames_per_block(self) -> int:
        return self.n_data_frames + self.n_sync_frames

    def data_frame(self, f) -> np.ndarray:
        return self.pos_vec[np.asarray(f) + self.n_sync_frames]


TABLE_FIELDS = ("data_up", "data_dn", "sync_up", "sync_dn", "pos_vec",
                "mix_frame", "mix_up", "mix_dn", "bit_order")

_cache: Dict[Tuple[bytes, int, int, bool, int], KeyTables] = {}


def get_key_tables(key: Key) -> KeyTables:
    cache_key = (key.aes_key(), Params.payload_size, Params.frames_per_bit,
                 Params.payload_short, Params.sync_frames_per_bit)
    hit = _cache.get(cache_key)
    if hit is not None:
        return hit

    n_bands = Params.max_band - Params.min_band + 1
    n_data = mark_data_frame_count()
    n_sync = mark_sync_frame_count()
    n_total = n_data + n_sync

    # per-frame up/down band shuffles, batched over frames
    d_shuf = batched_shuffle_identity(
        key, list(range(n_data)), Stream.data_up_down, n_bands)
    s_shuf = batched_shuffle_identity(
        key, list(range(n_sync)), Stream.sync_up_down, n_bands)
    bpf = Params.bands_per_frame
    data_up = (d_shuf[:, :bpf] + Params.min_band).astype(np.int32)
    data_dn = (d_shuf[:, bpf:2 * bpf] + Params.min_band).astype(np.int32)
    sync_up = (s_shuf[:, :bpf] + Params.min_band).astype(np.int32)
    sync_dn = (s_shuf[:, bpf:2 * bpf] + Params.min_band).astype(np.int32)

    pos_vec = shuffle_identity(key, 0, Stream.frame_position, n_total)

    # mix entries: flatten (data frame counter f, i) -> triple, then shuffle
    data_pos = pos_vec[n_sync:]
    mix_frame = np.repeat(data_pos[:n_data], bpf).astype(np.int32)
    mix_up = data_up.reshape(-1).copy()
    mix_dn = data_dn.reshape(-1).copy()
    perm = shuffle_identity(key, 0, Stream.mix, n_data * bpf)
    mix_frame = mix_frame[perm]
    mix_up = mix_up[perm]
    mix_dn = mix_dn[perm]

    bit_order = shuffle_identity(key, 0, Stream.bit_order,
                                 payload_coded_bits())

    tables = KeyTables(
        key=key, n_data_frames=n_data, n_sync_frames=n_sync,
        data_up=data_up, data_dn=data_dn, sync_up=sync_up, sync_dn=sync_dn,
        pos_vec=pos_vec, mix_frame=mix_frame, mix_up=mix_up, mix_dn=mix_dn,
        bit_order=bit_order)
    _cache[cache_key] = tables
    return tables


def randomize_bit_order(tables: KeyTables, bit_vec: np.ndarray,
                        encode: bool) -> np.ndarray:
    """Keyed interleaver (reference: src/wmcommon.hh:165-185)."""
    order = tables.bit_order[: len(bit_vec)]
    out = np.empty_like(np.asarray(bit_vec))
    if encode:
        out[:] = np.asarray(bit_vec)[order]
    else:
        out[order] = np.asarray(bit_vec)
    return out


# (id(tables), device) -> (tables, tensors); the entry holds the tables, so
# the id stays theirs while it lives
_device_cache: Dict[Tuple[int, torch.device],
                    Tuple[KeyTables, Dict[str, torch.Tensor]]] = {}


def tables_to_device(tables: KeyTables,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """One key's layout as tensors on `device`: the KeyTables arrays under
    their field names, the sync-bit layouts as sync_frame_{block,clip}
    (6, n_pos) and sync_v_{block,clip} (2*6*n_pos, N_BANDS), and the
    analysis (FRAME,) and synthesis (3*FRAME,) windows.  Made once per
    tables object and device; callers must not write to the tensors."""
    dev = resolve(device)
    hit = _device_cache.get((id(tables), dev))
    if hit is None:
        hit = (tables, _upload(tables, dev))
        _device_cache[(id(tables), dev)] = hit
    return hit[1]


def clear_cache():
    """Forget every key's tables and their device copies: the next
    get_key_tables builds them again."""
    _cache.clear()
    _device_cache.clear()


def _upload(tables: KeyTables, dev: torch.device) -> Dict[str, torch.Tensor]:
    from .ops.frames import window_tensors
    from .ops.sync import build_sync_bits

    host = {name: getattr(tables, name) for name in TABLE_FIELDS}
    for mode, clip in (("block", False), ("clip", True)):
        sb = build_sync_bits(tables, clip)
        host["sync_frame_" + mode] = sb.frame
        host["sync_v_" + mode] = sb.v
    out = {name: torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
           for name, arr in host.items()}
    out["analysis_window"], out["synthesis_window"] = window_tensors(dev)
    return out

"""The keyed watermark layout, derived from the key alone.

Upstream audiowmark (src/random.cc, src/wmcommon.cc:143-238,
src/convcode.cc, src/wmadd.cc:86-162, src/syncfinder.cc:30-77) draws every
table of the watermark from an AES-128-CTR keystream: per-frame up/down
bands, the frame positions of the sync and data frames, the mix scatter
and the interleaver.  This module works them out again in plain numpy from
the key's 16 bytes and the geometry of a configuration file, so that the
reference takes no table from the program.  The shuffles follow
audiowmark_tpu_torch/crypto/prng.py's numpy path and tables.py's
derivation (both the JAX package's, byte for byte).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Sequence

import numpy as np

from . import aes

# streams of the keyed PRNG (src/random.hh)
DATA_UP_DOWN, SYNC_UP_DOWN, MIX, BIT_ORDER, FRAME_POSITION = 1, 2, 4, 5, 6

# the order-15 convolutional code: 12 generators, A takes the even ones,
# B the odd ones, AB all of them (src/convcode.cc)
AB_GENERATORS = (
    0o66561, 0o75211, 0o71545, 0o54435, 0o63635, 0o52475,
    0o63543, 0o75307, 0o52547, 0o45627, 0o67657, 0o51757,
)
ORDER = 15
STATES = 1 << ORDER


@dataclass(frozen=True)
class Geom:
    """The watermark geometry a configuration file states."""

    frame_size: int = 1024
    bands_per_frame: int = 30
    min_band: int = 20
    max_band: int = 100
    sync_bits: int = 6
    sync_frames_per_bit: int = 85
    sync_search_step: int = 256
    sync_search_fine: int = 8
    frames_pad_start: int = 250
    mark_sample_rate: int = 44100
    frames_per_bit: int = 2
    water_delta: float = 0.01
    payload_size: int = 128
    sync_threshold2: float = 0.35
    get_n_best: int = 8
    limiter_block_size_ms: int = 1000
    limiter_ceiling: float = 0.99

    @classmethod
    def from_config(cls, cfg: Dict) -> "Geom":
        wm = cfg["watermark"]
        return cls(**{k: (wm[k] if k in wm else getattr(cls, k))
                      for k in cls.__dataclass_fields__})

    @property
    def n_bands(self) -> int:
        return self.max_band - self.min_band + 1

    @property
    def coded_bits(self) -> int:        # per A (or B) block
        return (self.payload_size + ORDER) * len(AB_GENERATORS) // 2

    @property
    def n_data_frames(self) -> int:
        return self.coded_bits * self.frames_per_bit

    @property
    def n_sync_frames(self) -> int:
        return self.sync_bits * self.sync_frames_per_bit

    @property
    def frames_per_block(self) -> int:
        return self.n_data_frames + self.n_sync_frames


def generators(block_type: str):
    return {"a": AB_GENERATORS[0::2], "b": AB_GENERATORS[1::2],
            "ab": AB_GENERATORS}[block_type]


def _ivs(round_keys, seeds: Sequence[int], stream: int) -> np.ndarray:
    plains = np.zeros((len(seeds), 16), dtype=np.uint8)
    for i, s in enumerate(seeds):
        plains[i, 0:8] = np.frombuffer(
            (s & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big"), dtype=np.uint8)
        plains[i, 8] = stream & 0xFF
    return aes.encrypt_blocks(round_keys, plains)


def shuffles(key: bytes, seeds: Sequence[int], stream: int,
             n: int) -> np.ndarray:
    """Fisher-Yates shuffle (with the modulo draw) of arange(n) for every
    seed: (len(seeds), n) int64."""
    rk = aes.expand_key(key)
    rand = aes.ctr_keystreams_u64_batch(rk, _ivs(rk, seeds, stream), n)
    B = len(seeds)
    if B == 1:                  # one long shuffle: plain ints are faster
        r = [int(v) for v in rand[0]]
        one = list(range(n))
        for i in range(n):
            j = i + r[i] % (n - i)
            one[i], one[j] = one[j], one[i]
        return np.asarray([one], np.int64)
    out = np.tile(np.arange(n, dtype=np.int64), (B, 1))
    rows = np.arange(B)
    for i in range(n):
        j = i + (rand[:, i] % np.uint64(n - i)).astype(np.int64)
        tmp = out[rows, j].copy()
        out[rows, j] = out[:, i]
        out[:, i] = tmp
    return out


@dataclass
class Layout:
    """One key's tables at one geometry (bands absolute, as upstream)."""

    geom: Geom
    data_up: np.ndarray
    data_dn: np.ndarray
    sync_up: np.ndarray
    sync_dn: np.ndarray
    pos_vec: np.ndarray
    mix_frame: np.ndarray
    mix_up: np.ndarray
    mix_dn: np.ndarray
    bit_order: np.ndarray


@lru_cache(maxsize=8)
def layout(key: bytes, geom: Geom) -> Layout:
    g = geom
    n_data, n_sync = g.n_data_frames, g.n_sync_frames
    bpf = g.bands_per_frame
    d = shuffles(key, range(n_data), DATA_UP_DOWN, g.n_bands)
    s = shuffles(key, range(n_sync), SYNC_UP_DOWN, g.n_bands)
    pos_vec = shuffles(key, [0], FRAME_POSITION, n_data + n_sync)[0]
    data_up = d[:, :bpf] + g.min_band
    data_dn = d[:, bpf:2 * bpf] + g.min_band
    perm = shuffles(key, [0], MIX, n_data * bpf)[0]
    mix_frame = np.repeat(pos_vec[n_sync:][:n_data], bpf)[perm]
    return Layout(
        geom=g, data_up=data_up, data_dn=data_dn,
        sync_up=s[:, :bpf] + g.min_band, sync_dn=s[:, bpf:2 * bpf]
        + g.min_band, pos_vec=pos_vec, mix_frame=mix_frame,
        mix_up=data_up.reshape(-1)[perm], mix_dn=data_dn.reshape(-1)[perm],
        bit_order=shuffles(key, [0], BIT_ORDER, g.coded_bits)[0])


def conv_encode(block_type: str, bits) -> np.ndarray:
    """Shift-register encoder: out[t, p] = XOR over the taps of poly p."""
    gens = generators(block_type)
    b = np.concatenate([np.asarray(bits, np.uint8), np.zeros(ORDER, np.uint8)])
    out = np.zeros((b.size, len(gens)), np.uint8)
    for t in range(b.size):
        for p, poly in enumerate(gens):
            acc = 0
            for k in range(ORDER):
                if poly >> k & 1 and t - k >= 0:
                    acc ^= int(b[t - k])
            out[t, p] = acc
    return out.reshape(-1)


def parity_table(block_type: str) -> np.ndarray:
    """(STATES, rate) float64: the coded bits a state's register emits."""
    states = np.arange(STATES, dtype=np.int64)
    cols = []
    for poly in generators(block_type):
        v = states & poly
        cols.append(_popcount_parity(v))
    return np.stack(cols, axis=1)


def _popcount_parity(v: np.ndarray) -> np.ndarray:
    v = v.copy()
    for sh in (16, 8, 4, 2, 1):
        v ^= v >> sh
    return (v & 1).astype(np.float64)


def frame_mods(lay: Layout, bits: np.ndarray) -> np.ndarray:
    """(2 * frames_per_block, n_bins) int8 of the A block then the B block:
    +1 up, -1 down, 0 kept (src/wmadd.cc:86-162, mix mode)."""
    g = lay.geom
    n_bins = g.frame_size // 2 + 1
    blocks = []
    for ab in (0, 1):
        mods = np.zeros((g.frames_per_block, n_bins), np.int8)
        f = np.arange(g.n_sync_frames)
        up = np.where(((f // g.sync_frames_per_bit + ab) & 1) > 0, 1, -1)
        frames = lay.pos_vec[f]
        mods[frames[:, None], lay.sync_up] = up[:, None]
        mods[frames[:, None], lay.sync_dn] = -up[:, None]
        fec = conv_encode("b" if ab else "a", bits)[lay.bit_order]
        e = np.arange(g.n_data_frames * g.bands_per_frame)
        sign = np.where(fec[e // (g.bands_per_frame * g.frames_per_bit)] > 0,
                        1, -1)
        mods[lay.mix_frame, lay.mix_up] = sign
        mods[lay.mix_frame, lay.mix_dn] = -sign
        blocks.append(mods)
    return np.concatenate(blocks)


def sync_bits(lay: Layout, clip: bool):
    """The sync frames as (bit, k) -> (block frame, up bands, down bands),
    bit-major and frame-sorted per bit; in clip mode each sync frame also
    appears one block later with up and down swapped.  Returns (frames
    (6, n_pos) int64, up (6, n_pos, 30), dn (6, n_pos, 30)) with bands
    relative to min_band."""
    g = lay.geom
    fpb = g.frames_per_block
    n_pos = g.sync_frames_per_bit * (2 if clip else 1)
    frames = np.zeros((g.sync_bits, n_pos), np.int64)
    up = np.zeros((g.sync_bits, n_pos, g.bands_per_frame), np.int64)
    dn = np.zeros_like(up)
    for bit in range(g.sync_bits):
        entries = []
        for f in range(g.sync_frames_per_bit):
            i = bit * g.sync_frames_per_bit + f
            u, d = lay.sync_up[i] - g.min_band, lay.sync_dn[i] - g.min_band
            pos = int(lay.pos_vec[i])
            entries.append((pos, u, d))
            if clip:
                entries.append((pos + fpb, d, u))
        entries.sort(key=lambda e: e[0])
        for k, (pos, u, d) in enumerate(entries):
            frames[bit, k], up[bit, k], dn[bit, k] = pos, u, d
    return frames, up, dn

"""Keyed, seekable, stream-separated CSPRNG (AES-128-CTR).

Reference semantics (src/random.cc:97-190):

* seed(seed, stream): the CTR IV is AES-128-ECB_key(BE64(seed) || stream_byte
  || zeros).
* draws: the keystream (encryption of zeros) is read in 256-byte chunks and
  split into big-endian uint64 words.
* shuffle: Fisher-Yates with modulo (draws one u64 per element, including the
  final trivial `% 1` draw).
* random_double: libstdc++ uniform_real_distribution over a 64-bit URBG,
  i.e. u64 / 2^64 rounded to double.
* seed_from_hash: first 8 bytes (big-endian) of SHA1 over float32 memory.

On top of the scalar `Random` (exact drop-in), this module provides *batched*
helpers that derive many seeded streams at once with vectorized AES — this is
how per-frame shuffle tables for thousands of frames are produced in
milliseconds.
"""

from __future__ import annotations

import hashlib
import os
from enum import IntEnum
from typing import List, Sequence

import numpy as np

from . import aes, native
from .keys import Key


class Stream(IntEnum):
    data_up_down = 1
    sync_up_down = 2
    speed_clip = 3
    mix = 4
    bit_order = 5
    frame_position = 6


_BLOCK_U64 = 32  # 256-byte refill = 32 big-endian uint64 words


def _seed_iv(round_keys: np.ndarray, seed: int, stream: Stream) -> bytes:
    plain = bytearray(16)
    plain[0:8] = (seed & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big")
    plain[8] = int(stream) & 0xFF
    return aes.encrypt_block(round_keys, bytes(plain))


class Random:
    """Scalar drop-in of the reference Random class."""

    def __init__(self, key: Key, seed: int, stream: Stream):
        self._round_keys = aes.expand_key(key.aes_key())
        self.seed(seed, stream)

    def seed(self, seed: int, stream: Stream):
        self._iv = _seed_iv(self._round_keys, seed, stream)
        self._buffer = np.empty(0, dtype=np.uint64)
        self._buffer_pos = 0
        self._ctr_block = 0

    def _refill(self):
        self._buffer = aes.ctr_keystream_u64(
            self._round_keys, self._iv, self._ctr_block, _BLOCK_U64 // 2)
        self._ctr_block += _BLOCK_U64 // 2
        self._buffer_pos = 0

    def __call__(self) -> int:
        if self._buffer_pos == len(self._buffer):
            self._refill()
        v = int(self._buffer[self._buffer_pos])
        self._buffer_pos += 1
        return v

    def random_double(self) -> float:
        """Uniform double in [0,1): u64/2^64 rounded to nearest double."""
        x = self()
        d = float(np.float64(x) / np.float64(2.0 ** 64))
        if d >= 1.0:
            d = float(np.nextafter(1.0, 0.0))
        return d

    def shuffle(self, result: List):
        """Fisher-Yates with modulo bias, exactly as the reference."""
        n = len(result)
        for i in range(n):
            rn = self()
            j = i + rn % (n - i)
            result[i], result[j] = result[j], result[i]


def gen_key() -> str:
    """16 cryptographically strong random bytes as hex (src/random.cc:174-182)."""
    return os.urandom(16).hex()


def seed_from_hash(floats: np.ndarray) -> int:
    """First 8 bytes (BE) of SHA1 over the float32 array memory."""
    h = hashlib.sha1(np.asarray(floats, dtype=np.float32).tobytes()).digest()
    return int.from_bytes(h[:8], "big")


# ---- batched table derivation ----------------------------------------------

def batched_u64(key: Key, seeds: Sequence[int], stream: Stream,
                n_u64: int) -> np.ndarray:
    """For each seed, the first n_u64 keystream words: (len(seeds), n_u64)."""
    rk = aes.expand_key(key.aes_key())
    plains = np.zeros((len(seeds), 16), dtype=np.uint8)
    for i, s in enumerate(seeds):
        plains[i, 0:8] = np.frombuffer(
            (s & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "big"), dtype=np.uint8)
        plains[i, 8] = int(stream) & 0xFF
    ivs = aes.encrypt_blocks(rk, plains)
    out = native.ctr_keystreams_u64(key.aes_key(), ivs, n_u64)
    if out is not None:
        return out
    return aes.ctr_keystreams_u64_batch(rk, ivs, n_u64)


def batched_shuffle_identity(key: Key, seeds: Sequence[int], stream: Stream,
                             n: int) -> np.ndarray:
    """Fisher-Yates shuffle of arange(n) for every seed at once.

    Returns (len(seeds), n) int32 — native C++ when built, otherwise
    vectorized across the seed axis (the per-element loop runs only n times
    regardless of how many seeds).
    """
    out = native.shuffle_tables(key.aes_key(), list(seeds), int(stream), n)
    if out is not None:
        return out
    rand = batched_u64(key, seeds, stream, n)
    B = len(seeds)
    out = np.tile(np.arange(n, dtype=np.int64), (B, 1))
    rows = np.arange(B)
    for i in range(n):
        j = i + (rand[:, i] % np.uint64(n - i)).astype(np.int64)
        tmp = out[rows, j].copy()
        out[rows, j] = out[:, i]
        out[:, i] = tmp
    return out.astype(np.int32)


def shuffle_identity(key: Key, seed: int, stream: Stream, n: int) -> np.ndarray:
    """Single-seed convenience wrapper: shuffled arange(n) as int32."""
    return batched_shuffle_identity(key, [seed], stream, n)[0]

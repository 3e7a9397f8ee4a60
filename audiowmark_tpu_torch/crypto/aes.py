"""Vectorized AES-128 (ECB encrypt) over numpy.

The watermark layout is derived from an AES-128-CTR keystream (reference:
src/random.cc:97-161 uses libgcrypt).  We only ever *encrypt* with AES — ECB
for seed-block derivation and CTR keystreams — so this module implements
batched AES-128 block encryption over numpy uint8 arrays.  All table
derivation for a key is a handful of milliseconds even for hours of audio,
and the keystream schedule is fully precomputable, so this runs on the host;
the derived tables ship to the TPU as constants.

If the optional native C++ core (native/aeswm.cc) is built, it is used for
large batches; the numpy path is the always-available fallback and the
reference for tests.
"""

from __future__ import annotations

import numpy as np

# ---- S-box -----------------------------------------------------------------

_SBOX = np.array([
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, 0xfe, 0xd7, 0xab, 0x76,
    0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, 0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0,
    0xb7, 0xfd, 0x93, 0x26, 0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, 0xeb, 0x27, 0xb2, 0x75,
    0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, 0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84,
    0x53, 0xd1, 0x00, 0xed, 0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, 0x50, 0x3c, 0x9f, 0xa8,
    0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, 0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2,
    0xcd, 0x0c, 0x13, 0xec, 0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, 0xde, 0x5e, 0x0b, 0xdb,
    0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, 0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79,
    0xe7, 0xc8, 0x37, 0x6d, 0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, 0x4b, 0xbd, 0x8b, 0x8a,
    0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, 0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e,
    0xe1, 0xf8, 0x98, 0x11, 0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, 0xb0, 0x54, 0xbb, 0x16,
], dtype=np.uint8)

# GF(2^8) xtime (multiply by 2) table
_x = np.arange(256, dtype=np.uint16)
_XTIME = (((_x << 1) ^ np.where(_x & 0x80, 0x1B, 0)) & 0xFF).astype(np.uint8)
_MUL3 = _XTIME ^ np.arange(256, dtype=np.uint8)
del _x

# ShiftRows permutation for a 16-byte state in column-major (AES standard)
# byte order: state[r + 4c]; after ShiftRows: out[r + 4c] = in[r + 4((c+r)%4)]
_SHIFT_ROWS = np.array(
    [0, 5, 10, 15, 4, 9, 14, 3, 8, 13, 2, 7, 12, 1, 6, 11], dtype=np.intp
)

_RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36],
                 dtype=np.uint8)


def expand_key(key: bytes) -> np.ndarray:
    """AES-128 key schedule -> (11, 16) uint8 round keys."""
    assert len(key) == 16
    w = [np.frombuffer(key, dtype=np.uint8)[i * 4:(i + 1) * 4].copy()
         for i in range(4)]
    for i in range(4, 44):
        temp = w[i - 1].copy()
        if i % 4 == 0:
            temp = np.roll(temp, -1)
            temp = _SBOX[temp]
            temp[0] ^= _RCON[i // 4 - 1]
        w.append(w[i - 4] ^ temp)
    rk = np.stack([np.concatenate(w[i * 4:(i + 1) * 4]) for i in range(11)])
    return rk


def _mix_columns(state: np.ndarray) -> np.ndarray:
    """MixColumns on (N, 16) uint8 state in column-major byte order."""
    s = state.reshape(-1, 4, 4)  # (N, col, row)
    a0, a1, a2, a3 = s[:, :, 0], s[:, :, 1], s[:, :, 2], s[:, :, 3]
    r0 = _XTIME[a0] ^ _MUL3[a1] ^ a2 ^ a3
    r1 = a0 ^ _XTIME[a1] ^ _MUL3[a2] ^ a3
    r2 = a0 ^ a1 ^ _XTIME[a2] ^ _MUL3[a3]
    r3 = _MUL3[a0] ^ a1 ^ a2 ^ _XTIME[a3]
    return np.stack([r0, r1, r2, r3], axis=2).reshape(-1, 16)


def encrypt_blocks(round_keys: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Encrypt (N, 16) uint8 blocks with AES-128; returns (N, 16) uint8."""
    assert blocks.ndim == 2 and blocks.shape[1] == 16
    state = blocks ^ round_keys[0]
    for rnd in range(1, 10):
        state = _SBOX[state]
        state = state[:, _SHIFT_ROWS]
        state = _mix_columns(state)
        state ^= round_keys[rnd]
    state = _SBOX[state]
    state = state[:, _SHIFT_ROWS]
    state ^= round_keys[10]
    return state


def encrypt_block(round_keys: np.ndarray, block: bytes) -> bytes:
    out = encrypt_blocks(round_keys, np.frombuffer(block, dtype=np.uint8)[None, :])
    return out[0].tobytes()


def ctr_counters(iv: bytes, start_block: int, n_blocks: int) -> np.ndarray:
    """Big-endian 128-bit counters iv+start .. iv+start+n-1 as (n, 16) uint8.

    libgcrypt CTR mode increments the full 128-bit counter big-endian
    (wrapping mod 2^128); the keystream is AES(counter_i).
    """
    base = int.from_bytes(iv, "big")
    out = np.empty((n_blocks, 16), dtype=np.uint8)
    # vectorized 128-bit add: split into two 64-bit halves
    lo = (base + start_block) & ((1 << 128) - 1)
    hi64 = lo >> 64
    lo64 = lo & 0xFFFFFFFFFFFFFFFF
    ks = np.arange(n_blocks, dtype=np.uint64)
    new_lo = (np.uint64(lo64) + ks)  # wraps mod 2^64 (numpy uint64 overflow)
    carry = new_lo < np.uint64(lo64)
    new_hi = np.uint64(hi64 & 0xFFFFFFFFFFFFFFFF) + carry.astype(np.uint64)
    out[:, :8] = new_hi.astype(">u8").view(np.uint8).reshape(-1, 8)
    out[:, 8:] = new_lo.astype(">u8").view(np.uint8).reshape(-1, 8)
    return out


def ctr_keystream_u64(round_keys: np.ndarray, iv: bytes,
                      start_block: int, n_blocks: int) -> np.ndarray:
    """AES-CTR keystream as big-endian uint64 values, 2 per block.

    Returns (n_blocks * 2,) uint64 — the reference draws its random stream as
    big-endian uint64 words from 256-byte CTR chunks (src/random.cc:144-161).
    """
    counters = ctr_counters(iv, start_block, n_blocks)
    ks = encrypt_blocks(round_keys, counters)
    return ks.reshape(-1, 8)[:, ::-1].copy().view(np.uint64).reshape(-1)


def ctr_keystreams_u64_batch(round_keys: np.ndarray, ivs: np.ndarray,
                             n_u64: int) -> np.ndarray:
    """Batched keystreams: for each IV, the first n_u64 uint64 draws.

    ivs: (B, 16) uint8.  Returns (B, n_u64) uint64.

    The reference refills its buffer in 256-byte chunks (32 u64 = 16 AES
    blocks); the draw sequence is a pure prefix of the CTR keystream, so
    refill chunking does not affect the values — only how many are computed.
    We round up to whole 256-byte refills to match the reference's consumption
    of CTR state (irrelevant for values, but documents intent).
    """
    B = ivs.shape[0]
    n_blocks = -(-n_u64 // 2)
    # counters for every iv: (B, n_blocks, 16)
    base_hi = ivs[:, :8].copy().view(">u8").astype(np.uint64).reshape(B, 1)
    base_lo = ivs[:, 8:].copy().view(">u8").astype(np.uint64).reshape(B, 1)
    ks = np.arange(n_blocks, dtype=np.uint64).reshape(1, -1)
    new_lo = base_lo + ks
    carry = (new_lo < base_lo).astype(np.uint64)
    new_hi = base_hi + carry
    counters = np.empty((B, n_blocks, 16), dtype=np.uint8)
    counters[:, :, :8] = new_hi.astype(">u8").view(np.uint8).reshape(B, n_blocks, 8)
    counters[:, :, 8:] = new_lo.astype(">u8").view(np.uint8).reshape(B, n_blocks, 8)
    ksbytes = encrypt_blocks(round_keys, counters.reshape(-1, 16))
    u64 = ksbytes.reshape(-1, 8)[:, ::-1].copy().view(np.uint64)
    return u64.reshape(B, n_blocks * 2)[:, :n_u64]

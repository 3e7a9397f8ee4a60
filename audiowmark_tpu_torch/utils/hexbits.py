"""Hex / bit-vector string conversions (reference: src/utils.cc:95-150).

Bit vectors are MSB-first within each hex nibble; only whole nibbles are
converted back to hex.
"""

from __future__ import annotations

from typing import List, Optional


def _from_hex_nibble(c: str) -> int:
    v = ord(c)
    if ord("0") <= v <= ord("9"):
        return v - ord("0")
    if ord("a") <= v <= ord("f"):
        return v - ord("a") + 10
    if ord("A") <= v <= ord("F"):
        return v - ord("A") + 10
    return 16  # error


def bit_str_to_vec(bits: str) -> List[int]:
    """Hex string -> bit vector (MSB first per nibble); [] on parse error."""
    bitvec: List[int] = []
    for nibble in bits:
        c = _from_hex_nibble(nibble)
        if c >= 16:
            return []
        bitvec.append(1 if (c & 8) else 0)
        bitvec.append(1 if (c & 4) else 0)
        bitvec.append(1 if (c & 2) else 0)
        bitvec.append(1 if (c & 1) else 0)
    return bitvec


def bit_vec_to_str(bit_vec) -> str:
    """Bit vector -> hex string; converts only whole groups of 4 bits."""
    out = []
    to_hex = "0123456789abcdef"
    n = len(bit_vec)
    pos = 0
    while pos + 3 < n:
        nibble = 0
        for j in range(4):
            if bit_vec[pos + j]:
                nibble |= 1 << (3 - j)
        out.append(to_hex[nibble])
        pos += 4
    return "".join(out)


def hex_str_to_vec(string: str) -> Optional[bytes]:
    """Hex string -> bytes; None on error (odd length / bad digit)."""
    if len(string) % 2 != 0:
        return None
    out = bytearray()
    for i in range(0, len(string), 2):
        hi = _from_hex_nibble(string[i])
        lo = _from_hex_nibble(string[i + 1])
        if hi >= 16 or lo >= 16:
            return None
        out.append((hi << 4) | lo)
    return bytes(out)


def vec_to_hex_str(vec: bytes) -> str:
    return vec.hex()

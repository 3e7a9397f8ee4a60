"""Vectorized float <-> PCM sample conversion.

Mirrors the reference RawConverter semantics exactly (src/rawconverter.cc):
every integer format routes through a 32-bit container value
int32 = trunc-clip(f * 2^31); bytes are shifts of that container; unsigned
formats XOR the sign bit.  The native signed 16-bit little-endian fast path
uses trunc-clip(f * 2^15) directly (one-LSB difference for tiny negative
values — preserved for bit parity with the reference).  Decoding always
reassembles the 32-bit container and scales by 2^-31.
"""

from __future__ import annotations

import numpy as np

from ..params import Encoding, RawFormat


def float_to_int_clip32(x: np.ndarray) -> np.ndarray:
    f = np.asarray(x, dtype=np.float32)
    snorm = f * np.float32(2147483648.0)
    max_value = np.float32(2147483647.0)   # rounds to 2^31 in float32, as in C
    min_value = np.float32(-2147483648.0)
    out = np.trunc(snorm)
    out = np.where(snorm >= max_value, np.float64(2147483647), out.astype(np.float64))
    out = np.where(snorm <= min_value, np.float64(-2147483648), out)
    return out.astype(np.int64).astype(np.int32)


def float_to_int_clip16(x: np.ndarray) -> np.ndarray:
    f = np.asarray(x, dtype=np.float32)
    snorm = f * np.float32(32768.0)
    out = np.trunc(snorm)
    out = np.where(snorm >= np.float32(32767.0), np.float64(32767), out.astype(np.float64))
    out = np.where(snorm <= np.float32(-32768.0), np.float64(-32768), out)
    return out.astype(np.int64).astype(np.int16)


def float_clip(x: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(x, dtype=np.float32), -1.0, 1.0)


_NORM = np.float32(1.0 / 2147483648.0)


class RawConverter:
    """Float <-> raw byte conversion for one RawFormat."""

    def __init__(self, fmt: RawFormat):
        enc = fmt.encoding()
        bits = fmt.bit_depth()
        if enc == Encoding.FLOAT:
            if bits not in (32, 64):
                raise ValueError("unsupported bit depth %d for float encoding" % bits)
        elif bits not in (8, 16, 24, 32):
            raise ValueError("unsupported bit depth %d for signed/unsigned encoding" % bits)
        self.encoding = enc
        self.bits = bits
        self.width = bits // 8
        self.little = fmt.endian() == RawFormat.Endian.LITTLE

    def to_raw(self, samples: np.ndarray) -> bytes:
        enc, bits, little = self.encoding, self.bits, self.little
        if enc == Encoding.FLOAT:
            f = float_clip(samples)
            if bits == 32:
                a = f.astype("<f4" if little else ">f4")
            else:
                a = f.astype(np.float64).astype("<f8" if little else ">f8")
            return a.tobytes()

        if enc == Encoding.SIGNED and bits == 16 and little:
            return float_to_int_clip16(samples).astype("<i2").tobytes()

        s = float_to_int_clip32(samples)
        if enc == Encoding.UNSIGNED:
            s = (s.view(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
        u = s.view(np.uint32)
        if bits == 32:
            return u.astype("<u4" if little else ">u4").tobytes()
        # emit the top `bits` bits of the container
        nbytes = bits // 8
        shifts = [32 - 8 * (k + 1) for k in range(nbytes)]  # MSB..LSB
        if little:
            shifts = shifts[::-1]
        out = np.empty((u.size, nbytes), dtype=np.uint8)
        for k, sh in enumerate(shifts):
            out[:, k] = ((u >> np.uint32(sh)) & np.uint32(0xFF)).astype(np.uint8)
        return out.tobytes()

    def from_raw(self, data: bytes) -> np.ndarray:
        enc, bits, little = self.encoding, self.bits, self.little
        n = len(data) // self.width
        data = data[: n * self.width]
        if enc == Encoding.FLOAT:
            if bits == 32:
                return np.frombuffer(data, dtype="<f4" if little else ">f4").astype(np.float32)
            return np.frombuffer(data, dtype="<f8" if little else ">f8").astype(np.float32)

        if enc == Encoding.SIGNED and bits == 16 and little:
            s16 = np.frombuffer(data, dtype="<i2")
            return (s16.astype(np.float32) * np.float32(1.0 / 32768.0))
        if enc == Encoding.SIGNED and bits == 32 and little:
            s32 = np.frombuffer(data, dtype="<i4")
            return s32.astype(np.float32) * _NORM

        raw = np.frombuffer(data, dtype=np.uint8).reshape(n, self.width)
        nbytes = bits // 8
        shifts = [32 - 8 * (k + 1) for k in range(nbytes)]
        if little:
            shifts = shifts[::-1]
        u = np.zeros(n, dtype=np.uint32)
        for k, sh in enumerate(shifts):
            u |= raw[:, k].astype(np.uint32) << np.uint32(sh)
        if enc == Encoding.UNSIGNED:
            u ^= np.uint32(0x80000000)
        return u.view(np.int32).astype(np.float32) * _NORM


def pcm_container_to_float(int_container: np.ndarray) -> np.ndarray:
    """int32 'container' samples (value << (32-bits)) -> float, norm 2^-31."""
    return int_container.astype(np.float32) * _NORM


def float_to_pcm_container(samples: np.ndarray) -> np.ndarray:
    return float_to_int_clip32(samples)

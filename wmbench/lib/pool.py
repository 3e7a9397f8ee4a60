"""Inputs made from the seed: the pool of files a cell's requests draw on.

Every seed gives the same set of sizes (lengths at fixed quantiles of the
traffic's range) and the same counts of carriers, peaks and marks, in an
order, with keys, messages, offsets and carrier draws, of its own; so two
seeds ask the program for the same work.
"""

from __future__ import annotations

import random
import struct
from typing import Iterator, List, Sequence

import numpy as np


def lengths(lo: float, hi: float, n: int) -> List[float]:
    """n lengths at the mid-quantiles of the uniform range [lo, hi]."""
    return [lo + (k + 0.5) * (hi - lo) / n for k in range(n)]


def by_slot(n: int, items: Sequence) -> list:
    """n length slots given `items` in turn: every seed gives each length
    the same carrier, peak or mark."""
    return [items[k % len(items)] for k in range(n)]


def marks(n: int, share: float) -> List[bool]:
    """Which of n length slots hold a marked excerpt: round(share * n) of
    them, spread evenly over the lengths."""
    m = int(round(share * n))
    return [int((k + 1) * m / n) > int(k * m / n) for k in range(n)]


def bits(seed: int, stream: int, i: int, n: int) -> np.ndarray:
    """The i-th message of a run's stream (0: the window's requests, 1:
    the warm-up's): n random bits."""
    return np.random.default_rng([seed, stream, i]).integers(0, 2, n)


def hex_of(bits: np.ndarray) -> str:
    v = np.asarray(bits, np.uint8).reshape(-1, 4)
    return "".join("%x" % int("".join(map(str, nib)), 2) for nib in v)


def key_file(path: str, key: bytes) -> str:
    with open(path, "w") as f:
        f.write("key %s\n" % key.hex())
    return path


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """16-bit PCM WAV of (n, C) int16 samples."""
    n, C = samples.shape
    data = np.ascontiguousarray(samples, "<i2").tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data),
                            b"WAVE", b"fmt ", 16, 1, C, rate, rate * C * 2,
                            C * 2, 16, b"data", len(data)))
        f.write(data)


def pcm_of_wav(data: bytes, channels: int) -> np.ndarray:
    """The int16 samples of a 16-bit WAV's data chunk, (n, C)."""
    pos = 12
    while pos + 8 <= len(data):
        tag, size = struct.unpack_from("<4sI", data, pos)
        if tag == b"data":
            body = data[pos + 8:pos + 8 + size]
            return np.frombuffer(body, "<i2").reshape(-1, channels)
        pos += 8 + size + (size & 1)
    raise ValueError("no data chunk")


def cycle(rng: np.random.Generator, seconds: Sequence[float]
          ) -> Iterator[int]:
    """The files in a fresh seeded order each round, as pairs of the k-th
    shortest and the k-th longest played back to back, so that any prefix
    of a round asks for about the same audio as any other."""
    order = sorted(range(len(seconds)), key=lambda i: seconds[i])
    n = len(order)
    pairs = [[order[k], order[n - 1 - k]] if k != n - 1 - k else [order[k]]
             for k in range((n + 1) // 2)]
    while True:
        for j in rng.permutation(len(pairs)):
            yield from (pairs[j] if rng.integers(2) else pairs[j][::-1])


def rotation(rng: np.random.Generator, seconds: Sequence[float]
             ) -> Iterator[int]:
    """The same pairs as `cycle` in one fixed order, every round alike,
    the seed choosing only where in it the window starts: the program's
    caches see the same sequence of sizes under every seed."""
    order = sorted(range(len(seconds)), key=lambda i: seconds[i])
    n = len(order)
    seq = [i for k in range((n + 1) // 2)
           for i in ([order[k], order[n - 1 - k]] if k != n - 1 - k
                     else [order[k]])]
    k = int(rng.integers(n))
    while True:
        yield seq[k % n]
        k += 1


class Sample:
    """A seeded uniform sample of k answers of a stream of unknown length
    (reservoir sampling), plus answers kept always."""

    def __init__(self, seed: int, k: int):
        self.rnd = random.Random(seed)
        self.k = k
        self.seen = 0
        self.kept: list = []
        self.always: list = []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = self.rnd.randrange(self.seen)
            if j < self.k:
                self.kept[j] = item

    def items(self) -> list:
        return self.always + self.kept

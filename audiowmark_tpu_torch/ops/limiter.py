"""Block-wise look-ahead soft limiter.

Port of audiowmark_tpu/ops/limiter.py.  Reference behavior
(src/limiter.cc): 1-second blocks; per block b the scale ramps linearly
from ceiling/max(M[b-1], M[b]) to ceiling/max(M[b], M[b+1]), where
M[b] = max(|x| over block b, ceiling); one block of latency.

`limit_blocks` is the whole-signal form on the device (the whole-file
add's, and over a batch of streams `watermark_batch`'s), and
`limiter_apply` the JAX package's host interface to it.
`DeviceStreamingLimiter` is the streaming add's: the reference's block
protocol with its state on the device, equal bit for bit to
`StreamingLimiter`, the plain numpy form, which carries the same state on
the host and is held to the JAX package's streaming limiter.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve


def limit_blocks(mixed: torch.Tensor, ceiling: torch.Tensor,
                 block_size: int, n_channels: int) -> torch.Tensor:
    """Whole-signal look-ahead limiter over interleaved samples (..., n)
    f32, each row limited on its own (any length; the last block is
    zero-padded and the padding cut off), with `ceiling` a 0-d f32 tensor
    on their device."""
    vpb = block_size * n_channels
    lead, n = mixed.shape[:-1], mixed.shape[-1]
    n_blocks = -(-n // vpb)
    mb = torch.cat([mixed, mixed.new_zeros(lead + (n_blocks * vpb - n,))],
                   dim=-1)
    xb = mb.reshape(lead + (n_blocks, vpb))
    maxes = torch.maximum(torch.amax(torch.abs(xb), dim=-1), ceiling)
    edge = ceiling.expand(lead + (1,))
    prev = torch.cat([edge, maxes[..., :-1]], dim=-1)
    nxt = torch.cat([maxes[..., 1:], edge], dim=-1)
    s0 = ceiling / torch.maximum(prev, maxes)
    s1 = ceiling / torch.maximum(maxes, nxt)
    # the gain ramp as the JAX package's jitted limiter rounds it: XLA
    # divides by the constant block size as a multiply by its float32
    # reciprocal, and fuses s0 + i*step into one multiply-add, rounded
    # once (i*step is exact in float64)
    step = (s1 - s0) * (torch.ones((), device=mixed.device) / block_size)
    i = torch.arange(block_size, dtype=torch.float64, device=mixed.device)
    scale = (s0.double()[..., None] + i * step.double()[..., None]).float()
    out = xb.reshape(lead + (n_blocks, block_size, n_channels)) \
        * scale[..., None]
    return out.reshape(lead + (n_blocks * vpb,))[..., :n]


def limiter_apply(samples: np.ndarray, n_channels: int, sample_rate: int,
                  block_size_ms: float = 1000, ceiling: float = 0.99,
                  device: DeviceLike = None) -> np.ndarray:
    """Whole-signal limiter of interleaved host samples, computed on
    `device` (default: the CUDA card); the same output as the streamed
    reference, whose trailing zero padding pushes the last partial block
    through."""
    dev = resolve(device)
    x = torch.as_tensor(np.asarray(samples, np.float32).reshape(-1),
                        device=dev)
    block_size = sample_rate * int(block_size_ms) // 1000
    return limit_blocks(x, torch.tensor(ceiling, dtype=torch.float32,
                                        device=dev),
                        block_size, n_channels).cpu().numpy()


class StreamingLimiter:
    """Stateful streaming limiter with the reference's exact block protocol
    (process/skip/flush), vectorized per call."""

    def __init__(self, n_channels: int, sample_rate: int,
                 block_size_ms: float = 1000, ceiling: float = 0.99):
        self.n_channels = n_channels
        self.block_size = sample_rate * int(block_size_ms) // 1000
        self.ceiling = float(ceiling)
        self.buffer = np.zeros(0, dtype=np.float32)
        self.block_max_last = 0.0

    def process(self, samples: np.ndarray) -> np.ndarray:
        self.buffer = np.concatenate([self.buffer,
                                      np.asarray(samples, np.float32)])
        vpb = self.block_size * self.n_channels
        buffered_blocks = self.buffer.size // vpb
        if buffered_blocks < 2:
            return np.zeros(0, dtype=np.float32)
        todo = buffered_blocks - 1
        x = self.buffer[: (todo + 1) * vpb].reshape(todo + 1, vpb)
        maxes = np.maximum(np.max(np.abs(x), axis=1), self.ceiling)
        prev = np.concatenate([[max(self.block_max_last, self.ceiling)],
                               maxes[:-1]])
        out = np.empty(todo * vpb, dtype=np.float32)
        i = np.arange(self.block_size, dtype=np.float32)
        for b in range(todo):
            start = self.ceiling / max(prev[b], maxes[b])
            end = self.ceiling / max(maxes[b], maxes[b + 1])
            step = (end - start) / self.block_size
            scale = (start + i * step).astype(np.float32)
            blk = x[b].reshape(self.block_size, self.n_channels)
            out[b * vpb:(b + 1) * vpb] = (blk * scale[:, None]).reshape(-1)
        self.block_max_last = maxes[todo - 1]
        self.buffer = self.buffer[todo * vpb:].copy()
        return out

    def skip(self, zeros: int) -> int:
        """Fast path for a zero lead-in (reference: src/limiter.cc:69-88)."""
        vpb = self.block_size * self.n_channels
        buffer_size = self.buffer.size + zeros * self.n_channels
        buffered_blocks = buffer_size // vpb
        if buffered_blocks < 2:
            self.buffer = np.zeros(buffer_size, dtype=np.float32)
            return 0
        todo = buffered_blocks - 1
        self.buffer = np.zeros(buffer_size - todo * vpb, dtype=np.float32)
        return todo * self.block_size

    def flush(self) -> np.ndarray:
        out = []
        todo = self.buffer.size
        zblock = np.zeros(1024 * self.n_channels, dtype=np.float32)
        while todo > 0:
            block = self.process(zblock)
            if block.size > todo:
                block = block[:todo]
            out.append(block)
            todo -= block.size
        return (np.concatenate(out) if out
                else np.zeros(0, dtype=np.float32))


class DeviceStreamingLimiter:
    """`StreamingLimiter` on `device`: the same process/skip/flush protocol
    and one block of latency, with the buffer a device tensor and
    `block_max_last` a 0-d device tensor.  The samples a call returns
    follow from sizes alone, so no call waits for the device.

    The gain ramp is rounded as numpy >= 2 rounds the plain form, which is
    not `limit_blocks`' rounding: `end` = ceiling / max(M[b], M[b+1]) in
    float32, and a block's start, step and `start + i*step` in float32 too,
    except on the first call that emits blocks (numpy's `prev` is then a
    float64 array), where a block after the first whose previous maximum
    is not below its own takes its start (from the float64 ceiling), step
    and ramp in float64, each op rounded on its own, then the ramp cast to
    float32.  Every divisor is a device tensor: CUDA divides by a host
    scalar as a multiply by its reciprocal."""

    def __init__(self, n_channels: int, sample_rate: int,
                 block_size_ms: float = 1000, ceiling: float = 0.99,
                 device: DeviceLike = None):
        dev = resolve(device)
        self.n_channels = n_channels
        self.block_size = sample_rate * int(block_size_ms) // 1000
        self.ceiling = float(ceiling)
        self.buffer = torch.zeros(0, dtype=torch.float32, device=dev)
        self.block_max_last = torch.zeros((), dtype=torch.float32,
                                          device=dev)
        self._first = True
        self._ceiling = torch.tensor(self.ceiling, dtype=torch.float32,
                                     device=dev)
        self._ceiling64 = torch.tensor(self.ceiling, dtype=torch.float64,
                                       device=dev)
        self._size = torch.tensor(float(self.block_size),
                                  dtype=torch.float32, device=dev)
        self._i = torch.arange(self.block_size, dtype=torch.float32,
                               device=dev)

    def process(self, samples: torch.Tensor) -> torch.Tensor:
        self.buffer = torch.cat([self.buffer, samples])
        vpb = self.block_size * self.n_channels
        buffered_blocks = self.buffer.shape[0] // vpb
        if buffered_blocks < 2:
            return self.buffer.new_zeros(0)
        todo = buffered_blocks - 1
        x = self.buffer[: (todo + 1) * vpb].reshape(todo + 1, vpb)
        c = self._ceiling
        maxes = torch.maximum(torch.amax(torch.abs(x), dim=1), c)
        here = maxes[:todo]
        prev = torch.cat([torch.maximum(self.block_max_last, c)[None],
                          maxes[:todo - 1]])
        start = c / torch.maximum(prev, here)
        end = c / torch.maximum(here, maxes[1:])
        step = (end - start) / self._size
        scale = start[:, None] + self._i * step[:, None]
        if self._first:
            wide = here <= prev
            wide[0] = False
            start64 = self._ceiling64 / prev.double()
            step64 = (end.double() - start64) / self._size.double()
            ramp64 = start64[:, None] + self._i.double() * step64[:, None]
            scale = torch.where(wide[:, None], ramp64.float(), scale)
        out = x[:todo].reshape(todo, self.block_size, self.n_channels) \
            * scale[:, :, None]
        self.block_max_last = maxes[todo - 1]
        self.buffer = self.buffer[todo * vpb:]
        self._first = False
        return out.reshape(-1)

    def skip(self, zeros: int) -> int:
        """Fast path for a zero lead-in (reference: src/limiter.cc:69-88)."""
        vpb = self.block_size * self.n_channels
        buffer_size = self.buffer.shape[0] + zeros * self.n_channels
        buffered_blocks = buffer_size // vpb
        todo = max(buffered_blocks - 1, 0)
        self.buffer = self.buffer.new_zeros(buffer_size - todo * vpb)
        return todo * self.block_size

    def flush(self) -> torch.Tensor:
        out = []
        todo = self.buffer.shape[0]
        zblock = self.buffer.new_zeros(1024 * self.n_channels)
        while todo > 0:
            block = self.process(zblock)[:todo]
            out.append(block)
            todo -= block.shape[0]
        return torch.cat(out) if out else self.buffer.new_zeros(0)

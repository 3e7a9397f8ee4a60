"""The plain reference of marking: the samples `add` must write.

Upstream audiowmark's add (src/wmadd.cc, src/limiter.cc, src/resample.cc)
as one whole-signal computation, written from the upstream semantics:

1. input at another rate is resampled to 44.1 kHz by a windowed sinc with
   zero group delay (zita-resampler's protocol, src/resample.cc:30-50);
2. frames of 1024 samples, the first frame taken to be frame
   2 * frames_per_block - frames_pad_start of the A/B layout, so the first
   A block starts 250 frames in;
3. per frame and channel, on the marked bins, delta = X * (|X|^(-wd * s) -
   1), s = +1 up, -1 down, 0 where |X| <= 1e-7; inverse FFT unnormalised;
4. overlap-add over three frames with the synthesis window, so the delta
   of frame j is D[j+1] w0 + D[j] w1 + D[j-1] w2;
5. the delta resampled back to the input rate, added to the input;
6. the look-ahead limiter: 1 s blocks, the gain ramping linearly from
   ceiling / max(M[b-1], M[b]) to ceiling / max(M[b], M[b+1]), M[b] =
   max(|x| over block b, ceiling), the ceiling before the first block and
   after the last;
7. the 16-bit writer's trunc-clip: trunc(x * 2^31) clipped to int32, then
   the top 16 bits.

Everything runs in the precision `prec` on `device`, in blocks of frames
so that it fits beside nothing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import keyed
from .dsp import window
from .keyed import Geom
from .prec import Prec

HLEN = 16
_ROWS = 1 << 15          # output samples per resampler block


def _filter(ratio: float):
    fr = min(1.0, ratio)
    half_width = HLEN / fr
    half_taps = -(-int(math.ceil(half_width)) // 8) * 8
    return fr, half_width, half_taps


def resample(x: torch.Tensor, ratio: float, n_out: int,
             prec: Prec) -> torch.Tensor:
    """y[j] = sum_n x[n] h(j / ratio - n) for j < n_out, x zero outside its
    support, h(t) = fr sinc(fr t) blackman(t / half_width), over the
    2 * half_taps inputs n from floor(j / ratio) - half_taps + 1."""
    fr, half_width, half_taps = _filter(ratio)
    n_in, C = x.shape
    dev, dt = x.device, prec.dtype
    hi = int(math.floor((n_out - 1) / ratio)) + half_taps + 2 - n_in
    xpad = torch.cat([x.new_zeros((half_taps, C)), x,
                      x.new_zeros((max(hi, 0) + 1, C))])
    m = torch.arange(2 * half_taps, device=dev, dtype=torch.int64)
    out = []
    for j0 in range(0, n_out, _ROWS):
        j = torch.arange(j0, min(j0 + _ROWS, n_out), device=dev,
                         dtype=torch.float64)
        p = j / ratio
        ip = torch.floor(p)
        n = ip.to(torch.int64)[:, None] - (half_taps - 1) + m[None, :]
        t = (p[:, None] - n.to(torch.float64)).to(dt)
        a = t / half_width
        win = torch.where(torch.abs(a) >= 1.0, torch.zeros_like(a),
                          0.42 + 0.5 * torch.cos(math.pi * a)
                          + 0.08 * torch.cos(2 * math.pi * a))
        h = prec.q(fr * torch.sinc(t * fr) * win)
        taps = xpad[n + half_taps]                       # (rows, taps, C)
        out.append(prec.q(torch.einsum("rtc,rt->rc", taps, h)))
    return torch.cat(out)


def delta_frames(x44: torch.Tensor, mods: torch.Tensor, g: Geom,
                 prec: Prec, block: int = 2048) -> torch.Tensor:
    """(n, C) samples at 44.1 kHz, n a multiple of the frame size ->
    (n, C) overlap-added delta; mods (n / frame_size, n_bins) int8."""
    F = g.frame_size
    n, C = x44.shape
    T = n // F
    awin = window(g, "analysis", prec, x44.device)
    swin = window(g, "synthesis", prec, x44.device)
    frames = x44.reshape(T, F, C).transpose(1, 2)         # (T, C, F)
    D = torch.empty_like(frames)
    for t0 in range(0, T, block):
        fr = frames[t0:t0 + block]
        spec = prec.q(torch.fft.rfft(prec.q(fr * awin), dim=-1))
        mag = prec.q(torch.abs(spec))
        sign = mods[t0:t0 + block].to(prec.dtype)[:, None, :]
        factor = prec.q(torch.exp(prec.q(torch.log(torch.clamp_min(
            mag, 1e-7)) * (-g.water_delta) * sign)) - 1.0)
        factor = torch.where((mag > 1e-7) & (sign != 0), factor,
                             torch.zeros_like(factor))
        D[t0:t0 + block] = prec.q(torch.fft.irfft(
            prec.q(spec * factor), n=F, dim=-1) * F)
    z = D.new_zeros((1, C, F))
    nxt = torch.cat([D[1:], z])
    prv = torch.cat([z, D[:-1]])
    delta = prec.q(nxt * swin[:F] + D * swin[F:2 * F] + prv * swin[2 * F:])
    return delta.transpose(1, 2).reshape(n, C)


def limiter(x: torch.Tensor, block_size: int, ceiling: float,
            prec: Prec) -> torch.Tensor:
    n, C = x.shape
    nb = -(-n // block_size)
    xb = torch.cat([x, x.new_zeros((nb * block_size - n, C))]) \
        .reshape(nb, block_size, C)
    maxes = torch.clamp_min(torch.amax(torch.abs(xb), dim=(1, 2)), ceiling)
    ceil = maxes.new_full((1,), ceiling)
    prev = torch.cat([ceil, maxes[:-1]])
    nxt = torch.cat([maxes[1:], ceil])
    s0 = ceiling / torch.maximum(prev, maxes)
    s1 = ceiling / torch.maximum(maxes, nxt)
    i = torch.arange(block_size, device=x.device, dtype=prec.dtype)
    step = (s1 - s0) / block_size
    scale = prec.q(s0[:, None] + i[None, :] * step[:, None])
    return prec.q(xb * scale[:, :, None]).reshape(-1, C)[:n]


def to_int16(x: torch.Tensor) -> np.ndarray:
    """The 16-bit writer's trunc-clip of float samples."""
    v = torch.trunc(x.double() * 2147483648.0)
    v = torch.clamp(v, -2147483648.0, 2147483647.0).to(torch.int64)
    return torch.div(v, 65536, rounding_mode="floor").to(torch.int16) \
        .cpu().numpy()


def mark(samples: np.ndarray, rate: int, key: bytes, bits: np.ndarray,
         g: Geom, prec: Prec, device) -> np.ndarray:
    """int16 (n, C) input -> the int16 (n, C) samples a 16-bit `add` of
    the hex message's `bits` with `key` writes."""
    x = prec.q(torch.from_numpy(np.ascontiguousarray(samples)).to(
        device=device, dtype=prec.dtype) / 32768.0)
    n, C = x.shape
    F = g.frame_size
    mark_rate = g.mark_sample_rate
    if rate != mark_rate:
        ratio = mark_rate / rate
        n44 = int(math.ceil(n * ratio)) + 4 * F
        x44 = resample(x, ratio, n44 + (-n44) % F, prec)
    else:
        x44 = torch.cat([x, x.new_zeros((2 * F - n % F, C))])
    T = x44.shape[0] // F
    lay = keyed.layout(key, g)
    mods_ab = torch.from_numpy(keyed.frame_mods(lay, bits)).to(device)
    fpb2 = 2 * g.frames_per_block
    phase = (fpb2 - g.frames_pad_start + torch.arange(T, device=device)) \
        % fpb2
    delta44 = delta_frames(x44, mods_ab[phase], g, prec)
    if rate != mark_rate:
        delta = resample(delta44, rate / mark_rate, n, prec)
    else:
        delta = delta44[:n]
    block = rate * int(g.limiter_block_size_ms) // 1000
    return to_int16(limiter(prec.q(x + delta), block, g.limiter_ceiling,
                            prec))

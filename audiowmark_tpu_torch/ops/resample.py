"""Windowed-sinc polyphase resampler (zita-compatible timing protocol).

Port of audiowmark_tpu/ops/resample.py.  The reference uses zita-resampler
(hlen=16) with a pre-pad of k/2-1 and a post-pad of k/2 zeros, so
resampling has zero group delay and the output length is exactly
lrint(in_frames * ratio) (src/resample.cc:30-50).  The same observable
protocol, from a windowed sinc:

    y[j] = sum_n x[n] * h(j/ratio - n),   h(t) = fr*sinc(fr*t)*blackman(t/T)

with fr = min(1, ratio) (anti-alias cutoff), T = hlen/fr taps half-width,
and x zero-padded outside its support.

Two coefficient precisions, as in the JAX package: `resample_buffer`
computes its coefficients in float32 (as `_resample_tile`);
`StreamingResampler` computes them in float64 and casts them to float32 (as
the JAX package's host `_coeffs`).  Both run one formula, `_coeffs`, on the
given device, and so do the gather and the weighted sum, one tap at a time
in a fixed order, so output j is the same however the input was split into
writes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..io.wavdata import WavData
from ..params import Params

from ..device import DeviceLike, resolve

HLEN = 16
# output frames per pass: bounds the (J, n_taps) coefficient block
_TILE = 1 << 16


def _filter_params(ratio: float):
    fr = min(1.0, ratio)
    half_width = HLEN / fr                    # taps half-width in input samples
    half_taps = -(-int(np.ceil(half_width)) // 8) * 8
    n_taps = 2 * half_taps
    return fr, half_width, half_taps, n_taps


def _coeffs(frac: torch.Tensor, ratio: float) -> torch.Tensor:
    """Coefficient rows for fractional positions, on frac's device:
    (J, n_taps) float32, computed in frac's dtype.  float64 frac gives the
    JAX package's host `_coeffs` (float64, cast to float32), float32 frac
    its device `_resample_tile`.

    frac[j] in [0,1): position of output j relative to the base input sample
    floor(p_j); tap m covers input offset (m - (half_taps-1)).
    """
    fr, half_width, half_taps, n_taps = _filter_params(ratio)
    dev, dtype = frac.device, frac.dtype
    # 0-dim device tensors, not Python scalars: a CUDA division by a host
    # scalar multiplies by its reciprocal, which may round differently
    fr_t = torch.tensor(fr, dtype=dtype, device=dev)
    m = torch.arange(n_taps, dtype=dtype, device=dev) - (half_taps - 1)
    t = frac[:, None] - m                       # p_j - n, in input samples
    sinc = torch.sinc(t * fr_t)                 # sin(pi x)/(pi x)
    w_arg = t / torch.tensor(half_width, dtype=dtype, device=dev)
    win = torch.where(torch.abs(w_arg) >= 1.0, torch.zeros_like(w_arg),
                      0.42 + 0.5 * torch.cos(math.pi * w_arg)
                      + 0.08 * torch.cos(2 * math.pi * w_arg))
    return (fr_t * sinc * win).to(torch.float32)


def _gather_dot(xpad: torch.Tensor, base: torch.Tensor,
                coeff: torch.Tensor) -> torch.Tensor:
    """y[j, c] = sum_m xpad[base[j] + m, c] * coeff[j, m], summed over m in
    order with one rounded multiply and one rounded add per tap, so y[j]
    does not depend on which other rows share the call."""
    y = torch.zeros((base.shape[0], xpad.shape[1]), dtype=torch.float32,
                    device=xpad.device)
    for m in range(coeff.shape[1]):
        y += xpad.index_select(0, base + m) * coeff[:, m:m + 1]
    return y


def resample_frames(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """Resample (frames, C) float32 frames by `ratio` on x's device;
    returns (round(frames*ratio), C) there."""
    dev = x.device
    in_frames, n_channels = x.shape
    out_frames = int(round(in_frames * ratio))
    if ratio == 1.0:
        out = torch.zeros((out_frames, n_channels), dtype=torch.float32,
                          device=dev)
        n = min(out_frames, in_frames)
        out[:n] = x[:n]
        return out

    _, _, half_taps, n_taps = _filter_params(ratio)
    xpad = torch.zeros((in_frames + n_taps, n_channels), dtype=torch.float32,
                       device=dev)
    xpad[half_taps - 1: half_taps - 1 + in_frames] = x
    # output j centre p_j = j/ratio; the base index into xpad of tap 0 is
    # floor(p_j) - (half_taps-1) + (half_taps-1) [pad offset] = floor(p_j)
    j = np.arange(out_frames, dtype=np.float64)
    p = j / ratio
    ip = np.floor(p)
    frac = torch.from_numpy((p - ip).astype(np.float32)).to(dev)
    base = torch.from_numpy(np.clip(ip.astype(np.int64), 0, in_frames)).to(dev)

    out = torch.empty((out_frames, n_channels), dtype=torch.float32,
                      device=dev)
    for start in range(0, out_frames, _TILE):
        end = min(start + _TILE, out_frames)
        out[start:end] = _gather_dot(xpad, base[start:end],
                                     _coeffs(frac[start:end], ratio))
    return out


def resample_buffer(samples: np.ndarray, n_channels: int, ratio: float,
                    device: DeviceLike = None) -> np.ndarray:
    """Resample interleaved samples by `ratio` on `device`; returns
    interleaved output of round(in_frames*ratio) frames."""
    x = np.asarray(samples, dtype=np.float32).reshape(-1, n_channels)
    out = resample_frames(torch.from_numpy(x).to(resolve(device)), ratio)
    return out.cpu().numpy().reshape(-1)


def resample(wav_data: WavData, rate: int,
             device: DeviceLike = None) -> WavData:
    """Whole-buffer integer-rate resample (reference: src/resample.cc:52-95)."""
    assert rate != wav_data.sample_rate
    ratio = rate / wav_data.sample_rate
    out = resample_buffer(wav_data.samples, wav_data.n_channels, ratio,
                          device=device)
    return WavData(out, wav_data.n_channels, rate, wav_data.bit_depth)


def resample_ratio_truncate(wav_data: WavData, ratio: float, new_rate: int,
                            max_in_seconds: float = -1,
                            device: DeviceLike = None) -> WavData:
    """Arbitrary-ratio resample with optional input truncation
    (reference: src/resample.cc:97-120)."""
    samples = wav_data.samples
    if max_in_seconds > 0:
        limit = wav_data.n_channels * int(
            round(wav_data.sample_rate * max_in_seconds))
        samples = samples[:min(samples.size, limit)]
    out = resample_buffer(samples, wav_data.n_channels, ratio, device=device)
    return WavData(out, wav_data.n_channels, int(new_rate), wav_data.bit_depth)


def resample_ratio(wav_data: WavData, ratio: float, new_rate: int,
                   device: DeviceLike = None) -> WavData:
    return resample_ratio_truncate(wav_data, ratio, new_rate, -1, device)


def _as_frames(frames, n_channels: int, dev: torch.device) -> torch.Tensor:
    if isinstance(frames, torch.Tensor):
        t = frames.to(device=dev, dtype=torch.float32)
    else:
        t = torch.from_numpy(np.asarray(frames, dtype=np.float32)).to(dev)
    return t.reshape(-1, n_channels)


class StreamingResampler:
    """Stateful streaming resampler with the reference's buffered protocol:
    write_frames / can_read_frames / read_frames / write_trailing_frames /
    skip (1-second periodicity fast path).  The counters are host ints; the
    input history and the output buffer are tensors on `device`, and
    read_frames returns a tensor there."""

    def __init__(self, n_channels: int, old_rate: int, new_rate: int,
                 device: DeviceLike = None):
        self.device = resolve(device)
        self.n_channels = n_channels
        self.old_rate = old_rate
        self.new_rate = new_rate
        self.ratio = new_rate / old_rate
        _, _, self.half_taps, self.n_taps = _filter_params(self.ratio)
        # input history: absolute input frame index of hist[0]
        self.hist = torch.zeros((0, n_channels), dtype=torch.float32,
                                device=self.device)
        self.hist_start = 0          # absolute index of hist[0]
        self.in_total = 0            # absolute input frames written
        self.next_out = 0            # next output frame index to produce
        self.out_buffer = torch.zeros(0, dtype=torch.float32,
                                      device=self.device)

    def inpsize(self) -> int:
        return self.n_taps

    def write_frames(self, frames):
        """Append input frames (interleaved numpy array or tensor)."""
        x = _as_frames(frames, self.n_channels, self.device)
        self.hist = torch.cat([self.hist, x])
        self.in_total += x.shape[0]
        self._produce()

    def write_trailing_frames(self):
        self.write_frames(
            np.zeros((self.n_taps // 2) * self.n_channels, dtype=np.float32))

    def _produce(self):
        # output j needs input taps up to floor(j/ratio) + half_taps; it is
        # computable once that index is <= in_total - 1, i.e.
        # j * old_rate < (in_total - half_taps) * new_rate (exact integers)
        avail = (self.in_total - self.half_taps) * self.new_rate
        max_out = (avail - 1) // self.old_rate + 1 if avail > 0 else 0
        n_new = max_out - self.next_out
        if n_new <= 0:
            return
        j = self.next_out + np.arange(n_new, dtype=np.float64)
        p = j / self.ratio
        ip = np.floor(p)
        frac = p - ip
        base = ip.astype(np.int64) - (self.half_taps - 1) - self.hist_start
        # pad the history so negative bases (start of stream) read zeros
        pad_lo = max(0, -int(base.min()))
        pad_hi = max(0, int(base.max()) + self.n_taps - self.hist.shape[0])
        xp = torch.nn.functional.pad(self.hist, (0, 0, pad_lo, pad_hi))
        base_dev = torch.from_numpy(base + pad_lo).to(self.device)
        frac_dev = torch.from_numpy(frac).to(self.device)
        ys = [_gather_dot(xp, base_dev[s:s + _TILE],
                          _coeffs(frac_dev[s:s + _TILE], self.ratio))
              for s in range(0, n_new, _TILE)]
        self.out_buffer = torch.cat([self.out_buffer] +
                                    [y.reshape(-1) for y in ys])
        self.next_out = max_out
        # drop history no longer needed
        min_base = int(np.floor(self.next_out / self.ratio)) \
            - (self.half_taps - 1)
        drop = min(max(0, min_base - self.hist_start), self.hist.shape[0])
        if drop > 0:
            self.hist = self.hist[drop:]
            self.hist_start += drop

    def can_read_frames(self) -> int:
        return self.out_buffer.shape[0] // self.n_channels

    def read_frames(self, frames: int) -> torch.Tensor:
        n = frames * self.n_channels
        assert n <= self.out_buffer.shape[0]
        out = self.out_buffer[:n]
        self.out_buffer = self.out_buffer[n:]
        return out

    def skip(self, zeros: int) -> int:
        """Skip a zero lead-in using 1-second periodicity
        (reference: src/resample.cc:150-167)."""
        seconds = 0
        if zeros >= Params.frame_size:
            seconds = (zeros - Params.frame_size) // self.old_rate
        extra = self.new_rate * seconds
        zeros -= self.old_rate * seconds
        # fast-forward the absolute counters by whole seconds (the state is
        # periodic in them)
        self.in_total += self.old_rate * seconds
        self.hist_start += self.old_rate * seconds
        self.next_out += self.new_rate * seconds
        self.write_frames(np.zeros(zeros * self.n_channels, dtype=np.float32))
        out = self.can_read_frames() + extra
        out -= out % Params.frame_size
        consume = out - extra
        if consume >= 0:
            self.read_frames(consume)
        else:
            # frame rounding dipped into the virtually skipped whole seconds;
            # those output frames sit deep inside the zero lead-in (>= 1 s
            # of zero history, far beyond the filter taps), so they are
            # exactly zero: put them in front instead of consuming a
            # negative count (the reference's size_t arithmetic would crash
            # here, src/resample.cc:163-165)
            self.out_buffer = torch.cat([
                self.out_buffer.new_zeros(-consume * self.n_channels),
                self.out_buffer])
        return out

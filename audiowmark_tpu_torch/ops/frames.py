"""Frame-level DSP: analysis/synthesis windows and the whole-file add core.

Port of audiowmark_tpu/ops/frames.py.  Reference behavior:
* analysis window — sum-normalized (x2) Hann (src/wmcommon.cc:68-89)
* delta spectrum — delta = fft * (|fft|^(-wd*sign) - 1) on marked bins with a
  1e-7 magnitude guard (src/wmadd.cc:61-84)
* synthesis — ifft + overlap-add over 3 frames with a cosine-flattened
  triangular window, 10% overlap (src/wmadd.cc:169-250)
* limiter — 1 s blocks, linear gain ramps (src/limiter.cc)

`add_file_core` is plain PyTorch on the device: window -> rfft -> delta on
the keyed bins -> irfft -> 3-frame overlap-add -> mix -> limiter -> int16
trunc-clip, in one pass over the whole file.  `embed_delta_frames` is the
streaming add's tile step: the same delta and overlap-add, with the last
two iffts carried on the device from tile to tile.  FFTW's unnormalized
c2r is matched as irfft * FRAME.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..params import Params

FRAME = Params.frame_size
N_BINS = FRAME // 2 + 1
MIN_DB = -96.0
_LOG2_DB = 3.01029995663981  # 10 / log2(10)


@lru_cache(maxsize=None)
def analysis_window() -> np.ndarray:
    """Sum-normalized Hann analysis window, float32 (n = frame_size)."""
    n = FRAME
    i = np.arange(n, dtype=np.float64)
    x = (i - n / 2.0) / (n / 2.0)
    win = np.where(np.abs(x) > 1, 0.0, 0.5 * np.cos(x * np.pi) + 0.5)
    win *= 2.0 / win.sum()
    return win.astype(np.float32)


@lru_cache(maxsize=None)
def synthesis_window() -> np.ndarray:
    """Cosine-flattened triangular synthesis window over 3 frames, float32."""
    n = 3 * FRAME
    i = np.arange(n, dtype=np.float64)
    overlap = 0.1
    norm_pos = (i - FRAME) / FRAME
    norm_pos = np.where(norm_pos > 0.5, 1.0 - norm_pos, norm_pos)
    tri = np.where(norm_pos < -overlap, 0.0,
                   np.where(norm_pos < overlap,
                            0.5 + norm_pos / (2 * overlap), 1.0))
    win = (np.cos(tri * np.pi + np.pi) + 1.0) * 0.5
    return win.astype(np.float32)


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def limiter_apply(mixed: torch.Tensor, ceiling: torch.Tensor,
                  block_size: int, n_channels: int) -> torch.Tensor:
    """Whole-signal look-ahead limiter over interleaved samples: per block b
    the gain ramps from ceiling/max(M[b-1], M[b]) to ceiling/max(M[b],
    M[b+1]), M[b] = max(|x| over block b, ceiling) (src/limiter.cc)."""
    vpb = block_size * n_channels
    n = mixed.shape[0]
    n_blocks = -(-n // vpb)
    mb = torch.cat([mixed, mixed.new_zeros(n_blocks * vpb - n)])
    xb = mb.reshape(n_blocks, vpb)
    maxes = torch.maximum(torch.amax(torch.abs(xb), dim=1), ceiling)
    prev = torch.cat([ceiling[None], maxes[:-1]])
    nxt = torch.cat([maxes[1:], ceiling[None]])
    s0 = ceiling / torch.maximum(prev, maxes)
    s1 = ceiling / torch.maximum(maxes, nxt)
    step = (s1 - s0) / block_size
    i = torch.arange(block_size, dtype=torch.float32, device=mixed.device)
    scale = s0[:, None] + i[None, :] * step[:, None]
    out = (xb.reshape(n_blocks, block_size, n_channels)
           * scale[:, :, None]).reshape(-1)
    return out[:n]


def _delta_iffts(frames: torch.Tensor, mods: torch.Tensor,
                 water_delta: float, awin: torch.Tensor) -> torch.Tensor:
    """(T, C, FRAME) frames, (T, N_BINS) int8 mods -> the (T, C, FRAME)
    delta frames before overlap-add: window -> rfft -> mag^(-wd*sign) - 1
    on marked bins (1e-7 magnitude guard) -> irfft * FRAME (FFTW's
    unnormalized c2r)."""
    spec = torch.fft.rfft(frames * awin, dim=-1)          # (T, C, N_BINS)
    mag = torch.abs(spec)
    sign = mods.to(torch.float32)[:, None, :]
    safe_mag = torch.clamp_min(mag, 1e-7)
    factor = torch.exp(torch.log(safe_mag) * _f32(-water_delta, frames)
                       * sign) - 1.0
    factor = torch.where((mag > 1e-7) & (sign != 0), factor,
                         torch.zeros_like(factor))
    return torch.fft.irfft(spec * factor, n=FRAME, dim=-1) * FRAME


def embed_delta_frames(frames: torch.Tensor, mods: torch.Tensor,
                       water_delta: float, awin: torch.Tensor,
                       swin: torch.Tensor, prev1=None, prev2=None):
    """Streaming delta overlap-add for a tile of frames k0..k0+T-1
    (audiowmark_tpu ops/frames._embed_delta_core).

    frames: (T, C, FRAME) float32, deinterleaved input frames;
    mods: (T, N_BINS) int8; prev1/prev2: (C, FRAME) iffts of frames k0-1
    and k0-2 (the carry; None at the stream start means zeros).
    Emits the overlap-add output frames j = k0-1 .. k0+T-2, one per input
    frame (the synth's one-frame latency):
        out[j] = W0*D[j+1] + W1*D[j] + W2*D[j-1]
    Returns (out (T, C, FRAME), new prev1, new prev2)."""
    C = frames.shape[1]
    if prev1 is None:
        prev1 = frames.new_zeros((C, FRAME))
    if prev2 is None:
        prev2 = frames.new_zeros((C, FRAME))
    iffts = _delta_iffts(frames, mods, water_delta, awin)
    ext = torch.cat([prev2[None], prev1[None], iffts], dim=0)
    out = ext[2:] * swin[:FRAME] + ext[1:-1] * swin[FRAME:2 * FRAME] \
        + ext[:-2] * swin[2 * FRAME:]
    return out, iffts[-1], ext[-2]


def add_file_core(x: torch.Tensor, mods: torch.Tensor, water_delta: float,
                  awin: torch.Tensor, swin: torch.Tensor, n_channels: int,
                  n_out: int, no_limiter: bool, out_i16: bool,
                  block_size: int, ceiling: float = Params.limiter_ceiling
                  ) -> torch.Tensor:
    """Whole-file add: embed delta -> mix -> limiter -> quantize
    (audiowmark_tpu ops/frames._add_file_core).

    x: (n_frames*FRAME*n_channels,) float32, interleaved, input zero-padded
       to whole frames.
    mods: (n_frames, N_BINS) int8, +1 up / -1 down / 0 keep.
    Returns (n_out,) int16 (the exact trunc-clip quantization of a 16-bit
    wav writer) or float32.
    """
    n_frames = mods.shape[0]
    frames = x.reshape(n_frames, FRAME, n_channels).transpose(1, 2)
    iffts = _delta_iffts(frames, mods, water_delta, awin)

    # streamed alignment: delta frame j = D[j+1]*w0 + D[j]*w1 + D[j-1]*w2
    # (one-frame synth latency, first emitted frame dropped)
    w0 = swin[:FRAME]
    w1 = swin[FRAME:2 * FRAME]
    w2 = swin[2 * FRAME:]
    zero = iffts.new_zeros((1, n_channels, FRAME))
    nxt = torch.cat([iffts[1:], zero], dim=0)
    prv = torch.cat([zero, iffts[:-1]], dim=0)
    delta = nxt * w0 + iffts * w1 + prv * w2

    mixed = x + delta.transpose(1, 2).reshape(-1)
    if not no_limiter:
        mixed = limiter_apply(mixed, _f32(ceiling, x), block_size,
                              n_channels)

    mixed = mixed[:n_out]
    if not out_i16:
        return mixed
    # exact trunc-clip of io/converters.float_to_int_clip32, then >> 16;
    # 2147483647.0 rounds to 2^31 in float32, as in the writer
    snorm = mixed * _f32(2147483648.0, x)
    i32 = torch.where(
        snorm >= _f32(2147483647.0, x),
        torch.full_like(snorm, 2147483647, dtype=torch.int32),
        torch.where(snorm <= _f32(-2147483648.0, x),
                    torch.full_like(snorm, -2147483648, dtype=torch.int32),
                    torch.trunc(snorm).to(torch.int32)))
    return (i32 >> 16).to(torch.int16)

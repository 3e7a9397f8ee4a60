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
trunc-clip, in one pass over the whole file (the delta's FFTs in calls of
DELTA_FRAMES frames, as on every add path).  `embed_delta_frames` is the
streaming add's tile step: the same delta and overlap-add, with the last
two iffts carried on the device from tile to tile.  `overlap_add` is the
one 3-frame overlap-add of every add path, the sharded batch embed's
included.  FFTW's unnormalized c2r is matched as irfft * FRAME.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..params import Params

from ..device import DeviceLike, resolve
from .limiter import limit_blocks

FRAME = Params.frame_size
N_BINS = FRAME // 2 + 1
MIN_DB = -96.0
_LOG2_DB = 3.01029995663981  # 10 / log2(10)
# frames per call of the delta's FFTs (_delta_iffts).  On an H100,
# cuFFT's rfft and irfft of 1024 points give other bits at a batch of up
# to 1024 rows than at 2048 rows and more; from 1024 stereo frames on,
# every batch gives each row the same bits (tile_probe.py stages)
DELTA_FRAMES = 1024


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


def _spectrum(frames: torch.Tensor, awin: torch.Tensor) -> torch.Tensor:
    """(T, C, FRAME) frames -> (T, C, N_BINS) rfft of the windowed frames."""
    return torch.fft.rfft(frames * awin, dim=-1)


def _delta_spectrum(spec: torch.Tensor, mods: torch.Tensor,
                    water_delta: float) -> torch.Tensor:
    """spec * (mag^(-wd*sign) - 1) on the marked bins of (T, N_BINS) int8
    mods, with a 1e-7 magnitude guard; 0 elsewhere."""
    mag = torch.abs(spec)
    sign = mods.to(torch.float32)[:, None, :]
    safe_mag = torch.clamp_min(mag, 1e-7)
    factor = torch.exp(torch.log(safe_mag) * _f32(-water_delta, mag)
                       * sign) - 1.0
    factor = torch.where((mag > 1e-7) & (sign != 0), factor,
                         torch.zeros_like(factor))
    return spec * factor


def _synthesis(dspec: torch.Tensor) -> torch.Tensor:
    """irfft * FRAME (FFTW's unnormalized c2r) of (T, C, N_BINS) spectra."""
    return torch.fft.irfft(dspec, n=FRAME, dim=-1) * FRAME


def _delta_iffts(frames: torch.Tensor, mods: torch.Tensor,
                 water_delta: float, awin: torch.Tensor) -> torch.Tensor:
    """(T, C, FRAME) frames, (T, N_BINS) int8 mods -> the (T, C, FRAME)
    delta frames before overlap-add: window -> rfft -> mag^(-wd*sign) - 1
    on marked bins (1e-7 magnitude guard) -> irfft * FRAME.

    The frames go through in calls of exactly DELTA_FRAMES frames, the
    last one filled up with zero frames (their delta is exactly zero and
    is cut off): cuFFT's rows at one batch size may differ in the last bit
    from the same rows at another, and this way every add path, whatever
    its tiles, gives each frame the same bits."""
    n = frames.shape[0]
    padded = -(-n // DELTA_FRAMES) * DELTA_FRAMES
    if padded != n:
        frames = torch.cat([frames, frames.new_zeros(
            (padded - n,) + frames.shape[1:])])
        mods = torch.cat([mods, mods.new_zeros((padded - n, mods.shape[1]))])
    out = frames.new_empty(frames.shape)
    for s in range(0, padded, DELTA_FRAMES):
        e = s + DELTA_FRAMES
        out[s:e] = _synthesis(_delta_spectrum(
            _spectrum(frames[s:e], awin), mods[s:e], water_delta))
    return out[:n]


def overlap_add(ext: torch.Tensor, swin: torch.Tensor) -> torch.Tensor:
    """The synthesis's 3-frame overlap-add: ext (..., T + 2, C, FRAME),
    the delta iffts of T frames with the one before them and the one after
    them stacked along the frame axis -> the (..., T, C, FRAME) output
    frames out[j] = W0*D[j+1] + W1*D[j] + W2*D[j-1], W0, W1, W2 the thirds
    of the synthesis window `swin`."""
    return ext[..., 2:, :, :] * swin[:FRAME] \
        + ext[..., 1:-1, :, :] * swin[FRAME:2 * FRAME] \
        + ext[..., :-2, :, :] * swin[2 * FRAME:]


def window_tensors(device: torch.device):
    """The analysis and synthesis windows as tensors on `device`, made
    once per device; callers must not write to them."""
    hit = _window_tensors.get(device)
    if hit is None:
        hit = (torch.from_numpy(analysis_window()).to(device),
               torch.from_numpy(synthesis_window()).to(device))
        _window_tensors[device] = hit
    return hit


_window_tensors = {}


def embed_delta_frames(frames, mods, water_delta: float, prev1=None,
                       prev2=None, device: DeviceLike = None):
    """Streaming delta overlap-add for a tile of frames k0..k0+T-1
    (audiowmark_tpu ops/frames.embed_delta_frames), on `device` (default:
    the CUDA card); numpy or tensors in, tensors out.

    frames: (T, C, FRAME) float32, deinterleaved input frames;
    mods: (T, N_BINS) int8; prev1/prev2: (C, FRAME) iffts of frames k0-1
    and k0-2 (the carry; None at the stream start means zeros).
    Emits the overlap-add output frames j = k0-1 .. k0+T-2, one per input
    frame (the synth's one-frame latency).
    Returns (out (T, C, FRAME), new prev1, new prev2)."""
    dev = resolve(device)
    frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    mods = torch.as_tensor(mods, device=dev)
    awin, swin = window_tensors(dev)
    C = frames.shape[1]
    prev1 = frames.new_zeros((C, FRAME)) if prev1 is None \
        else torch.as_tensor(prev1, device=dev)
    prev2 = frames.new_zeros((C, FRAME)) if prev2 is None \
        else torch.as_tensor(prev2, device=dev)
    iffts = _delta_iffts(frames, mods, water_delta, awin)
    ext = torch.cat([prev2[None], prev1[None], iffts], dim=0)
    return overlap_add(ext, swin), iffts[-1], ext[-2]


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

    # streamed alignment (one-frame synth latency, first emitted frame
    # dropped): zero frames before the first and after the last
    zero = iffts.new_zeros((1, n_channels, FRAME))
    delta = overlap_add(torch.cat([zero, iffts, zero], dim=0), swin)

    mixed = x + delta.transpose(1, 2).reshape(-1)
    if not no_limiter:
        mixed = limit_blocks(mixed, _f32(ceiling, x), block_size,
                             n_channels)

    mixed = mixed[:n_out]
    return quantize_i16(mixed) if out_i16 else mixed


def quantize_i16(mixed: torch.Tensor) -> torch.Tensor:
    """float32 samples -> the int16 a 16-bit signed PCM writer makes of
    them (io/wavfile.encode_samples): the exact trunc-clip of
    io/converters.float_to_int_clip32, then >> 16, on their device."""
    # 2147483647.0 rounds to 2^31 in float32, as in the writer
    snorm = mixed * _f32(2147483648.0, mixed)
    i32 = torch.where(
        snorm >= _f32(2147483647.0, mixed),
        torch.full_like(snorm, 2147483647, dtype=torch.int32),
        torch.where(snorm <= _f32(-2147483648.0, mixed),
                    torch.full_like(snorm, -2147483648, dtype=torch.int32),
                    torch.trunc(snorm).to(torch.int32)))
    return (i32 >> 16).to(torch.int16)



def db_bands(windows: torch.Tensor, awin: torch.Tensor) -> torch.Tensor:
    """(..., FRAME) samples -> (..., N_BANDS) dB of the windowed rfft over
    bands [min_band, max_band]; -96 dB where the power is 0."""
    spec = torch.fft.rfft(windows * awin, dim=-1)
    spec = spec[..., Params.min_band:Params.max_band + 1]
    abs2 = spec.real ** 2 + spec.imag ** 2
    return torch.where(abs2 > 0, torch.log2(abs2) * _LOG2_DB,
                       torch.full_like(abs2, MIN_DB))


def db_spectrogram(frames, device: DeviceLike = None) -> torch.Tensor:
    """(T, C, FRAME) frames -> (T, N_BANDS) dB spectrogram over bands
    [min_band, max_band], summed over the channels, on `device` (default:
    the CUDA card)."""
    dev = resolve(device)
    frames = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    return torch.sum(db_bands(frames, window_tensors(dev)[0]), dim=1)


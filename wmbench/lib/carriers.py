"""Test carriers: the `music`, `speech` and `chords` generators of
audiowmark_tpu_torch/ber_row.py (byte-equal to tools/ber_report.py's),
copied and moved onto the device.

The formulas and the order of the random draws are the originals'; the
draws come from numpy's RandomState(`seed`) as before, with the seed a
parameter (the originals fix it: music 1234, speech 77, chords 4242),
and the sample arithmetic runs in float64 torch on `device`, so that a run
makes minutes of audio in a fraction of a second.  Each returns (n, 2)
float64 stereo scaled to `peak`.
"""

from __future__ import annotations

import numpy as np
import torch


def _stereo(left: torch.Tensor, right: torch.Tensor,
            peak: float) -> torch.Tensor:
    x = torch.stack([left, right], dim=1)
    m = torch.max(torch.abs(x))
    return x * (peak / m) if float(m) > 0 else x


def music(seconds: float, rate: int, seed: int, peak: float,
          device) -> torch.Tensor:
    """Pentatonic harmonic stacks with percussion ticks (gen_tonal)."""
    rng = np.random.RandomState(seed)
    n = int(seconds * rate)
    t = torch.arange(n, dtype=torch.float64, device=device) / rate
    scale = 220.0 * 2.0 ** (np.array([0, 2, 4, 7, 9, 12, 14, 16]) / 12.0)
    note_len = 0.5
    left = torch.zeros(n, dtype=torch.float64, device=device)
    right = torch.zeros_like(left)
    h = torch.arange(1, 7, dtype=torch.float64, device=device)[:, None]
    for k in range(int(np.ceil(seconds / note_len))):
        f0 = scale[rng.randint(0, scale.size)]
        i0 = int(k * note_len * rate)
        i1 = min(int((k + 1) * note_len * rate), n)
        seg = t[i0:i1] - t[i0]
        env = torch.clamp_max(seg / 0.02, 1.0) * torch.exp(-seg * 3.0)
        for out, detune in ((left, 1.0), (right, 1.003)):
            ph = torch.from_numpy(rng.uniform(0, 2 * np.pi, 6)).to(device)
            tone = torch.sum(torch.sin(2 * np.pi * f0 * detune * h * seg
                                       + ph[:, None]) / h, dim=0)
            out[i0:i1] += env * tone
    nb = int(0.02 * rate)
    decay = torch.exp(-torch.arange(nb, dtype=torch.float64,
                                    device=device) / (0.004 * rate))
    for k in range(int(seconds / 0.25)):         # percussion ticks
        i0 = int(k * 0.25 * rate)
        if i0 + nb > n:
            break
        burst = torch.from_numpy(rng.randn(nb)).to(device) * decay
        left[i0:i0 + nb] += 0.4 * burst
        right[i0:i0 + nb] += 0.4 * burst
    return _stereo(left, right, peak)


def speech(seconds: float, rate: int, seed: int, peak: float,
           device) -> torch.Tensor:
    """A 120 Hz harmonic buzz through three formant resonances, syllabic
    3 Hz AM and phrase pauses (gen_speech)."""
    rng = np.random.RandomState(seed)
    n = int(seconds * rate)
    t = torch.arange(n, dtype=torch.float64, device=device) / rate
    buzz = torch.zeros(n, dtype=torch.float64, device=device)
    for h in range(1, 60):
        f = 120.0 * h
        if f > 6000:
            break
        buzz += torch.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)) / h
    noise = torch.from_numpy(rng.randn(n)).to(device)
    spec = torch.fft.rfft(buzz + 0.05 * noise)
    freqs = torch.fft.rfftfreq(n, 1.0 / rate, dtype=torch.float64,
                               device=device)
    gain = torch.zeros_like(freqs)
    for fc, bw, g in ((700, 130, 1.0), (1200, 180, 0.7), (2600, 300, 0.4)):
        gain += g / (1.0 + ((freqs - fc) / bw) ** 2)
    voiced = torch.fft.irfft(spec * gain, n)
    env = 0.25 + 0.75 * torch.sin(2 * np.pi * 3.0 * t) ** 2
    for k in range(int(seconds / 2.5)):
        p0 = int((k * 2.5 + 2.0 + rng.uniform(-0.2, 0.2)) * rate)
        env[p0: p0 + int(0.5 * rate)] *= 0.02
    voiced = voiced * env
    return _stereo(voiced, torch.roll(voiced, 7), peak)


def chords(seconds: float, rate: int, seed: int, peak: float,
           device) -> torch.Tensor:
    """Sustained polyphonic triads, one chord per 2 s bar (gen_chords)."""
    rng = np.random.RandomState(seed)
    n = int(seconds * rate)
    t = torch.arange(n, dtype=torch.float64, device=device) / rate
    left = torch.zeros(n, dtype=torch.float64, device=device)
    right = torch.zeros_like(left)
    roots = 130.81 * 2.0 ** (np.array([0, 5, 7, 3, 8]) / 12.0)
    h = torch.arange(1, 6, dtype=torch.float64, device=device)[:, None]
    for k in range(int(np.ceil(seconds / 2.0))):
        i0 = int(k * 2.0 * rate)
        i1 = min(int((k + 1) * 2.0 * rate), n)
        seg = t[i0:i1] - t[i0]
        env = torch.clamp_max(seg / 0.3, 1.0) * torch.clamp(
            (2.0 - seg) / 0.3, 0.0, 1.0)
        root = roots[k % roots.size]
        vib = 1.0 + 0.002 * torch.sin(2 * np.pi * 5.0 * seg)
        for iv in (1.0, 2 ** (4 / 12.0), 2 ** (7 / 12.0), 2.0):
            ph = torch.from_numpy(rng.uniform(0, 2 * np.pi, 5)).to(device)
            arg = 2 * np.pi * root * iv * h * seg * vib
            left[i0:i1] += env * torch.sum(
                torch.sin(arg + ph[:, None]) / h, dim=0)
            right[i0:i1] += env * torch.sum(
                torch.sin(arg * 1.002 + ph[:, None]) / h, dim=0)
    return _stereo(left, right, peak)


GENERATORS = {"music": music, "speech": speech, "chords": chords}
ORIGINAL_SEEDS = {"music": 1234, "speech": 77, "chords": 4242}


def to_int16(x: torch.Tensor) -> np.ndarray:
    """Float samples in [-1, 1] as 16-bit PCM."""
    return torch.clamp(torch.round(x * 32767.0), -32768, 32767) \
        .to(torch.int16).cpu().numpy()

